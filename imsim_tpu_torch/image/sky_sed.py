"""Loadable sky spectra (copy of imsim_tpu/image/sky_sed.py; host numpy).

A sky spectrum is a 2-column text file ``wavelength_nm flambda`` (one
dark-sky zenith spectrum [erg/s/cm^2/nm/arcsec^2]), an ``.npz`` with
``wave`` and any of the component spectra ``airglow``, ``zodiacal``,
``moonlight``, ``twilight``, ``merged``, or the DC2-production pickle.
It feeds `photon_rate` (photons/s/cm^2/arcsec^2 through a bandpass) and
`etalon_visibility` (the fringe contrast of the spectrum through the
sensor's epitaxial etalon), which scales the y-band fringing amplitude.
The component library the JAX package ships is copied to
`imsim_tpu_torch/data/sky_library.npz`.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

_HC_ERG_NM = 6.62607015e-27 * 2.99792458e10 * 1e7  # h*c in erg*nm

COMPONENTS = ("airglow", "zodiacal", "moonlight", "twilight", "merged")


@dataclasses.dataclass(frozen=True)
class SkySED:
    """wave_nm (N,) and per-component flambda [erg/s/cm^2/nm/arcsec^2];
    a plain 2-column file loads as the single component 'merged'."""

    wave_nm: np.ndarray
    components: dict

    @property
    def merged(self):
        if "merged" in self.components:
            return self.components["merged"]
        return np.sum(list(self.components.values()), axis=0)


def default_library_path() -> str:
    """The component library (synthesized airglow, zodiacal, moonlight
    and twilight templates whose band integrals reproduce the analytic
    dark-sky rates; the OH line forest carries the y fringing
    contrast)."""
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "sky_library.npz")


def load_sky_sed(path: str) -> SkySED:
    if str(path) == "default":
        path = default_library_path()
    if str(path).endswith(".pkl"):
        # the DC2-production sky spectrum snapshot: a pickled
        # (wave_nm[n], flambda[1, n]) tuple
        import pickle

        with open(path, "rb") as f:
            wave, flam = pickle.load(f)
        wave = np.asarray(wave, float)
        flam = np.asarray(flam, float).reshape(-1, wave.size)
        return SkySED(wave, {"merged": flam.sum(axis=0)})
    if str(path).endswith(".npz"):
        with np.load(path) as z:
            wave = np.asarray(z["wave"], float)
            comps = {k: np.asarray(z[k], float) for k in COMPONENTS
                     if k in z}
        if not comps:
            raise ValueError(f"{path}: no sky components among "
                             f"{COMPONENTS}")
        return SkySED(wave, comps)
    rows = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.replace(",", " ").split()
            if len(parts) >= 2:
                try:
                    rows.append((float(parts[0]), float(parts[1])))
                except ValueError:
                    continue  # header line
    arr = np.asarray(rows, float)
    order = np.argsort(arr[:, 0])
    return SkySED(arr[order, 0], {"merged": arr[order, 1]})


def photon_rate(wave_nm, flambda, bandpass) -> float:
    """photons/s/cm^2/arcsec^2 of a flambda spectrum through a
    catalog.bandpass.Bandpass."""
    T = bandpass(wave_nm)
    fphot = np.asarray(flambda, float) * wave_nm / _HC_ERG_NM
    return float(np.trapezoid(fphot * T, wave_nm))


def etalon_visibility(wave_nm, flambda, bandpass,
                      thickness_um: float = 40.0,
                      n_si: float = 3.55) -> float:
    """Fringe contrast V = |int p(l) exp(i 4 pi n t / l) dl| / int p dl
    of the photon spectrum p through the sensor's thin-film etalon (the
    effective interfering epitaxial layer, not the full device)."""
    T = bandpass(wave_nm)
    p = np.asarray(flambda, float) * wave_nm * T
    tot = np.trapezoid(p, wave_nm)
    if tot <= 0:
        return 0.0
    phase = 4.0 * np.pi * n_si * (thickness_um * 1e3) / wave_nm
    c = np.trapezoid(p * np.exp(1j * phase), wave_nm)
    return float(np.abs(c) / tot)


# OH Meinel band heads (nm, vacuum) of the Delta-v = 2, 3 sequences in
# 900-1100 nm, each expanded into a short rotational ladder: the synthetic
# y sky that anchors the default fringing amplitude (0.2%)
_OH_BANDS = [(9, 7, 908.0), (4, 1, 916.0), (8, 6, 958.0), (5, 2, 1029.0),
             (9, 8, 1042.0), (6, 3, 1080.0)]


def synthetic_y_sky(n: int = 4096):
    """(wave_nm, flambda) synthetic dark y-band sky: OH line forest on a
    flat continuum, line/continuum split ~85/15."""
    w = np.linspace(880.0, 1120.0, n)
    f = np.full(n, 1.0)
    rng = np.random.default_rng(20260817)
    for (vu, vl, head) in _OH_BANDS:
        # P/Q/R rotational ladder redward of the head, ~1.5 nm spacing
        for j in range(14):
            line = head + 1.55 * j + 0.3 * rng.standard_normal()
            amp = 60.0 * np.exp(-j / 5.0) * (0.7 + 0.6 * rng.random())
            f += amp * np.exp(-0.5 * ((w - line) / 0.12) ** 2)
    return w, f


_VREF_CACHE: dict = {}


def fringing_amplitude(sky_sed: SkySED | None, bandpass,
                       base_amplitude: float = 0.002,
                       thickness_um: float = 40.0) -> float:
    """Fringing amplitude for CCD_Fringing: base_amplitude anchored to
    the synthetic OH reference spectrum, scaled by the loaded spectrum's
    etalon visibility.  None -> base_amplitude."""
    if sky_sed is None:
        return base_amplitude
    key = (id(bandpass), thickness_um)
    vref = _VREF_CACHE.get(key)
    if vref is None:
        wr, fr = synthetic_y_sky()
        vref = etalon_visibility(wr, fr, bandpass, thickness_um)
        _VREF_CACHE[key] = vref
    v = etalon_visibility(sky_sed.wave_nm, sky_sed.merged, bandpass,
                          thickness_um)
    return base_amplitude * v / max(vref, 1e-12)
