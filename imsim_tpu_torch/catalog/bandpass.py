"""Rubin bandpasses: hardware x atmosphere throughput, AB zeropoints,
airmass interpolation, per-detector QE (copy of
imsim_tpu/catalog/bandpass.py; host numpy).

The analytic throughput model (published band edges with erf edge
profiles, a CCD QE curve, mirror and lens reflectivities, an atmosphere
with Rayleigh, aerosol, ozone and water terms scaled by airmass) is
anchored to the published system zeropoints; measured rubin_sim
throughput files load through `rubin_bandpass_from_files`.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

# Published LSST band edges (half-max points, nm)
BAND_EDGES = {
    "u": (324.0, 395.0),
    "g": (405.0, 552.0),
    "r": (552.0, 691.0),
    "i": (691.0, 818.0),
    "z": (818.0, 921.0),
    "y": (922.0, 1060.0),
}
_EDGE_WIDTH = {"u": 8.0, "g": 6.0, "r": 6.0, "i": 6.0, "z": 6.0, "y": 10.0}

WAVE_MIN, WAVE_MAX, WAVE_STEP = 300.0, 1150.0, 0.5


def std_wave_grid():
    return np.arange(WAVE_MIN, WAVE_MAX + WAVE_STEP / 2, WAVE_STEP)


def _erf_edge(w, lo, hi, width):
    from scipy.special import erf
    return 0.25 * (1 + erf((w - lo) / width)) * (1 + erf((hi - w) / width))


def _ccd_qe(w):
    """Deep-depletion silicon CCD QE curve (fraction)."""
    rise = 0.5 * (1 + np.tanh((w - 340.0) / 25.0))
    # red cutoff from silicon absorption depth vs 100um thickness
    fall = 0.5 * (1 - np.tanh((w - 1010.0) / 35.0))
    ripple = 1.0 - 0.06 * np.exp(-0.5 * ((w - 450) / 60.0) ** 2)
    return 0.92 * rise * fall * ripple


def _mirrors_lenses(w):
    """Three protected-Al-ish mirrors + three fused-silica lenses."""
    refl = 0.88 + 0.04 * np.exp(-0.5 * ((w - 700) / 250.0) ** 2) \
        - 0.08 * np.exp(-0.5 * ((w - 360) / 40.0) ** 2)
    lens = 0.985 - 0.02 * np.exp(-0.5 * ((w - 320) / 30.0) ** 2)
    return refl**3 * lens**6


def atmosphere_transmission(w, airmass):
    """Analytic atmospheric transmission at airmass X: Rayleigh + aerosol
    + ozone Chappuis band + red water/O2 features (coarse)."""
    x = np.asarray(w, float) / 1000.0  # microns
    tau_ray = 0.00864 * x ** (-3.916 - 0.074 * x - 0.05 / x) * np.exp(-2.663 / 8.0)
    tau_aer = 0.03 * x ** (-1.3)
    tau_o3 = 0.032 * np.exp(-0.5 * ((w - 600.0) / 80.0) ** 2)
    # crude H2O/O2 bands in the red
    tau_h2o = (0.08 * np.exp(-0.5 * ((w - 940.0) / 18.0) ** 2)
               + 0.04 * np.exp(-0.5 * ((w - 822.0) / 8.0) ** 2)
               + 0.03 * np.exp(-0.5 * ((w - 762.0) / 5.0) ** 2))
    tau = tau_ray + tau_aer + tau_o3
    # water bands saturate: scale ~ sqrt(X)
    return np.exp(-airmass * tau) * np.exp(-np.sqrt(airmass) * tau_h2o)


@dataclass
class Bandpass:
    """Tabulated throughput on a uniform wavelength grid [nm]."""

    wave: np.ndarray
    throughput: np.ndarray
    band: str = "?"
    zeropoint: float = field(default=0.0)  # AB mag giving 1 photon/s/cm^2

    def __mul__(self, other):
        if isinstance(other, Bandpass):
            assert np.allclose(self.wave, other.wave)
            return Bandpass(self.wave, self.throughput * other.throughput,
                            self.band)
        return Bandpass(self.wave, self.throughput * other, self.band)

    def __call__(self, w):
        return np.interp(w, self.wave, self.throughput, left=0.0, right=0.0)

    def truncate(self, relative_throughput=1e-3) -> "Bandpass":
        """Trim leading/trailing wavelengths below a relative threshold."""
        tmax = self.throughput.max()
        keep = np.nonzero(self.throughput >= relative_throughput * tmax)[0]
        lo, hi = keep[0], keep[-1] + 1
        return Bandpass(self.wave[lo:hi], self.throughput[lo:hi], self.band,
                        self.zeropoint)

    def with_zeropoint_ab(self) -> "Bandpass":
        """AB zeropoint: the mag at which an AB-flat source yields 1
        photon/s/cm^2 through this bandpass."""
        from .sed import _AB_FNU, _H_ERG_S
        fphot = _AB_FNU / (_H_ERG_S * self.wave * 1e-7) * 1e-7  # ph/s/cm2/nm
        rate = np.trapezoid(fphot * self.throughput, self.wave)
        zp = 2.5 * np.log10(rate)
        return Bandpass(self.wave, self.throughput, self.band, zp)

    @property
    def effective_wavelength(self):
        num = np.trapezoid(self.wave * self.throughput, self.wave)
        den = np.trapezoid(self.throughput, self.wave)
        return num / den

    def photon_rate(self, sed_wave, sed_fphot, pupil_area, exptime):
        """Photons collected from an SED [ph/s/cm^2/nm] over the aperture."""
        f = np.interp(self.wave, sed_wave, sed_fphot, left=0.0, right=0.0)
        return np.trapezoid(f * self.throughput, self.wave) * pupil_area * exptime


# Published full-aperture AB zeropoints (1 s, airmass 1.2): the mag of an
# AB-flat source producing 1 e-/s through the complete system
SYSTEM_ZEROPOINT_AB = {"u": 26.52, "g": 28.51, "r": 28.13,
                       "i": 27.87, "z": 27.46, "y": 26.68}


@lru_cache(maxsize=8)
def _hardware_calibration(band: str) -> float:
    """Throughput scale anchoring the generated system (hardware x X=1.2
    atmosphere, full aperture) to SYSTEM_ZEROPOINT_AB."""
    from .instcat import RUBIN_AREA

    raw = _hardware_bandpass_uncal(band)
    atm = atmosphere_transmission(raw.wave, 1.2)
    zp = Bandpass(raw.wave, raw.throughput * atm,
                  band).with_zeropoint_ab().zeropoint
    zp_full = zp + 2.5 * np.log10(RUBIN_AREA)
    return 10.0 ** (-0.4 * (zp_full - SYSTEM_ZEROPOINT_AB[band]))


@lru_cache(maxsize=8)
def _hardware_bandpass_uncal(band: str) -> Bandpass:
    w = std_wave_grid()
    lo, hi = BAND_EDGES[band]
    filt = _erf_edge(w, lo, hi, _EDGE_WIDTH[band])
    t = filt * _ccd_qe(w) * _mirrors_lenses(w)
    return Bandpass(w, t, band)


@lru_cache(maxsize=32)
def hardware_bandpass(band: str) -> Bandpass:
    raw = _hardware_bandpass_uncal(band)
    return Bandpass(raw.wave,
                    raw.throughput * _hardware_calibration(band), band)


@lru_cache(maxsize=64)
def rubin_bandpass(band: str, airmass: float | None = None) -> Bandpass:
    """Total system bandpass; airmass None is the standard X = 1.2 curve."""
    X = 1.2 if airmass is None else float(airmass)
    hw = hardware_bandpass(band)
    atm = atmosphere_transmission(hw.wave, X)
    bp = Bandpass(hw.wave, hw.throughput * atm, band)
    bp = bp.truncate(1e-3).with_zeropoint_ab()
    return bp


def read_ecsv_qe(path):
    """An obs_lsst transmission_sensor ECSV table (columns amp_name,
    wavelength, efficiency [%]) without astropy, the per-amp curves
    averaged.  Returns (wave_nm, throughput)."""
    import csv

    rows = []
    header = None
    delim = ","
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                if "delimiter" in line:
                    delim = line.split(":")[-1].strip().strip("'\"") or ","
                continue
            if header is None:
                header = next(csv.reader([line], delimiter=delim))
                continue
            rows.append(next(csv.reader([line], delimiter=delim)))
    i_amp = header.index("amp_name")
    i_w = header.index("wavelength")
    i_e = header.index("efficiency")
    amps: dict = {}
    for r in rows:
        amps.setdefault(r[i_amp], []).append((float(r[i_w]),
                                              float(r[i_e])))
    waves = None
    total = None
    for vals in amps.values():
        vals.sort()
        w = np.array([v[0] for v in vals])
        e = np.array([v[1] for v in vals]) / 100.0
        if waves is None:
            waves, total = w, e
        else:
            total = total + np.interp(waves, w, e)
    return waves, total / len(amps)


def rubin_bandpass_from_files(band, throughputs_dir, airmass=None,
                              camera=None, det_name=None):
    """Total bandpass from rubin_sim throughput files:

      baseline/total_{band}.dat                (airmass None, no QE)
      atmos/atmos_XX_aerosol.dat x AtmInterpolator  (airmass given)
      baseline/hardware_{band}.dat             (generic hardware)
      {camera}/transmission_sensor/{det}/ *.ecsv x filter/mirrors/lenses
                                               (per-detector QE)
    """
    import glob as _glob

    base = os.path.join(throughputs_dir, "baseline")
    if airmass is None and camera is None:
        w, t = np.loadtxt(os.path.join(base, f"total_{band}.dat"),
                          unpack=True)
        return Bandpass(w, t, band).truncate(1e-3).with_zeropoint_ab()
    X = 1.2 if airmass is None else float(airmass)
    atmos = {}
    for f in sorted(_glob.glob(os.path.join(throughputs_dir, "atmos",
                                            "atmos_??_aerosol.dat"))):
        xval = float(os.path.basename(f)[6:8]) / 10.0
        w_atm, t_atm = np.loadtxt(f, unpack=True)
        atmos[xval] = t_atm
    Xs = sorted(atmos)
    interp = AtmInterpolator(np.array(Xs),
                             np.array([atmos[x] for x in Xs]))
    t_atm = interp(X)
    if camera is not None and det_name is not None:
        cam_dir = {"LsstCamSim": "lsstCam",
                   "LsstComCamSim": "comCamSim"}.get(camera, camera)
        qe_files = _glob.glob(os.path.join(
            throughputs_dir, cam_dir, "transmission_sensor",
            det_name.lower(), "*.ecsv"))
        if len(qe_files) != 1:
            raise ValueError(f"expected 1 QE file for {det_name}, found "
                             f"{len(qe_files)}")
        qw, qt = read_ecsv_qe(qe_files[0])
        w_hw, t_hw = np.loadtxt(os.path.join(base, f"filter_{band}.dat"),
                                unpack=True)
        for part in ("m1.dat", "m2.dat", "m3.dat", "lens1.dat",
                     "lens2.dat", "lens3.dat"):
            _, tp = np.loadtxt(os.path.join(base, part), unpack=True)
            t_hw = t_hw * tp
        t_hw = t_hw * np.interp(w_hw, qw, qt, left=0.0, right=0.0)
    else:
        w_hw, t_hw = np.loadtxt(os.path.join(base,
                                             f"hardware_{band}.dat"),
                                unpack=True)
    t_total = t_hw * np.interp(w_hw, w_atm, t_atm, left=0.0, right=0.0)
    return Bandpass(w_hw, t_total, band).truncate(1e-3).with_zeropoint_ab()


def load_bandpass_dict_pickle(path) -> dict[str, Bandpass]:
    """A pickled lsst.sims BandpassDict (such as the DC2-production
    bp_dict pickle).  Class lookups under the ``lsst`` / ``rubin_sim``
    namespaces are shimmed to plain attribute holders; only the tabulated
    (wavelen [nm], sb) arrays are read.  Returns band -> Bandpass with AB
    zeropoints."""
    import pickle

    class _Shim:
        def __init__(self, *a, **k):
            pass

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module.startswith(("lsst", "rubin_sim", "rubin")):
                return type(name, (_Shim,), {"__module__": module})
            return super().find_class(module, name)

    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    raw = getattr(obj, "_bandpassDict", None) or obj.__dict__.get(
        "_bandpassDict")
    out = {}
    for band, bp in raw.items():
        d = bp.__dict__
        out[band] = Bandpass(np.asarray(d["wavelen"], float),
                             np.asarray(d["sb"], float),
                             band).truncate(1e-3).with_zeropoint_ab()
    return out


class AtmInterpolator:
    """Log-linear interpolation of tabulated transmission against airmass
    with constant-slope extrapolation."""

    def __init__(self, Xs, arr):
        self.Xs = np.asarray(Xs, float)
        with np.errstate(all="ignore"):
            self.logarr = np.log(np.asarray(arr, float))
            self.slope = (self.logarr[-1] - self.logarr[-2]) / (
                self.Xs[-1] - self.Xs[-2])

    def __call__(self, X):
        assert X >= 1.0
        idx = np.searchsorted(self.Xs, X, side="right")
        if idx == len(self.Xs):
            out = self.logarr[-1] + (X - self.Xs[-1]) * self.slope
        else:
            frac = (X - self.Xs[idx - 1]) / (self.Xs[idx] - self.Xs[idx - 1])
            out = (1 - frac) * self.logarr[idx - 1] + frac * self.logarr[idx]
        out = np.exp(out)
        out[~np.isfinite(out)] = 0.0
        return out
