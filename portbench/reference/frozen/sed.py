"""SEDs: load, normalize, redshift, extinguish (copy of
imsim_tpu/catalog/sed.py; host numpy).

phoSim SED files (two columns, wavelength [nm] and f_lambda, optionally
gzipped), normalized so magnorm = 0 is AB mag 0 at 500 nm; internal dust
in the rest frame, the redshift, then Milky Way dust with the CCM89 /
O'Donnell curve.
"""
from __future__ import annotations

import gzip
import os
from functools import lru_cache

import numpy as np

# AB mag 0 at 500 nm in photons / s / cm^2 / nm:
#   f_nu = 3630.78 Jy -> f_phot = f_nu / (h * lambda)
_H_ERG_S = 6.62607015e-27
_AB_FNU = 3.63078e-20  # erg/s/cm^2/Hz
MAGNORM_FLUX_DENSITY = _AB_FNU / (_H_ERG_S * 500e-7) * 1e-7  # ph/s/cm^2/nm


def load_sed_file(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Two columns, wavelength [nm] and f_lambda (arbitrary scale); '#'
    comments; optionally gzipped."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = np.loadtxt(f)
    return data[:, 0], data[:, 1]


def ccm89_extinction(wave_nm, a_v, r_v=3.1):
    """Cardelli, Clayton & Mathis (1989) A_lambda/A_V with O'Donnell
    (1994) optical coefficients; returns the flux attenuation factor
    10^(-0.4 * A_lambda).  Valid 303 nm - 3.3 um.  The curve's a and b
    depend on the wavelengths only and are kept per grid (_ccm89_ab):
    the same numbers as computing them anew."""
    wave = np.ascontiguousarray(wave_nm, float)
    a, b = _ccm89_ab(wave.tobytes())
    return extinction_factor(a, b, a_v, r_v)


def extinction_factor(a, b, a_v, r_v):
    """10^(-0.4 A_lambda) from the curve's a(x), b(x), element by
    element (a_v, r_v broadcast)."""
    a_lam = a_v * (a + b / r_v)
    return 10.0 ** (-0.4 * a_lam)


@lru_cache(maxsize=256)
def _ccm89_ab(wave_bytes: bytes):
    """ccm89_ab on a wavelength grid (float64 bytes, nm), kept."""
    return ccm89_ab(1e3 / np.frombuffer(wave_bytes, float))


def ccm89_ab(x):
    """CCM89 / O'Donnell a(x), b(x) at inverse microns x (any shape,
    element by element); each power of y is taken once and used by both
    polynomials."""
    x = np.asarray(x, float)
    a = np.empty_like(x)
    b = np.empty_like(x)

    # Infrared: 0.3 <= x < 1.1
    ir = x < 1.1
    p = x[ir] ** 1.61
    a[ir] = 0.574 * p
    b[ir] = -0.527 * p

    # Optical/NIR: 1.1 <= x < 3.3 (O'Donnell 94)
    op = (x >= 1.1) & (x < 3.3)
    y = x[op] - 1.82
    y2, y3, y4, y5, y6, y7, y8 = (y**k for k in range(2, 9))
    a[op] = (1 + 0.104 * y - 0.609 * y2 + 0.701 * y3 + 1.137 * y4
             - 1.718 * y5 - 0.827 * y6 + 1.647 * y7 - 0.505 * y8)
    b[op] = (1.952 * y + 2.908 * y2 - 3.989 * y3 - 7.985 * y4
             + 11.102 * y5 + 5.491 * y6 - 10.805 * y7 + 3.347 * y8)

    # UV: 3.3 <= x < 8
    uv = x >= 3.3
    xu = np.minimum(x[uv], 8.0)
    fa = np.where(xu >= 5.9,
                  -0.04473 * (xu - 5.9) ** 2 - 0.009779 * (xu - 5.9) ** 3, 0.0)
    fb = np.where(xu >= 5.9,
                  0.2130 * (xu - 5.9) ** 2 + 0.1207 * (xu - 5.9) ** 3, 0.0)
    a[uv] = 1.752 - 0.316 * xu - 0.104 / ((xu - 4.67) ** 2 + 0.341) + fa
    b[uv] = -3.090 + 1.825 * xu + 1.206 / ((xu - 4.62) ** 2 + 0.263) + fb
    return a, b


class SED:
    """Tabulated SED in photons/s/cm^2/nm at observer-frame wavelengths."""

    __slots__ = ("wave", "fphot")

    def __init__(self, wave_nm, fphot):
        self.wave = np.asarray(wave_nm, float)
        self.fphot = np.asarray(fphot, float)

    @classmethod
    def from_flambda(cls, wave_nm, flambda):
        """f_lambda [arbitrary scale] -> photon density (photons
        proportional to f_lambda * lambda)."""
        wave_nm = np.asarray(wave_nm, float)
        return cls(wave_nm, np.asarray(flambda, float) * wave_nm)

    def normalized_magnorm0(self) -> "SED":
        """Scaled so the photon density at 500 nm equals the AB-mag-0
        value."""
        f500 = np.interp(500.0, self.wave, self.fphot)
        if f500 <= 0:
            raise ValueError("SED has no flux at 500 nm; cannot normalize")
        return SED(self.wave, self.fphot * (MAGNORM_FLUX_DENSITY / f500))

    def at_redshift(self, z: float) -> "SED":
        """Shift to the observer frame; the photon density dilutes by
        1/(1+z)."""
        return SED(self.wave * (1.0 + z), self.fphot / (1.0 + z))

    def extinguished(self, a_v: float, r_v: float = 3.1) -> "SED":
        if a_v == 0.0:
            return self
        return SED(self.wave, self.fphot * ccm89_extinction(self.wave, a_v, r_v))

    def resample(self, grid_nm: np.ndarray) -> np.ndarray:
        return np.interp(grid_nm, self.wave, self.fphot, left=0.0, right=0.0)


@lru_cache(maxsize=512)
def _cached_raw_sed(path: str) -> SED:
    w, f = load_sed_file(path)
    return SED.from_flambda(w, f).normalized_magnorm0()


def find_sed_file(sed_name: str, sed_dirs) -> str:
    """The first of sed_dirs that holds sed_name (OSError if none)."""
    for d in sed_dirs:
        full = os.path.join(d, sed_name)
        if os.path.isfile(full):
            return full
    raise OSError(f"SED file {sed_name} not found in {tuple(sed_dirs)}")


def build_object_sed(sed_name: str, redshift: float, mw_av: float,
                     mw_rv: float, sed_dirs: tuple[str, ...],
                     int_av: float = 0.0, int_rv: float = 3.1) -> SED:
    """One object's SED: the raw file (cached), internal dust in the rest
    frame, the redshift, Milky Way dust, in that order."""
    sed = _cached_raw_sed(find_sed_file(sed_name, sed_dirs))
    sed = sed.extinguished(int_av, int_rv)   # rest frame
    sed = sed.at_redshift(redshift)
    sed = sed.extinguished(mw_av, mw_rv)     # observer frame
    return sed
