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

# Rubin's effective collecting area [cm^2] (catalog/instcat.RUBIN_AREA)
_RUBIN_AREA = np.pi * (418.0**2 - 255.0**2)

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

    raw = _hardware_bandpass_uncal(band)
    atm = atmosphere_transmission(raw.wave, 1.2)
    zp = Bandpass(raw.wave, raw.throughput * atm,
                  band).with_zeropoint_ab().zeropoint
    zp_full = zp + 2.5 * np.log10(_RUBIN_AREA)
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
