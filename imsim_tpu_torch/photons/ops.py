"""Chromatic photon operators on torch tensors
(imsim_tpu/photons/ops.py counterpart): the GalSim-equivalent
differential chromatic refraction, focus depth, silicon refraction and
bandpass reweighting ops of the reference's photon-ops chain
(config/imsim-config.yaml:281-320).  Scalars may be python floats or
tensors; array arguments are tensors.
"""
from __future__ import annotations

import numpy as np
import torch

ARCSEC = np.pi / 180.0 / 3600.0


def air_refractive_index_minus_one(wave_nm, pressure_kpa=69.328,
                                   temperature_k=293.15,
                                   h2o_pressure_kpa=1.067):
    """(n - 1) for air, the Edlen-style formula GalSim uses for DCR
    (conditions default to the LSST site)."""
    sigma_squared = 1.0 / (wave_nm * 1.0e-3) ** 2  # 1/um^2
    n_minus_one = (64.328 + (29498.1 / (146.0 - sigma_squared))
                   + (255.4 / (41.0 - sigma_squared))) * 1.0e-6
    P = pressure_kpa * 7.50061683  # kPa -> mmHg
    T = temperature_k - 273.15
    W = h2o_pressure_kpa * 7.50061683
    n_minus_one *= P * (1.0 + (1.049 - 0.0157 * T) * 1.0e-6 * P) \
        / (720.883 * (1.0 + 0.003661 * T))
    n_minus_one -= (0.0624 - 0.000680 * sigma_squared) \
        / (1.0 + 0.003661 * T) * W * 1.0e-6
    return n_minus_one


def refraction_angle(wave_nm, zenith_angle, **kw):
    """Atmospheric refraction angle R(lambda, z) ~ r0 tan(z) [rad]."""
    n = 1.0 + air_refractive_index_minus_one(wave_nm, **kw)
    r0 = (n * n - 1.0) / (2.0 * n * n)
    return r0 * torch.tan(torch.as_tensor(zenith_angle))


def photon_dcr(x, y, wave_nm, base_wavelength, zenith_angle,
               parallactic_angle, pixel_scale=0.2, flip_sign=False, **kw):
    """Shift photon pixel positions by the differential refraction between
    their wavelength and the base wavelength, along the zenith direction
    at the parallactic angle (galsim.PhotonDCR)."""
    R = refraction_angle(wave_nm, zenith_angle, **kw)
    Rbase = refraction_angle(torch.as_tensor(base_wavelength,
                                             dtype=R.dtype), zenith_angle,
                             **kw)
    shift_amount = (R - Rbase) / ARCSEC / pixel_scale  # pixels
    if flip_sign:
        shift_amount = -shift_amount
    q = torch.as_tensor(parallactic_angle, dtype=R.dtype)
    return (x + shift_amount * torch.sin(q),
            y + shift_amount * torch.cos(q))


def focus_depth(x, y, dxdz, dydz, depth_pixels):
    """Defocus: photons travel an extra depth along their slopes
    (galsim.FocusDepth)."""
    return x + dxdz * depth_pixels, y + dydz * depth_pixels


def silicon_index(wave_nm: torch.Tensor) -> torch.Tensor:
    """Refractive index of silicon over 300-1100 nm (polynomial fit)."""
    w = torch.clamp(wave_nm, 300.0, 1100.0) * 1e-3  # microns
    return 3.42 + 0.159 / w**2 + 0.0324 / w**4


def silicon_refraction(dxdz, dydz, wave_nm):
    """Refraction entering the silicon: the transverse slopes divide by
    n_Si (galsim.Refraction with index_ratio = n_si)."""
    n = silicon_index(wave_nm)
    return dxdz / n, dydz / n


def bandpass_ratio(flux, wave_nm, target_tput_table, initial_tput_table):
    """Reweight photon fluxes target / initial (the BandpassRatio photon
    op): photons drawn from one bandpass, weighted to another."""
    t = target_tput_table(wave_nm)
    i = initial_tput_table(wave_nm)
    return flux * torch.where(i > 0, t / torch.clamp(i, min=1e-12),
                              torch.zeros_like(i))
