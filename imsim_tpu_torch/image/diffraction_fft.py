"""Diffraction-spike overlay for saturated FFT-rendered stars
(imsim_tpu/image/diffraction_fft.py counterpart).

The spike kernel (a central delta plus four Lorentzian-profile arms,
rotated to the spider angle and smeared over the field rotation) is
built on the host in numpy, with its flux fraction and profile
calibrated against the port's own photon-shot spider kicks.  The
overlay convolves the saturation excess of an image with it by one
zero-padded rfft2 / irfft2 pair on the image's device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def calibrate_spike_profile(wavelength_nm: float = 622.0,
                            pixel_scale: float = 0.2,
                            n_phot: int = 1 << 21, seed: int = 0,
                            r_min_px: float = 2.0, device="cuda"):
    """Calibrate the spike kernel against the photon-shot spikes: shoot
    n_phot photons over the pupil annulus through the statistical spider
    model (photons.diffraction.apply_diffraction, no field rotation) on
    `device`, histogram |kick| along the arms and fit the Lorentzian tail
    A / (1 + (r/s)^2)^p.  Returns dict(fraction = P(|kick| > r_min_px),
    r_scale_px = s, power = p)."""
    from ..photons.diffraction import apply_diffraction
    from ..utils.rng import stream

    gen = stream(seed, "spike_calibration", device=device)
    dev = gen.device
    u1 = torch.rand(n_phot, generator=gen, device=dev)
    u2 = torch.rand(n_phot, generator=gen, device=dev)
    normal = torch.randn(n_phot, generator=gen, device=dev)
    r = torch.sqrt(0.612**2 * 4.18**2 + u1 * (1 - 0.612**2) * 4.18**2)
    a = u2 * 2 * np.pi
    z = torch.zeros(n_phot, device=dev)
    du, dv = apply_diffraction(r * torch.cos(a), r * torch.sin(a), z, z,
                               torch.full((n_phot,), float(wavelength_nm),
                                          device=dev), normal,
                               enable_field_rotation=False)
    arcsec = np.pi / 180 / 3600
    kick_px = torch.hypot(du, dv).cpu().numpy() / arcsec / pixel_scale
    fraction = float((kick_px > r_min_px).mean())
    # tail histogram in log-spaced radial bins, per unit radius (spikes
    # are 1-D structures)
    edges = np.geomspace(r_min_px, 500.0, 40)
    hist, _ = np.histogram(kick_px, bins=edges)
    centers = np.sqrt(edges[:-1] * edges[1:])
    dens = hist / np.diff(edges)
    good = dens > 0
    best = None
    for s in np.geomspace(0.5, 30.0, 40):
        X = np.log1p((centers[good] / s) ** 2)
        A = np.vstack([np.ones_like(X), -X]).T
        b = np.log(dens[good])
        coef, _, _, _ = np.linalg.lstsq(A, b, rcond=None)
        # explicit residual: lstsq returns an empty one for <= 2 bins
        r2 = float(np.sum((A @ coef - b) ** 2)) if len(b) > 2 else np.inf
        if best is None or r2 < best[0]:
            best = (r2, s, coef[1])
    return dict(fraction=fraction, r_scale_px=float(best[1]),
                power=float(best[2]))


@functools.lru_cache(maxsize=16)
def spike_kernel(wavelength_nm: float = 622.0, pixel_scale: float = 0.2,
                 alpha_deg: float = 45.0, rot_smear_deg: float = 0.5,
                 n: int = 513, spike_flux_fraction: float = None,
                 profile_power: float = None, r_scale_px: float = None,
                 rot_thetas_deg: tuple = None, device="cuda"):
    """(n, n) float32 numpy kernel: central delta (1 - f) + 4 spikes
    carrying f (copy of imsim_tpu.image.diffraction_fft.spike_kernel).

    rot_thetas_deg: signed field-rotation angles sampled uniformly in
    exposure time (the arms sweep alpha - theta); else rot_smear_deg, a
    symmetric smear about alpha.  The flux fraction, radial scale and
    power default to calibrate_spike_profile on `device`."""
    if spike_flux_fraction is None or profile_power is None \
            or r_scale_px is None:
        cal = calibrate_spike_profile(wavelength_nm, pixel_scale,
                                      device=device)
        if spike_flux_fraction is None:
            spike_flux_fraction = cal["fraction"]
        if profile_power is None:
            profile_power = cal["power"]
        if r_scale_px is None:
            r_scale_px = cal["r_scale_px"]
    c = n // 2
    yy, xx = np.mgrid[-c:c + 1, -c:c + 1]
    kern = np.zeros((n, n))
    if rot_thetas_deg is not None:
        rots = [-float(th) for th in rot_thetas_deg]
    else:
        n_rot = max(int(rot_smear_deg / 0.1), 1)
        rots = np.linspace(-rot_smear_deg / 2, rot_smear_deg / 2, n_rot)
    for drot in rots:
        for ang in np.radians(alpha_deg + drot) + np.arange(4) * np.pi / 2:
            ca, sa = np.cos(ang), np.sin(ang)
            along = xx * ca + yy * sa
            perp = xx * -sa + yy * ca
            on_spike = (along > 0.5)
            prof = 1.0 / (1.0 + (along / r_scale_px) ** 2) \
                ** profile_power
            width = 1.0 + 0.02 * np.abs(along)      # slight flare
            lateral = np.exp(-0.5 * (perp / width) ** 2)
            kern += np.where(on_spike, prof * lateral, 0.0)
    kern /= kern.sum()
    kern *= spike_flux_fraction
    kern[c, c] += 1.0 - spike_flux_fraction
    return kern.astype(np.float32)


def apply_spikes(image: torch.Tensor, kernel, sat_level: float):
    """Redistribute the charge of saturated pixels through the spike
    kernel: excess = max(I - sat, 0) is convolved, the rest stays.
    Charge is conserved up to what the kernel throws past the edges.
    image may carry leading batch dims (..., H, W): the FFT pair runs
    over the last two axes, zero-padded to (H + kH, W + kW), so a stamp
    bucket is one call."""
    kernel = torch.as_tensor(kernel, dtype=torch.float32,
                             device=image.device)
    excess = torch.clamp(image - sat_level, min=0.0)
    base = image - excess
    H, W = image.shape[-2:]
    kH, kW = kernel.shape
    PH, PW = H + kH, W + kW
    F_img = torch.fft.rfft2(excess, s=(PH, PW), dim=(-2, -1))
    F_k = torch.fft.rfft2(kernel, s=(PH, PW))
    conv = torch.fft.irfft2(F_img * F_k, s=(PH, PW), dim=(-2, -1))
    y0, x0 = kH // 2, kW // 2
    return base + conv[..., y0:y0 + H, x0:x0 + W]
