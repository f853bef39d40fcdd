"""Silicon sensor physics: conversion depth, diffusion, tree rings,
brighter-fatter (imsim_tpu/sensor/silicon.py counterpart, `bf_mode=
'image'` with the depth/diffusion displacement fused into the photon
chain).

Brighter-fatter: the displacement field (dx, dy) is the correlation of
the accumulated charge with the central-difference gradient of the
interaction kernel (K3, ops/stencil.py); each chunk's newly binned
charge then moves by the continuity update -div(Q d), with the static
tree-ring field folded into d.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ..photons.batch import PhotonBatch
from ..utils.lookup import clenshaw_const
from .simple import accumulate

# log10(l_abs/um) piecewise-linear fit to published Si data (Green 2008)
_ABS_WAVE = np.array([250, 300, 350, 400, 450, 500, 550, 600, 650, 700,
                      750, 800, 850, 900, 950, 1000, 1050, 1100], float)
_ABS_LEN_UM = np.array([0.006, 0.006, 0.01, 0.1, 0.4, 0.9, 1.7, 2.9, 4.5,
                        6.9, 10.5, 15.0, 23.0, 37.0, 62.0, 120.0, 400.0,
                        2000.0], float)


@lru_cache(maxsize=1)
def absorption_cheb() -> np.ndarray:
    """Chebyshev fit (degree 28, float32) of log10 l_abs over
    [430, 1100] nm — the same host fit as imsim_tpu's
    absorption_length_poly."""
    w = np.linspace(430.0, 1100.0, 512)
    y = np.interp(w, _ABS_WAVE, np.log10(_ABS_LEN_UM))
    x = 2.0 * (w - 430.0) / 670.0 - 1.0
    return np.polynomial.chebyshev.chebfit(x, y, 28).astype(np.float32)


def absorption_length_poly(wavelength_nm: torch.Tensor) -> torch.Tensor:
    """Silicon absorption length [um] at the photon wavelength."""
    x = torch.clamp(2.0 * (wavelength_nm - 430.0) / 670.0 - 1.0, -1.0, 1.0)
    return 10.0 ** clenshaw_const(absorption_cheb(), x)


@dataclasses.dataclass(frozen=True)
class SiliconParams:
    thickness_um: float
    pixel_um: float
    diffusion_um: float          # sigma at full drift
    bf_kernel: np.ndarray        # (2R+1, 2R+1) per-electron BF kernel,
                                 #   float32 on the host (K3's taps)
    treering_center: tuple       # (cx, cy) pixels
    tr_waves: np.ndarray | None  # (nfreq, 3): (2 pi/period, phase, amp)
    tr_env: np.ndarray | None    # (3,): (a, b, norm)
    tr_active: bool


def depth_diffusion_displace(u, g1, g2, x, y, dxdz, dydz, flux, labs,
                             thickness_um, pixel_um, diffusion_um):
    """Per-photon conversion depth z = -labs ln(u) (photons deeper than
    the device are lost), lateral travel along the slopes over z, and
    Gaussian diffusion over the remaining drift.  Returns (x, y, flux)."""
    z = -labs * torch.log(u)
    alive = z < thickness_um
    flux = torch.where(alive, flux, 0.0)
    z = torch.clamp(z, max=thickness_um)
    x = x + dxdz * z / pixel_um
    y = y + dydz * z / pixel_um
    drift = torch.clamp(thickness_um - z, min=0.0)
    sigma = diffusion_um * torch.sqrt(drift / thickness_um) / pixel_um
    return x + sigma * g1, y + sigma * g2, flux


def _treering_dr(r: torch.Tensor, params: SiliconParams) -> torch.Tensor:
    a_env, b_env, norm = (float(v) for v in params.tr_env)
    wave = torch.zeros_like(r)
    for w, ph, amp in params.tr_waves.tolist():
        wave = wave + amp * torch.sin(w * r + ph)
    r2 = r * r
    return norm * wave * (a_env + b_env * (r2 * r2))


def tree_ring_step(params: SiliconParams) -> int:
    """Coarse-grid stride for tree_ring_field: >= 16 samples per
    shortest sinusoid period, at most 8."""
    if params.tr_waves is None or not params.tr_waves.shape[0]:
        return 1
    min_period = float(2.0 * np.pi / np.max(params.tr_waves[:, 0]))
    return max(1, min(8, int(min_period / 16.0)))


def tree_ring_field(params: SiliconParams, shape, device, step=None):
    """Static tree-ring displacement field (dx, dy) at pixel centres,
    evaluated on a coarse grid of the given stride and bilinearly
    upsampled (stride 1 = direct evaluation)."""
    if step is None:
        step = tree_ring_step(params)
    H, W = shape
    cx, cy = params.treering_center
    f32 = dict(dtype=torch.float32, device=device)
    if step <= 1:
        rx = torch.arange(W, **f32)[None, :] - cx
        ry = torch.arange(H, **f32)[:, None] - cy
        r = torch.clamp(torch.sqrt(rx * rx + ry * ry), min=1e-6)
        dr = _treering_dr(r, params)
        return dr * rx / r, dr * ry / r
    gh = (H - 1) // step + 2
    gw = (W - 1) // step + 2
    rx = torch.arange(gw, **f32)[None, :] * step - cx
    ry = torch.arange(gh, **f32)[:, None] * step - cy
    r = torch.clamp(torch.sqrt(rx * rx + ry * ry), min=1e-6)
    dr = _treering_dr(r, params)
    fx = dr * rx / r
    fy = dr * ry / r

    def up(g, n, axis):
        f = torch.arange(n, **f32) / step
        i0 = torch.floor(f).to(torch.int64)
        w = f - i0
        g0 = torch.index_select(g, axis, i0)
        g1 = torch.index_select(g, axis, i0 + 1)
        wshape = [1, 1]
        wshape[axis] = n
        w = w.reshape(wshape)
        return g0 * (1.0 - w) + g1 * w

    return up(up(fx, W, 1), H, 0), up(up(fy, W, 1), H, 0)


def bf_taps(params: SiliconParams):
    """(dKx, dKy): central differences of the BF kernel along x and y
    (zero outside it), the two k x k tap sets of the displacement
    stencil, as float32 CPU tensors.  K3 takes its taps by value, so
    they are built on the host: the render never waits for a copy
    back."""
    Kp = np.pad(params.bf_kernel, 1)
    half = np.float32(0.5)
    return (torch.from_numpy(half * (Kp[1:-1, 2:] - Kp[1:-1, :-2])),
            torch.from_numpy(half * (Kp[2:, 1:-1] - Kp[:-2, 1:-1])))


def displacement_field(image: torch.Tensor, params: SiliconParams):
    """BF displacement field from the accumulated charge (K3)."""
    from ..ops.stencil import stencil_pair

    return stencil_pair(image, *bf_taps(params))


def bf_redistribute(chunk_img, dx, dy):
    """First-order continuity update: newly collected charge Q moving
    by d changes the pixel density by -div(Q d) (central differences,
    periodic, so charge is conserved exactly)."""
    fx = chunk_img * dx
    fy = chunk_img * dy
    div = (0.5 * (torch.roll(fx, -1, 1) - torch.roll(fx, 1, 1))
           + 0.5 * (torch.roll(fy, -1, 0) - torch.roll(fy, 1, 0)))
    return chunk_img - div


def accumulate_silicon(photons: PhotonBatch, image: torch.Tensor,
                       params: SiliconParams, nsub: int = 4,
                       tr_field=None, tally: dict | None = None):
    """Accumulate a pooled batch in `nsub` chunks, recomputing the BF
    displacement field before each (the nrecalc cadence).  Each chunk is
    binned, then moved by the BF (+ folded tree-ring) continuity update.
    The photons already carry their depth/diffusion displacement
    (shoot_full with `silicon`, the reference's pre_displaced=True);
    the per-chunk displacement stage and bf_mode='photon' are not
    ported.  Photons past nsub * (n // nsub) are not accumulated, as in
    the reference."""
    chunk = photons.n // nsub
    for i in range(nsub):
        dx, dy = displacement_field(image, params)
        ph = photons.slice(i * chunk, (i + 1) * chunk)
        chunk_img = accumulate(ph, torch.zeros_like(image), tally)
        if tr_field is not None:
            dx = dx + tr_field[0]
            dy = dy + tr_field[1]
        image = image + bf_redistribute(chunk_img, dx, dy)
    return image
