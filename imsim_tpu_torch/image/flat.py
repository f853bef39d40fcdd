"""Flat fields (imsim_tpu/image/flat.py counterpart, the LSST_Flat image
type of the runner).

A flat builds up in iterations of at most `counts_per_iter` electrons
per pixel, so the brighter-fatter feedback follows the charge:

  * `build_flat`: per iteration, the K3 displacement field of the
    charge so far gives each pixel's area factor 1 - div(d), and the
    counts are Gaussian about lam x area (lam >> 30);
  * `build_flat_photons`: uniform photons with wavelengths from the
    illumination's inverse CDF through the whole silicon model
    (`accumulate_silicon` with the per-chunk displacement), in
    sub-batches of at most 16,777,216 photons, with the static tree-ring
    field folded in.

The whole CCD is one device array.  With a `checkpointer`
(io.checkpoint), the image and the next iteration are saved every 10
iterations (host numpy) and a saved state resumes there.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..photons.batch import PhotonBatch
from ..sensor.silicon import (SiliconParams, accumulate_silicon,
                              displacement_field, tree_ring_field)
from ..utils import rng, trace
from ..utils.rng import stream
from .render import _interp_weights

# photons per sub-batch of build_flat_photons (device memory per step)
PHOTON_CAP = 16_777_216


@dataclasses.dataclass
class FlatConfig:
    counts_per_pixel: float = 80_000.0
    counts_per_iter: float = 1000.0     # BF recalc cadence
    xsize: int = 4096
    ysize: int = 4004
    exptime: float = 30.0


def _flat_iteration(gen, image: torch.Tensor, lam: float,
                    params: SiliconParams, noise=None) -> torch.Tensor:
    """One iteration: pixel areas from the current BF displacement field,
    then Gaussian counts lam x area + sqrt(lam x area) N(0, 1), clipped
    at 0.  noise: the (H, W) normal draws (default: drawn from gen)."""
    dx, dy = displacement_field(image, params)
    # charge arriving at x lands at x + d(x): the landed density scales
    # by ~ 1 - div(d), so charge-rich pixels collect less
    ddx = 0.5 * (torch.roll(dx, -1, 1) - torch.roll(dx, 1, 1))
    ddy = 0.5 * (torch.roll(dy, -1, 0) - torch.roll(dy, 1, 0))
    area = torch.clamp(1.0 - ddx - ddy, 0.2, 5.0)
    mean = lam * area
    if noise is None:
        noise = torch.randn(image.shape, generator=gen, device=image.device,
                            dtype=torch.float32)
    return image + torch.clamp(mean + torch.sqrt(mean) * noise, min=0.0)


def n_iterations(cfg: FlatConfig) -> int:
    """Iterations of at most counts_per_iter to reach counts_per_pixel."""
    return int(np.ceil(cfg.counts_per_pixel / cfg.counts_per_iter))


def _resume(checkpointer, key, shape, device):
    """(image, first iteration) from a checkpoint, or a zero image."""
    saved = None if checkpointer is None else checkpointer.load(key)
    if saved is None:
        return torch.zeros(shape, dtype=torch.float32, device=device), 0
    return torch.as_tensor(saved["image"], device=device), saved["next_iter"]


def build_flat(seed: int, cfg: FlatConfig,
               params: SiliconParams | None = None,
               device="cuda", checkpointer=None) -> torch.Tensor:
    """Full-CCD flat with BF-driven pixel-area evolution: (ysize, xsize)
    float32 electrons on `device`."""
    params = params or SiliconParams.make()
    image, start = _resume(checkpointer, "flat", (cfg.ysize, cfg.xsize),
                           device)
    n_iter = n_iterations(cfg)
    lam = float(np.float32(cfg.counts_per_pixel / n_iter))
    for k in range(start, n_iter):
        image = _flat_iteration(stream(seed, "flat", k, device=device),
                                image, lam, params)
        if checkpointer is not None and (k + 1) % 10 == 0:
            checkpointer.save("flat", dict(image=image.cpu().numpy(),
                                           next_iter=k + 1))
    return image


def _wavelengths(wl_row: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of the (K,) inverse CDF at u."""
    j, w = _interp_weights(wl_row.shape[0], u)
    return wl_row[j] * (1 - w) + wl_row[j + 1] * w


def _flat_photon_iteration(gen, image: torch.Tensor, wl_row: torch.Tensor,
                           params: SiliconParams, n_phot: int,
                           nsub: int = 1, tr_field=None) -> torch.Tensor:
    """One sub-batch: n_phot photons uniform over the frame with
    wavelengths from wl_row, through accumulate_silicon with the
    per-chunk displacement (depth, diffusion, BF, the folded tree-ring
    field).  Draws, in order: x, y, the wavelength uniform, then the
    silicon's per chunk.  Spans `flat.draw` and `flat.sensor`, counter
    `flat.photons`."""
    H, W = image.shape
    with trace.span("flat.draw", device=image.device):
        x = rng.uniform(gen, n_phot, -0.5, W - 0.5)
        y = rng.uniform(gen, n_phot, -0.5, H - 0.5)
        wl = _wavelengths(wl_row, rng.uniform(gen, n_phot))
        z = torch.zeros_like(x)
        ph = PhotonBatch(x=x, y=y, flux=torch.ones_like(x), wavelength=wl,
                         dxdz=z, dydz=z, pupil_u=z, pupil_v=z, time=z)
    trace.count("flat.photons", n_phot)
    with trace.span("flat.sensor", device=image.device):
        return accumulate_silicon(ph, image, params, nsub=nsub,
                                  tr_field=tr_field, gen=gen)


def photon_flat_plan(cfg: FlatConfig):
    """(iterations, sub-batches per iteration, photons per sub-batch)
    of build_flat_photons."""
    n_phot = int(cfg.counts_per_iter * cfg.xsize * cfg.ysize)
    n_sub = max(1, -(-n_phot // PHOTON_CAP))
    return n_iterations(cfg), n_sub, -(-n_phot // n_sub)


def build_flat_photons(seed: int, cfg: FlatConfig, wl_icdf,
                       params: SiliconParams | None = None,
                       device="cuda", checkpointer=None) -> torch.Tensor:
    """SED photon-shooting flat: counts_per_iter photons per pixel per
    iteration (expected, before photons lost deeper than the device),
    iterated to counts_per_pixel.  wl_icdf: (K,) inverse CDF of the
    illumination's wavelengths.  (ysize, xsize) float32 on `device`.
    A span `flat.iter` for each iteration, over its sub-batches."""
    params = params or SiliconParams.make()
    image, start = _resume(checkpointer, "flat_phot",
                           (cfg.ysize, cfg.xsize), device)
    n_iter, n_sub, per = photon_flat_plan(cfg)
    wl_row = torch.as_tensor(np.asarray(wl_icdf, np.float32), device=device)
    tr_field = None
    if params.tr_active:
        tr_field = tree_ring_field(params, (cfg.ysize, cfg.xsize), device)
    for k in range(start, n_iter):
        with trace.span("flat.iter", device=device):
            for s in range(n_sub):
                image = _flat_photon_iteration(
                    stream(seed, "flatphot", k * n_sub + s, device=device),
                    image, wl_row, params, per, tr_field=tr_field)
        if checkpointer is not None and (k + 1) % 10 == 0:
            checkpointer.save("flat_phot", dict(image=image.cpu().numpy(),
                                                next_iter=k + 1))
    return image


def flat_statistics(image) -> dict:
    """Mean and variance away from the 8-pixel border (where the
    divergence stencil wraps): var / mean below 1 is the BF signature."""
    a = torch.as_tensor(image)[8:-8, 8:-8].to(torch.float64)
    mean = float(a.mean())
    var = float(a.var(unbiased=False))
    return dict(mean=mean, var=var, var_over_mean=var / mean)
