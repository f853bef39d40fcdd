"""Silicon sensor physics: conversion depth, diffusion, tree rings,
brighter-fatter (imsim_tpu/sensor/silicon.py counterpart).

Brighter-fatter: the displacement field (dx, dy) is the correlation of
the accumulated charge with the central-difference gradient of the
interaction kernel (K3, ops/stencil.py).  In `bf_mode='image'` each
chunk's newly binned charge moves by the continuity update -div(Q d),
with the static tree-ring field folded into d; in `bf_mode='photon'`
every photon is moved by a gather of the field before it is binned.
The per-photon depth/diffusion displacement either rides in the photon
chain (the optics path fuses it into K2: `pre_displaced=True`) or runs
per chunk here (`apply_silicon_displacements`: the analytic path and
the flats).
"""
from __future__ import annotations

import dataclasses
import os
from functools import lru_cache

import numpy as np
import torch

from ..photons.batch import PhotonBatch
from ..utils import rng, trace
from ..utils.lookup import UniformTable, clenshaw_const
from .simple import accumulate, binned

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


ABS_TABLE_MIN_NM = 250.0
ABS_TABLE_MAX_NM = 1100.0


def absorption_length_table() -> UniformTable:
    """Absorption length [um] on 256 points over [250, 1100] nm (host
    numpy float32 y; copy of the JAX package's table)."""
    grid = np.linspace(ABS_TABLE_MIN_NM, ABS_TABLE_MAX_NM, 256)
    vals = 10 ** np.interp(grid, _ABS_WAVE, np.log10(_ABS_LEN_UM))
    return UniformTable(ABS_TABLE_MIN_NM, grid[1] - grid[0],
                        vals.astype(np.float32))


def default_bf_kernel(radius=4, strength=0.4) -> np.ndarray:
    """Isotropic short-range BF interaction kernel (per electron,
    float32): strength / sqrt(r^2 + 0.8^2) / 1e5 (copy of the JAX
    package's)."""
    r = np.arange(-radius, radius + 1)
    X, Y = np.meshgrid(r, r)
    rr = np.hypot(X, Y)
    K = strength / np.sqrt(rr**2 + 0.8**2)
    return (K / 1e5).astype(np.float32)


_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")


@lru_cache(maxsize=8)
def vendor_bf_kernel(vendor: str, strength: float = 0.4,
                     radius: int = 4) -> np.ndarray:
    """Measured per-vendor BF kernel (copy of the JAX package's): the
    shape, with the channel stops' x/y anisotropy, from the committed
    9 x 9 kernels `data/bf_kernel_{itl,e2v}.npy` (copies of the JAX
    package's files); the amplitude rescaled so the central-pixel area
    response (the discrete laplacian at the core) matches the isotropic
    default at the same `strength`.  Unknown vendors get the isotropic
    kernel.  Cached as numpy."""
    path = os.path.join(_DATA, f"bf_kernel_{str(vendor).lower()}.npy")
    iso = default_bf_kernel(radius=radius, strength=strength)
    if not os.path.isfile(path):
        return iso
    K = np.load(path).astype(np.float32)
    if K.shape != iso.shape:
        return iso
    c = radius

    def lap(M):
        return float(M[c, c + 1] + M[c, c - 1] + M[c + 1, c]
                     + M[c - 1, c] - 4.0 * M[c, c])

    return (K * (lap(iso) / lap(K))).astype(np.float32)


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
    # absorption-length table values on [250, 1100] nm (host float32);
    # None: absorption_length_table()
    abs_y: np.ndarray | None = None
    # tabulated radial tree-ring displacement [px] on [0, treering_rmax]
    # (used when tr_waves is None)
    treering_y: np.ndarray | None = None
    treering_rmax: float = 8000.0

    @classmethod
    def make(cls, treering_center=(-1000.0, -1000.0), treering_profile=None,
             thickness_um=100.0, diffusion_um=4.0, bf_strength=0.4,
             treering_model=None) -> "SiliconParams":
        """The JAX package's SiliconParams.make: the default BF kernel at
        `bf_strength`, the absorption table, and tree rings from a model
        with `center`, `profile`, `waves` and `env` (or a tabulated
        profile, or none)."""
        tr_waves = tr_env = None
        if treering_model is not None:
            treering_center = treering_model.center
            treering_profile = treering_model.profile
            tr_waves = np.asarray(treering_model.waves, np.float32)
            tr_env = np.asarray([float(v) for v in treering_model.env],
                                np.float32)
        tr = np.zeros(2048, np.float32) if treering_profile is None \
            else np.asarray(treering_profile, np.float32)
        center = np.asarray([float(v) for v in treering_center], np.float32)
        return cls(
            thickness_um=thickness_um, pixel_um=10.0,
            diffusion_um=diffusion_um,
            bf_kernel=default_bf_kernel(strength=bf_strength),
            treering_center=(float(center[0]), float(center[1])),
            tr_waves=tr_waves, tr_env=tr_env,
            tr_active=bool(np.any(tr != 0.0)) or tr_waves is not None,
            abs_y=absorption_length_table().y, treering_y=tr)


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


def _table_lookup(y, x0: float, dx: float, x: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of the uniform table y (host or device) at
    x, clamped at the ends, on x's device."""
    return UniformTable(x0, dx, torch.as_tensor(y, device=x.device))(x)


def _treering_dr(r: torch.Tensor, params: SiliconParams) -> torch.Tensor:
    """Radial tree-ring displacement dr(r) [px]: the analytic sinusoid
    sum when wave parameters exist, else the tabulated profile."""
    if params.tr_waves is None:
        n = params.treering_y.shape[0]
        return _table_lookup(params.treering_y, 0.0,
                             params.treering_rmax / (n - 1), r)
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


def silicon_draws(gen, n: int):
    """The per-photon draws of apply_silicon_displacements, in order:
    the conversion-depth uniform on [1e-7, 1) and two standard normals
    of the diffusion."""
    return (rng.uniform(gen, n, 1e-7, 1.0), rng.normal(gen, n),
            rng.normal(gen, n))


def apply_silicon_displacements(photons: PhotonBatch, params: SiliconParams,
                                draws, disp=None,
                                treerings: bool = True) -> PhotonBatch:
    """Conversion depth, lateral travel, diffusion, per-photon tree rings
    (analytic waves or the table) and, with disp = (dx, dy), the BF
    displacement gathered at each photon's nearest pixel; the pure step
    with draws = silicon_draws(...).  treerings=False skips the tree
    rings (the caller folds the static field into the image update)."""
    u, g1, g2 = draws
    labs = photons.abs_len
    if labs is None:
        n_abs = params.abs_y.shape[0]
        labs = _table_lookup(params.abs_y, ABS_TABLE_MIN_NM,
                             (ABS_TABLE_MAX_NM - ABS_TABLE_MIN_NM)
                             / (n_abs - 1), photons.wavelength)
    x, y, flux = depth_diffusion_displace(
        u, g1, g2, photons.x, photons.y, photons.dxdz, photons.dydz,
        photons.flux, labs, params.thickness_um, params.pixel_um,
        params.diffusion_um)
    if treerings and (params.tr_waves is not None
                      or params.treering_y is not None):
        cx, cy = params.treering_center
        rx = x - cx
        ry = y - cy
        r = torch.clamp(torch.hypot(rx, ry), min=1e-6)
        dr = _treering_dr(r, params)
        x = x + dr * rx / r
        y = y + dr * ry / r
    if disp is not None:
        H, W = disp[0].shape
        ix = torch.clamp(torch.round(x), 0, W - 1).to(torch.int64)
        iy = torch.clamp(torch.round(y), 0, H - 1).to(torch.int64)
        # the packed (H, W, 2) field: one gather fetches both components
        g = torch.stack(disp, dim=-1).reshape(-1, 2)[iy * W + ix]
        x = x + g[:, 0]
        y = y + g[:, 1]
    return photons.replace(x=x, y=y, flux=flux)


def accumulate_silicon(photons: PhotonBatch, image: torch.Tensor,
                       params: SiliconParams, nsub: int = 4,
                       tr_field=None, tally: dict | None = None, *,
                       pre_displaced: bool = False, bf_mode: str = "image",
                       gen=None):
    """Accumulate a pooled batch in `nsub` chunks, recomputing the BF
    displacement field before each (the nrecalc cadence).

    bf_mode='image': each chunk is binned, then moved by the BF (+ the
    folded tr_field) continuity update; bf_mode='photon': each chunk's
    photons are displaced through a gather of the field (and their own
    tree rings; tr_field is ignored) before binning.  pre_displaced=True:
    the photons already carry their depth/diffusion displacement (the
    optics path's fused chain), 'image' mode only; otherwise each chunk
    is displaced with draws from `gen`, chunk by chunk.  Photons past
    nsub * (n // nsub) are not accumulated, as in the reference.  Each
    chunk's spans: `sensor.field` (K3), `sensor.displace`, `sensor.bin`
    and, in 'image' mode, `sensor.redistribute`."""
    if pre_displaced and bf_mode == "photon":
        raise ValueError("pre_displaced requires bf_mode='image'")
    if bf_mode not in ("image", "photon"):
        raise ValueError(f"bf_mode {bf_mode!r}: 'image' or 'photon'")
    if not pre_displaced and gen is None:
        raise ValueError("the per-chunk displacement needs `gen`")
    chunk = photons.n // nsub
    fold_tr = tr_field is not None and bf_mode == "image"
    dev = image.device
    if bf_mode == "photon":
        # the chunks bin into the running image: never into the caller's
        image = image.clone()
    for i in range(nsub):
        with trace.span("sensor.field", device=dev):
            dx, dy = displacement_field(image, params)
        ph = photons.slice(i * chunk, (i + 1) * chunk)
        if bf_mode == "photon":
            with trace.span("sensor.displace", device=dev):
                ph = apply_silicon_displacements(
                    ph, params, silicon_draws(gen, chunk), disp=(dx, dy))
            with trace.span("sensor.bin", device=dev):
                image = accumulate(ph, image, tally)
            continue
        if not pre_displaced:
            with trace.span("sensor.displace", device=dev):
                ph = apply_silicon_displacements(
                    ph, params, silicon_draws(gen, chunk),
                    treerings=not fold_tr)
        with trace.span("sensor.bin", device=dev):
            chunk_img = binned(ph, image.shape, dev, tally)
        with trace.span("sensor.redistribute", device=dev):
            if fold_tr:
                dx = dx + tr_field[0]
                dy = dy + tr_field[1]
            image = image + bf_redistribute(chunk_img, dx, dy)
    return image
