"""Sequential ray trace through the telescope on torch tensors
(imsim_tpu/optics/trace.py counterpart).  Vignetting is a flag; the
caller zeroes the flux of flagged rays.  The OPD maps (optics.opd) also
accumulate the optical path and kick the rays off the mirrors' Zernike
figure errors through slope textures (`build_zk_textures`); the photon
chain and the WCS read neither.

The same code runs the photon chain's plain twin on float32 tensors
with the float32 surface matrix, and the host trace behind the WCS
(optics.wcs_factory) on float64 CPU tensors with the float64 matrix
(`TelescopeDesign.host`), as the JAX package runs its trace with
`xp=numpy`: the operations and their order are the same, so the float64
trace agrees with the JAX package's to rounding."""
from __future__ import annotations

import numpy as np
import torch

from . import geometry as G
from .telescope import DETECTOR, MIRROR, REFRACT_IN, REFRACT_OUT, Telescope


def _to_local(R, vtx, px, py, pz, vx, vy, vz):
    dx, dy, dz = px - vtx[0], py - vtx[1], pz - vtx[2]
    return (R[0] * dx + R[3] * dy + R[6] * dz,
            R[1] * dx + R[4] * dy + R[7] * dz,
            R[2] * dx + R[5] * dy + R[8] * dz,
            R[0] * vx + R[3] * vy + R[6] * vz,
            R[1] * vx + R[4] * vy + R[7] * vz,
            R[2] * vx + R[5] * vy + R[8] * vz)


def _to_global(R, vtx, px, py, pz, vx, vy, vz):
    return (R[0] * px + R[1] * py + R[2] * pz + vtx[0],
            R[3] * px + R[4] * py + R[5] * pz + vtx[1],
            R[6] * px + R[7] * py + R[8] * pz + vtx[2],
            R[0] * vx + R[1] * vy + R[2] * vz,
            R[3] * vx + R[4] * vy + R[5] * vz,
            R[6] * vx + R[7] * vy + R[8] * vz)


def rays_from_field(thx, thy, pupil_u, pupil_v, z_start: float = 10.0):
    """Entrance rays for field angle (thx, thy) [rad] through pupil
    point (pupil_u, pupil_v) [m] at z = z_start."""
    vz = -G.rdiv(1.0, G.sqrt(1.0 + thx * thx + thy * thy))
    vx = -thx * vz
    vy = -thy * vz
    px = pupil_u - thx * z_start
    py = pupil_v - thy * z_start
    pz = torch.full_like(px, z_start)
    return px, py, pz, vx, vy, vz


def surface_scalars(tel: Telescope):
    """Per-surface parameter tuples (c, kappa, coefs, ap_lo, ap_hi,
    vtx3, rot9) of the surface matrix as python floats, the currency of
    trace_surfaces."""
    return [tel.surface(i) for i in range(len(tel.kinds))]


def trace(tel: Telescope, px, py, pz, vx, vy, vz, wavelength_nm,
          zk_textures=None, with_path: bool = False):
    """Trace rays through every surface to the detector.  Returns dict
    with detector-local x, y [m], direction vx, vy, vz, vignette and
    path (the optical path length [m] with `with_path`, else None).
    zk_textures: {surface index: (G, G, 3) numpy (slope_x, slope_y, sag)
    texture} from build_zk_textures, a thin-screen kick at each mirror
    that has one."""
    return trace_surfaces(surface_scalars(tel), tel.kinds, px, py, pz, vx,
                          vy, vz, wavelength_nm, zk_textures, with_path)


def trace_surfaces(surfs, kinds, px, py, pz, vx, vy, vz, wavelength_nm,
                   zk_textures=None, with_path: bool = False):
    """The surface loop of `trace` over per-surface tuples
    (surface_scalars): an asphere's intersection takes the Newton
    polish of its coefficients, a conic's the closed form's."""
    n_silica = G.silica_index(wavelength_nm)
    vignette = torch.zeros_like(px, dtype=torch.bool)
    path = torch.zeros_like(px) if with_path else None
    for i, kind in enumerate(kinds):
        c_i, k_i, coefs_i, ap_lo, ap_hi, vtx, R = surfs[i]
        lx, ly, lz, lvx, lvy, lvz = _to_local(R, vtx, px, py, pz,
                                              vx, vy, vz)
        x, y, z, t, Fres = G.intersect(
            lx, ly, lz, lvx, lvy, lvz, c_i, k_i,
            coefs_i if any(a != 0.0 for a in coefs_i) else ())
        vignette = vignette | (torch.abs(Fres) > 1e-5)
        if with_path:
            # t reached this surface in silica iff it is a REFRACT_OUT
            path = path + t * (n_silica if kind == REFRACT_OUT else 1.0)
        r = G.sqrt(x * x + y * y)
        vignette = vignette | (r < ap_lo) | (r > ap_hi)
        if kind == DETECTOR:
            return dict(x=x, y=y, vx=lvx, vy=lvy, vz=lvz,
                        vignette=vignette, path=path)
        nx, ny, nz = G.surface_normal(x, y, c_i, k_i, coefs_i)
        if kind == MIRROR:
            lvx, lvy, lvz = G.reflect(lvx, lvy, lvz, nx, ny, nz)
            if zk_textures and i in zk_textures:
                gx, gy, sag = _sample_slope(zk_textures[i], x / ap_hi,
                                            y / ap_hi)
                # the reflected ray tilts by twice the slope error
                lvx = lvx - 2.0 * gx / ap_hi
                lvy = lvy - 2.0 * gy / ap_hi
                if with_path:
                    # the figure error changes the double pass
                    path = path - 2.0 * sag
        elif kind == REFRACT_IN:
            lvx, lvy, lvz = G.refract(lvx, lvy, lvz, nx, ny, nz,
                                      G.rdiv(1.0, n_silica))
        elif kind == REFRACT_OUT:
            lvx, lvy, lvz = G.refract(lvx, lvy, lvz, nx, ny, nz, n_silica)
        px, py, pz, vx, vy, vz = _to_global(R, vtx, x, y, z,
                                            lvx, lvy, lvz)
    raise RuntimeError("prescription has no DETECTOR surface")


def _sample_slope(tex, u, v):
    """Nearest sample of a (G, G, 3) numpy (slope_x, slope_y, sag)
    texture over the unit disk [-1, 1]^2 at (u, v), as u's dtype (the
    texture's float32 values widened, as numpy promotes them)."""
    Gn = tex.shape[0]
    iu = torch.clamp(((u + 1.0) * 0.5 * (Gn - 1)).to(torch.int32), 0, Gn - 1)
    iv = torch.clamp(((v + 1.0) * 0.5 * (Gn - 1)).to(torch.int32), 0, Gn - 1)
    flat = torch.as_tensor(tex.reshape(-1, 3), device=u.device)
    g = flat[(iv * Gn + iu).long()].to(u.dtype)
    return g[..., 0], g[..., 1], g[..., 2]


def build_zk_textures(design, grid: int = 256) -> dict:
    """Host: each surface's nonzero Zernike perturbation (design.zk) as a
    (grid, grid, 3) float32 (slope_x, slope_y, sag) texture in normalized
    pupil units; {surface index: texture}."""
    from .zernike import zernike_eval, zernike_grad

    zk = np.asarray(design.zk)
    out = {}
    u = np.linspace(-1, 1, grid)
    U, V = np.meshgrid(u, u)
    for i in range(zk.shape[0]):
        if not np.any(zk[i]):
            continue
        gx, gy = zernike_grad(zk[i], U, V)
        sag = zernike_eval(zk[i], U, V)
        inside = (U * U + V * V) <= 1.0
        out[i] = np.stack([gx * inside, gy * inside,
                           sag * inside], -1).astype(np.float32)
    return out
