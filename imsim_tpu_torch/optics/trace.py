"""Sequential ray trace through the telescope on torch tensors
(imsim_tpu/optics/trace.py counterpart; no Zernike textures, no optical
path).  Vignetting is a flag; the caller zeroes the flux of flagged rays.

The same code runs the photon chain's plain twin on float32 tensors
with the float32 surface matrix, and the host trace behind the WCS
(optics.wcs_factory) on float64 CPU tensors with the float64 matrix
(`TelescopeDesign.host`), as the JAX package runs its trace with
`xp=numpy`: the operations and their order are the same, so the float64
trace agrees with the JAX package's to rounding."""
from __future__ import annotations

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
    vz = -1.0 / torch.sqrt(1.0 + thx * thx + thy * thy)
    vx = -thx * vz
    vy = -thy * vz
    px = pupil_u - thx * z_start
    py = pupil_v - thy * z_start
    pz = torch.full_like(px, z_start)
    return px, py, pz, vx, vy, vz


def trace(tel: Telescope, px, py, pz, vx, vy, vz, wavelength_nm):
    """Trace rays through every surface to the detector.  Returns dict
    with detector-local x, y [m], direction vx, vy, vz and vignette."""
    n_silica = G.silica_index(wavelength_nm)
    vignette = torch.zeros_like(px, dtype=torch.bool)
    for i, kind in enumerate(tel.kinds):
        c_i, k_i, coefs_i, ap_lo, ap_hi, vtx, R = tel.surface(i)
        lx, ly, lz, lvx, lvy, lvz = _to_local(R, vtx, px, py, pz,
                                              vx, vy, vz)
        steps = tel.newton_steps(i)
        x, y, z, t, Fres = G.intersect(
            lx, ly, lz, lvx, lvy, lvz, c_i, k_i,
            coefs_i if steps > G.NEWTON_POLISH else ())
        vignette = vignette | (torch.abs(Fres) > 1e-5)
        r = torch.sqrt(x * x + y * y)
        vignette = vignette | (r < ap_lo) | (r > ap_hi)
        if kind == DETECTOR:
            return dict(x=x, y=y, vx=lvx, vy=lvy, vz=lvz,
                        vignette=vignette)
        nx, ny, nz = G.surface_normal(x, y, c_i, k_i, coefs_i)
        if kind == MIRROR:
            lvx, lvy, lvz = G.reflect(lvx, lvy, lvz, nx, ny, nz)
        elif kind == REFRACT_IN:
            lvx, lvy, lvz = G.refract(lvx, lvy, lvz, nx, ny, nz,
                                      1.0 / n_silica)
        elif kind == REFRACT_OUT:
            lvx, lvy, lvz = G.refract(lvx, lvy, lvz, nx, ny, nz, n_silica)
        px, py, pz, vx, vy, vz = _to_global(R, vtx, x, y, z,
                                            lvx, lvy, lvz)
    raise RuntimeError("prescription has no DETECTOR surface")
