"""Optical-path-difference maps and their Zernike analysis
(imsim_tpu/optics/opd.py counterpart): the `opd` and `sag` extra
outputs.

A pupil grid of rays is traced with path accumulation to the detector
through the port's float64 host trace (optics.trace on CPU tensors,
with the mirrors' Zernike figure as slope textures), referenced to a
plane fit of piston and tilt, and fit with Zernikes; the sag maps are
the surfaces' conic + asphere + Zernike figure.  Host numpy around the
trace, as the JAX package's numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.zernike import fit_zernikes, zernike_eval
from .trace import build_zk_textures, rays_from_field, trace

PUPIL_R_OUTER = 4.18
PUPIL_R_INNER = 2.558
OBSCURATION = PUPIL_R_INNER / PUPIL_R_OUTER


def opd_map(design, thx: float, thy: float, wavelength_nm: float = 622.0,
            nx: int = 255):
    """OPD map [nm] over the pupil of the TelescopeDesign `design` at
    field angle (thx, thy) [rad].  Returns (opd[nx, nx], mask[nx, nx],
    grid_x, grid_y): piston and tilt removed, NaN outside the annulus."""
    u = np.linspace(-PUPIL_R_OUTER, PUPIL_R_OUTER, nx)
    U, V = np.meshgrid(u, u)
    R = np.hypot(U, V)
    mask = (R <= PUPIL_R_OUTER) & (R >= PUPIL_R_INNER)
    pu = U[mask]
    pv = V[mask]
    n = pu.size

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64)

    rays = rays_from_field(t(np.full(n, thx)), t(np.full(n, thy)), t(pu),
                           t(pv))
    zk_tex = build_zk_textures(design) if np.any(design.zk) else None
    out = trace(design.host, *rays, t(np.full(n, wavelength_nm)),
                zk_textures=zk_tex, with_path=True)
    path = out["path"].numpy()
    # reference sphere: piston and tilt (the image position) removed
    A = np.stack([np.ones(n), pu, pv], axis=-1)
    coef, *_ = np.linalg.lstsq(A, path, rcond=None)
    opd_nm = -(path - A @ coef) * 1e9
    img = np.full((nx, nx), np.nan)
    img[mask] = opd_nm
    return img, mask, u, u


def annular_zernikes(design, thx: float, thy: float,
                     wavelength_nm: float = 622.0, jmax: int = 28,
                     nx: int = 255, eps: float = None):
    """Zernike coefficients [nm] (Noll 1..jmax, on r / R_outer) of the
    wavefront at one field angle, fit over the annulus; an `eps` above the
    pupil obscuration narrows the fit's annulus."""
    img, mask, u, _ = opd_map(design, thx, thy, wavelength_nm, nx)
    U, V = np.meshgrid(u, u)
    if eps is not None and eps > OBSCURATION:
        mask = mask & (np.hypot(U, V) >= eps * PUPIL_R_OUTER)
    x = U[mask] / PUPIL_R_OUTER
    y = V[mask] / PUPIL_R_OUTER
    return fit_zernikes(x, y, img[mask], jmax)


def opd_fits_header(thx, thy, wavelength_nm, telescope_name="LSST",
                    jmax=28, eps=OBSCURATION):
    """The OPD image's provenance keywords."""
    return {
        "UNITS": "nm",
        "THX": np.degrees(thx),
        "THY": np.degrees(thy),
        "WAVELEN": wavelength_nm,
        "TELESCOP": telescope_name,
        "JMAX": jmax,
        "EPS": eps,
    }


def _surface_sag(x, y, c, kappa, coefs):
    """Conic + even-polynomial asphere sag, numpy float64."""
    r2 = x * x + y * y
    arg = 1.0 - (1.0 + kappa) * c * c * r2
    z = c * r2 / (1.0 + np.sqrt(np.maximum(arg, 1e-12)))
    if len(coefs):
        acc = 0.0
        for a in reversed(coefs):
            acc = acc * r2 + a
        z = z + r2 * r2 * acc
    return z


def surface_sag_map(design, surface_name: str, nx: int = 255):
    """Surface sag map [m] of one surface with its Zernike figure, NaN
    outside its annulus: (sag, mask, grid)."""
    i = design.names.index(surface_name)
    aper = np.asarray(design.aper, float)[i]
    c = float(np.asarray(design.c)[i])
    k = float(np.asarray(design.kappa)[i])
    coefs = list(np.asarray(design.coefs, float)[i])
    u = np.linspace(-aper[1], aper[1], nx)
    U, V = np.meshgrid(u, u)
    R = np.hypot(U, V)
    mask = (R <= aper[1]) & (R >= aper[0])
    sag = _surface_sag(U, V, c, k, coefs)
    zk = np.asarray(design.zk, float)[i]
    if np.any(zk):
        sag = sag + zernike_eval(zk, U / aper[1], V / aper[1])
    sag = np.where(mask, sag, np.nan)
    return sag, mask, u
