"""Statistical spider diffraction (imsim_tpu/photons/diffraction.py
counterpart): photons near a spider vane or aperture edge get a random
angular kick perpendicular to the nearest edge, sigma
phi* = atan(1 / (2 k delta)), with the spider swept by the exact alt-az
field-rotation curve over the exposure."""
from __future__ import annotations

import numpy as np
import torch

# Rubin spider/aperture 2-D projection: lines [nx, ny, d, half-thickness]
# and circles [cx, cy, r] (imsim/diffraction.py:32-42).
S2 = 1.0 / np.sqrt(2.0)
SPIDER_LINES = np.array([
    [S2, S2, -0.4, 0.025],
    [-S2, S2, -0.4, 0.025],
    [S2, S2, 0.4, 0.025],
    [-S2, S2, 0.4, 0.025],
], np.float32)
SPIDER_CIRCLES = np.array([
    [0.0, 0.0, 2.558],
    [0.0, 0.0, 4.18],
], np.float32)

OMEGA_EARTH = 7.292115826090781e-05  # rad/s

# Two edge distances closer than this are a tie: about four float32 ulps
# of a pupil coordinate at the 4.18 m rim, the rounding of the rotated
# pupil point and of the distances.  Either edge's kick is right there.
TIE_M = 2e-6


def nearest_edge(px, py):
    """Distance and unit direction (dist, nx, ny) from pupil points to
    the nearest spider/aperture edge (select chains, first match wins
    on ties, as in the reference)."""
    dist = nx = ny = None
    for lnx, lny, d0, thick in SPIDER_LINES.tolist():
        dl = torch.abs(torch.abs(lnx * px + lny * py - d0) - thick)
        if dist is None:
            dist = dl
            nx = torch.full_like(px, lnx)
            ny = torch.full_like(px, lny)
        else:
            closer = dl < dist
            nx = torch.where(closer, lnx, nx)
            ny = torch.where(closer, lny, ny)
            dist = torch.minimum(dl, dist)
    for cx, cy, r in SPIDER_CIRCLES.tolist():
        dxc = cx - px
        dyc = cy - py
        rr = torch.clamp(torch.hypot(dxc, dyc), min=1e-12)
        dc = torch.abs(rr - r)
        closer = dc < dist
        nx = torch.where(closer, dxc / rr, nx)
        ny = torch.where(closer, dyc / rr, ny)
        dist = torch.minimum(dc, dist)
    return dist, nx, ny


def two_nearest_edges(pupil_u, pupil_v, t=None, latitude=-0.5278,
                      altitude=None, azimuth=None) -> torch.Tensor:
    """(2, n) float64: the two smallest distances [m] from each pupil
    point to a spider vane or aperture circle, in the rotating spider
    frame (t None: no rotation)."""
    u, v = pupil_u.double(), pupil_v.double()
    if t is not None and altitude is not None:
        s, c = field_rotation_sincos(t, latitude, altitude, azimuth)
        c, s = c.double(), s.double()
        u, v = c * u - s * v, s * u + c * v
    edges = [((nx * u + ny * v - d0).abs() - th).abs()
             for nx, ny, d0, th in SPIDER_LINES.tolist()]
    edges += [(torch.hypot(u - cx, v - cy) - r).abs()
              for cx, cy, r in SPIDER_CIRCLES.tolist()]
    return torch.sort(torch.stack(edges), dim=0).values[:2]


def field_rotation_frame(latitude: float, altitude: float,
                         azimuth: float) -> dict:
    """Visit constants of the field-rotation curve: e_focal (fx, fy, fz)
    and e_h0 = e_focal x e_z0 with its norm, in float64."""
    cl, sl = np.cos(latitude), np.sin(latitude)
    ca, sa = np.cos(altitude), np.sin(altitude)
    fx = -sl * ca * np.cos(azimuth) + cl * sa
    fy = ca * np.sin(azimuth)
    fz = cl * ca * np.cos(azimuth) + sl * sa
    h0x, h0y, h0z = fy * sl, fz * cl - fx * sl, -fy * cl
    out = dict(cl=cl, sl=sl, fx=fx, fy=fy, fz=fz, h0x=h0x, h0y=h0y,
               h0z=h0z, n_h0=np.sqrt(h0x * h0x + h0y * h0y + h0z * h0z))
    return {k: float(v) for k, v in out.items()}


def field_rotation_sincos(t, latitude, altitude, azimuth):
    """(sin, cos) of the field rotation angle theta(t) of an alt-az
    mount, t seconds from exposure start (closed form, normalized)."""
    f = field_rotation_frame(latitude, altitude, azimuth)
    wt = OMEGA_EARTH * t
    zx = torch.cos(wt) * f["cl"]
    zy = torch.sin(wt) * f["cl"]
    sl = f["sl"]
    htx = f["fy"] * sl - f["fz"] * zy
    hty = f["fz"] * zx - f["fx"] * sl
    htz = f["fx"] * zy - f["fy"] * zx
    nrm = torch.sqrt(htx * htx + hty * hty + htz * htz) * f["n_h0"]
    cos_t = (htx * f["h0x"] + hty * f["h0y"] + htz * f["h0z"]) / nrm
    sin_t = (zx * f["h0x"] + zy * f["h0y"] + sl * f["h0z"]) / nrm
    r = 1.0 / torch.sqrt(sin_t * sin_t + cos_t * cos_t)
    return sin_t * r, cos_t * r


def spider_distance(pupil_u, pupil_v, t=None, latitude=-0.5278,
                    altitude=None, azimuth=None):
    """Distance [m] from each pupil point to the nearest spider or
    aperture edge in the rotating spider frame (t None: no rotation)."""
    if t is not None and altitude is not None:
        s, c = field_rotation_sincos(t, latitude, altitude, azimuth)
        pupil_u, pupil_v = (c * pupil_u - s * pupil_v,
                            s * pupil_u + c * pupil_v)
    return nearest_edge(pupil_u, pupil_v)[0]


def apply_diffraction(pupil_u, pupil_v, dxdz, dydz, wavelength_nm, normal,
                      t=None, latitude=-0.5278, altitude=None, azimuth=None,
                      enable_field_rotation=True):
    """Return kicked (dxdz, dydz).  `normal` is the pre-drawn standard
    normal per photon (the caller owns the random stream)."""
    if enable_field_rotation and t is not None and altitude is not None:
        s, c = field_rotation_sincos(t, latitude, altitude, azimuth)
        pu = c * pupil_u - s * pupil_v
        pv = s * pupil_u + c * pupil_v
    else:
        c = torch.ones_like(pupil_u)
        s = torch.zeros_like(pupil_u)
        pu, pv = pupil_u, pupil_v
    dist, nx, ny = nearest_edge(pu, pv)
    k = 2 * np.pi / (wavelength_nm * 1e-9)
    phi_star = torch.atan(1.0 / (2.0 * k * torch.clamp(dist, min=1e-9)))
    kick = phi_star * normal
    du = kick * nx
    dv = kick * ny
    return dxdz + (c * du + s * dv), dydz + (-s * du + c * dv)
