"""A measured sensor model's BF kernel (imsim_tpu/sensor/sensor_model.py
counterpart, host numpy): the brighter-fatter interaction kernel derived
from a Poisson solver's pixel-vertex file (`lsst_{itl,e2v}_*.dat`, the
files GalSim's SiliconSensor reads) and its companion `.cfg`.

The file holds a 9 x 9 pixel stamp with `CollectedCharge` electrons in
the central pixel, one row per boundary vertex: ``X0 Y0 Theta X Y`` (the
pixel centre [um], the vertex angle, the distorted vertex [um]).  The
shoelace area of every distorted pixel gives its fractional area change
dA/A; to first order dA/A = Q laplacian(K), so the kernel is the
discrete inverse K = laplacian^-1[(dA/A) / Q] (an FFT Poisson solve on a
torus), which keeps the measured x/y anisotropy.  The sensor's
displacement stencil (K3) takes the kernel's central differences as its
taps (sensor/silicon.bf_taps).
"""
from __future__ import annotations

import functools
import os
import re

import numpy as np


def read_cfg(path: str) -> dict:
    """The companion .cfg: ``key = value`` lines, '#' comments; numbers
    become floats, several values a list."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            conv = []
            for t in v.split():
                try:
                    conv.append(float(t))
                except ValueError:
                    conv.append(t)
            out[k.strip()] = conv[0] if len(conv) == 1 else conv
    return out


@functools.lru_cache(maxsize=8)
def read_vertex_file(path: str):
    """-> (centers (P, 2), thetas (P, V), verts (P, V, 2)) [um]: the
    vertex rows grouped by pixel, in file order within each."""
    d = np.loadtxt(path, skiprows=1)
    centers, idx = np.unique(d[:, :2], axis=0, return_inverse=True)
    P = len(centers)
    V = len(d) // P
    order = np.lexsort((np.arange(len(d)), idx))
    thetas = d[order, 2].reshape(P, V)
    verts = d[order, 3:5].reshape(P, V, 2)
    return centers, thetas, verts


def _cfg_for(path: str):
    """(collected charge, charged pixel's centre [um], pixel size [um])
    from the .cfg beside `path`, or the solver's defaults."""
    cfg_path = re.sub(r"\.dat$", ".cfg", path)
    if os.path.exists(cfg_path):
        cfg = read_cfg(cfg_path)
        q = float(cfg.get("CollectedCharge_0_0", 100000.0))
        cen = cfg.get("FilledPixelCoords_0_0", [55.0, 55.0])
        pix = float(cfg.get("PixelSizeX", 10.0))
        return q, (float(cen[0]), float(cen[1])), pix
    return 100000.0, (55.0, 55.0), 10.0


def pixel_areas(path: str):
    """The shoelace area of every distorted pixel: (offsets from the
    charged pixel [px] (P, 2), fractional area change (P,))."""
    centers, thetas, verts = read_vertex_file(path)
    q, (cx, cy), pix = _cfg_for(path)
    x, y = verts[..., 0], verts[..., 1]
    a = 0.5 * np.abs(np.sum(
        x * np.roll(y, -1, axis=1) - np.roll(x, -1, axis=1) * y, axis=1))
    off = (centers - [cx, cy]) / pix
    return off, a / pix**2 - 1.0


def radial_displacement_profile(path: str, nbin: int = 48):
    """The azimuthally averaged radial vertex displacement m(r) [um] at
    radii r [px]: each vertex against its place on the square pixel's
    boundary, less the median pattern of the far pixels (r > 3.5 px:
    the static distortion every pixel shares), projected on the
    direction from the charged centre; empty bins interpolated.
    -> (r_px (nbin,), m_um (nbin,))."""
    centers, thetas, verts = read_vertex_file(path)
    q, (cx, cy), pix = _cfg_for(path)
    ct, st = np.cos(thetas), np.sin(thetas)
    scale = (pix / 2) / np.maximum(np.abs(ct), np.abs(st))
    nomx = centers[:, None, 0] + scale * ct
    nomy = centers[:, None, 1] + scale * st
    dx = verts[..., 0] - nomx
    dy = verts[..., 1] - nomy
    rpix = np.hypot(centers[:, 0] - cx, centers[:, 1] - cy) / pix
    far = rpix > 3.5
    dx = dx - np.median(dx[far], axis=0)
    dy = dy - np.median(dy[far], axis=0)
    vx = verts[..., 0] - cx
    vy = verts[..., 1] - cy
    r = np.hypot(vx, vy)
    m = ((dx * vx + dy * vy) / np.maximum(r, 1e-9)).ravel()
    r_px = (r / pix).ravel()
    edges = np.linspace(0.0, r_px.max(), nbin + 1)
    which = np.clip(np.digitize(r_px, edges) - 1, 0, nbin - 1)
    num = np.bincount(which, m, minlength=nbin)
    den = np.bincount(which, minlength=nbin)
    prof = np.where(den > 0, num / np.maximum(den, 1), np.nan)
    cbin = 0.5 * (edges[:-1] + edges[1:])
    ok = np.isfinite(prof)
    return cbin, np.interp(cbin, cbin[ok], prof[ok])


def bf_kernel_from_model(path: str, radius: int = 4,
                         strength: float = 1.0, ngrid: int = 64):
    """The (2 radius + 1)^2 BF interaction kernel [per electron] of the
    vertex file at `path`: its pixel-area changes over Q on an ngrid^2
    torus (less their mean), divided by the discrete Laplacian's
    eigenvalues in Fourier space, zero in the far field (the grid's
    farthest point), cut around the charged pixel and scaled by
    `strength` (image.sensor.strength); float32."""
    q, _, _ = _cfg_for(path)
    off, da = pixel_areas(path)
    g = np.zeros((ngrid, ngrid))
    for (ox, oy), a in zip(off, da):
        g[int(round(oy)) % ngrid, int(round(ox)) % ngrid] = a / q
    g -= g.mean()
    u = np.fft.fftfreq(ngrid) * 2 * np.pi
    lam = 2 * np.cos(u)[None, :] + 2 * np.cos(u)[:, None] - 4.0
    lam[0, 0] = 1.0
    Khat = np.fft.fft2(g) / lam
    Khat[0, 0] = 0.0
    K = np.real(np.fft.ifft2(Khat))
    K = K - K[ngrid // 2, ngrid // 2]
    K = np.roll(K, (radius, radius), (0, 1))[:2 * radius + 1,
                                             :2 * radius + 1]
    return (strength * K).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _kernel_cached(path: str, radius: int, strength: float):
    return bf_kernel_from_model(path, radius, strength)


def resolve_sensor_model(name_or_path: str, search_dirs=()) -> str:
    """A file path, or a model name ('lsst_itl_50_32') looked up as
    `<dir>/<name>.dat`, then `<dir>/<name>`, in each of `search_dirs`."""
    if os.path.exists(name_or_path):
        return name_or_path
    for d in search_dirs:
        p = os.path.join(d, name_or_path + ".dat")
        if os.path.exists(p):
            return p
        p = os.path.join(d, name_or_path)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"sensor model {name_or_path!r} not found "
                            f"in {list(search_dirs)}")
