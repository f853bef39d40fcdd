"""Radial vignetting profile over the focal plane (host numpy; copy of
imsim_tpu/image/vignetting.py).

The default profile: the fraction of the annular pupil left unobscured
as the field angle walks the beam off the optics, as a smooth piecewise
curve matching the published Rubin vignetting (flat to ~1.41 deg, ~12%
at 1.75 deg, steep beyond).  Measured (radius_mm, value) samples or the
reference's B-spline knot file can replace it (`from_file`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..electronics.camera import PIXEL_SIZE_MM
from ..utils.grid import coarse_shape, upsample_bilinear

# focal-plane plate scale: ~50 um/arcsec -> 1 deg = 180.8 mm
MM_PER_DEG = 180.8


def default_profile_samples():
    """(radius_mm, throughput) samples of the default vignetting curve."""
    deg = np.array([0.0, 0.5, 1.0, 1.2, 1.41, 1.55, 1.708, 1.75,
                    1.9, 2.0, 2.1, 2.2, 2.3, 2.5])
    val = np.array([1.0, 1.0, 1.0, 0.999, 0.995, 0.97, 0.92, 0.88,
                    0.75, 0.62, 0.48, 0.33, 0.18, 0.0])
    return deg * MM_PER_DEG, val


class Vignetting:
    """Callable radial vignetting: value(r_mm)."""

    def __init__(self, samples=None, n_table=1024):
        r, v = samples if samples is not None else default_profile_samples()
        self.r_max = float(r[-1])
        grid = np.linspace(0.0, self.r_max, n_table)
        self._np_grid = np.interp(grid, r, v)
        self._np_step = grid[1] - grid[0]

    @classmethod
    def from_file(cls, path, n_table=1024):
        """Load a measured vignetting profile: a ``.json`` B-spline knot
        file (``[t, c, k]`` in focal-plane mm, normalized by its value at
        the centre), or a 2-column text file of ``(radius_mm,
        throughput)`` samples."""
        if str(path).endswith(".json"):
            import json

            from scipy.interpolate import BSpline

            with open(path) as f:
                t, c, k = json.load(f)
            spl = BSpline(np.asarray(t, float), np.asarray(c, float),
                          int(k))
            # the positive-radius branch of the knot span
            r_hi = float(np.max(t))
            r = np.linspace(0.0, r_hi, n_table)
            v = np.clip(spl(r), 0.0, None) / max(float(spl(0.0)), 1e-30)
            return cls((r, v), n_table=n_table)
        samples = np.loadtxt(path, unpack=True)
        return cls(samples, n_table=n_table)

    def __call__(self, r_mm):
        """numpy evaluation (host)."""
        f = np.clip(np.asarray(r_mm, float) / self._np_step, 0,
                    len(self._np_grid) - 1.000001)
        i = f.astype(int)
        w = f - i
        return self._np_grid[i] * (1 - w) + self._np_grid[i + 1] * w

    def coarse_grid(self, det_center_mm, shape,
                    step: int = 32) -> np.ndarray:
        """The CCD's vignetting on its stride-`step` coarse grid
        (utils.grid.coarse_shape), float32: the map the sky stage
        upsamples on the device (the grid config/runner's sky stage
        evaluates in the JAX package)."""
        ny, nx = shape
        gh, gw = coarse_shape((ny, nx), step)
        ys = ((np.arange(gh) * step) - (ny - 1) / 2) * PIXEL_SIZE_MM \
            + det_center_mm[1]
        xs = ((np.arange(gw) * step) - (nx - 1) / 2) * PIXEL_SIZE_MM \
            + det_center_mm[0]
        return np.asarray(self(np.hypot(xs[None, :], ys[:, None])),
                          np.float32)

    def image_plane(self, det_center_mm, pixel_grid_mm, step: int = 32):
        """Vignetting for a full CCD (numpy float32): pixel_grid_mm =
        (Y_mm, X_mm) focal-plane coordinates, affine in the pixel index.
        Evaluated on a stride-`step` grid and bilinearly upsampled
        (relative error < 1e-5 at step 32 for the Rubin curve); step <= 1
        evaluates every pixel."""
        Y, X = pixel_grid_mm
        Y = np.asarray(Y, np.float32).reshape(-1)
        X = np.asarray(X, np.float32).reshape(-1)
        ny, nx = len(Y), len(X)
        if step <= 1 or ny < 3 or nx < 3:
            r = np.hypot(X[None, :], Y[:, None])
            return self(r).astype(np.float32)
        gh, gw = coarse_shape((ny, nx), step)
        # affine extension beyond the CCD edge (one coarse sample)
        dy, dx = Y[1] - Y[0], X[1] - X[0]
        ys = Y[0] + dy * step * np.arange(gh, dtype=np.float64)
        xs = X[0] + dx * step * np.arange(gw, dtype=np.float64)
        g = self(np.hypot(xs[None, :], ys[:, None])).astype(np.float32)
        return upsample_bilinear(torch.from_numpy(g), (ny, nx),
                                 step).numpy()

    def at_sky_coord(self, r_mm):
        """Single-value lookup (scales FFT-object fluxes)."""
        return float(self(r_mm))
