"""Silicon host tables (copy of imsim_tpu_torch/sensor/silicon.py's
host numpy): the absorption length of silicon on a uniform wavelength
table and the default isotropic brighter-fatter kernel."""
from __future__ import annotations

import numpy as np

# log10(l_abs/um) piecewise-linear fit to published Si data (Green 2008)
_ABS_WAVE = np.array([250, 300, 350, 400, 450, 500, 550, 600, 650, 700,
                      750, 800, 850, 900, 950, 1000, 1050, 1100], float)
_ABS_LEN_UM = np.array([0.006, 0.006, 0.01, 0.1, 0.4, 0.9, 1.7, 2.9, 4.5,
                        6.9, 10.5, 15.0, 23.0, 37.0, 62.0, 120.0, 400.0,
                        2000.0], float)
ABS_TABLE_MIN_NM = 250.0
ABS_TABLE_MAX_NM = 1100.0
ABS_TABLE_POINTS = 256


def absorption_table() -> np.ndarray:
    """Absorption length [um] (float32) on ABS_TABLE_POINTS points over
    [ABS_TABLE_MIN_NM, ABS_TABLE_MAX_NM]."""
    grid = np.linspace(ABS_TABLE_MIN_NM, ABS_TABLE_MAX_NM, ABS_TABLE_POINTS)
    return (10 ** np.interp(grid, _ABS_WAVE, np.log10(_ABS_LEN_UM))) \
        .astype(np.float32)


def default_bf_kernel(radius=4, strength=0.4) -> np.ndarray:
    """Isotropic short-range BF interaction kernel (per electron,
    float32): strength / sqrt(r^2 + 0.8^2) / 1e5."""
    r = np.arange(-radius, radius + 1)
    X, Y = np.meshgrid(r, r)
    rr = np.hypot(X, Y)
    K = strength / np.sqrt(rr**2 + 0.8**2)
    return (K / 1e5).astype(np.float32)
