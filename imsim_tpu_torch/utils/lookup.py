"""Lookup tables and Chebyshev evaluators (imsim_tpu/utils/lookup.py
counterpart).  The fits stay host-side in the JAX package; the port only
evaluates them.  Coefficients of the 1-D samplers are host numpy float32
arrays, so evaluation never reads a device scalar back to the host."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class UniformTable:
    """y = f(x) on a uniform grid [x0, x0 + (n-1)*dx]; linear
    interpolation, clamped at the ends.  Host tables (the FFT branch's
    MTFs) hold a numpy y and are read through x0, dx, y and x_max."""

    x0: float
    dx: float
    y: torch.Tensor  # (n,); numpy float32 for a host table

    @property
    def x_max(self) -> float:
        return self.x0 + (self.y.shape[0] - 1) * self.dx

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        n = self.y.shape[0]
        f = torch.clamp((x - self.x0) / self.dx, 0.0, n - 1.000001)
        i = torch.floor(f).to(torch.int64)
        w = f - i
        # in f32, n - 1.000001 can round up to n - 1: clamp the pair index
        # as the reference's gather does
        i = torch.clamp(i, max=n - 2)
        return self.y[i] * (1 - w) + self.y[i + 1] * w


def clenshaw_rows(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Chebyshev evaluation with per-row coefficients: c (N, D), x (N,)."""
    b1 = torch.zeros_like(x)
    b2 = torch.zeros_like(x)
    for k in range(c.shape[1] - 1, 0, -1):
        b1, b2 = c[:, k] + 2.0 * x * b1 - b2, b1
    return c[:, 0] + x * b1 - b2


def clenshaw_cols(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """clenshaw_rows for the photon-minor layout: c (D, N), x (N,)."""
    b1 = torch.zeros_like(x)
    b2 = torch.zeros_like(x)
    for k in range(c.shape[0] - 1, 0, -1):
        b1, b2 = c[k] + 2.0 * x * b1 - b2, b1
    return c[0] + x * b1 - b2


def clenshaw_const(c, x: torch.Tensor) -> torch.Tensor:
    """Chebyshev series with host (float) coefficients c at x."""
    c = [float(v) for v in np.asarray(c, np.float32)]
    b1 = torch.zeros_like(x)
    b2 = torch.zeros_like(x)
    for k in range(len(c) - 1, 0, -1):
        b1, b2 = c[k] + 2 * x * b1 - b2, b1
    return c[0] + x * b1 - b2


@dataclasses.dataclass(frozen=True)
class PolyCDF:
    """Gather-free inverse-CDF sampler r(u) as piecewise Chebyshev
    (core in x = 2 sqrt(u/u_split) - 1, tail log r in s = -log(1-u));
    fitted by imsim_tpu.utils.lookup.PolyCDF.fit."""

    c_core: np.ndarray   # (D1,) float32
    c_tail: np.ndarray   # (D2,) float32
    u_split: float
    s_lo: float
    s_hi: float

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        u = torch.clamp(u, 0.0, 1.0 - 1e-7)
        x = torch.clamp(2.0 * torch.sqrt(u / self.u_split) - 1.0, -1.0, 1.0)
        r_core = clenshaw_const(self.c_core, x)
        s = -torch.log1p(-u)
        t = torch.clamp(2.0 * (s - self.s_lo) / (self.s_hi - self.s_lo)
                        - 1.0, -1.0, 1.0)
        r_tail = torch.exp(clenshaw_const(self.c_tail, t))
        return torch.where(u < self.u_split, torch.clamp(r_core, min=0.0),
                           r_tail)
