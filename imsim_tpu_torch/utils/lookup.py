"""Lookup tables and Chebyshev evaluators (imsim_tpu/utils/lookup.py
counterpart).  The fits (`PolyCDF.fit`, `inverse_cdf_table`) are host
numpy copies of the JAX package's.  Coefficients of the 1-D samplers are
host numpy float32 arrays, so evaluation never reads a device scalar
back to the host."""
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

    @classmethod
    def from_pairs(cls, x, y, n=None, dtype=torch.float32,
                   device="cuda") -> "UniformTable":
        """Arbitrary (x, y) samples resampled onto a uniform grid (np.interp
        on the host, y on `device`)."""
        x = np.asarray(x, float)
        y = np.asarray(y, float)
        order = np.argsort(x)
        x, y = x[order], y[order]
        if n is None:
            n = max(len(x), 2)
        xu = np.linspace(x[0], x[-1], n)
        yu = np.interp(xu, x, y)
        return cls(float(xu[0]), float(xu[1] - xu[0]),
                   torch.as_tensor(yu, dtype=dtype, device=device))

    @classmethod
    def from_func(cls, f, x_min, x_max, n, dtype=torch.float32,
                  device="cuda") -> "UniformTable":
        """f sampled at n uniform points of [x_min, x_max] (on the host,
        y on `device`)."""
        xu = np.linspace(x_min, x_max, n)
        return cls(float(x_min), float((x_max - x_min) / (n - 1)),
                   torch.as_tensor(np.asarray(f(xu)), dtype=dtype,
                                   device=device))

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
    fitted on the host by `fit`."""

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

    @classmethod
    def fit(cls, table, u_split=0.85, d_core=24, d_tail=18,
            u_max=1.0 - 1e-7):
        """Fit from an inverse-CDF table r(u) (u uniform on [0, 1]; y a
        numpy or CPU tensor).  Returns (poly, max_rel_err)."""
        import numpy.polynomial.chebyshev as C

        def r_of(u):
            n = len(table.y)
            f = np.clip((u - table.x0) / table.dx, 0, n - 1.000001)
            i = f.astype(int)
            w = f - i
            yv = np.asarray(table.y, float)
            return yv[i] * (1 - w) + yv[i + 1] * w

        x = np.linspace(-1, 1, 4096)
        u_core = u_split * ((x + 1) / 2) ** 2
        c_core = C.chebfit(x, r_of(u_core), d_core)
        s_lo = -np.log1p(-u_split)
        s_hi = -np.log1p(-u_max)
        t = np.linspace(-1, 1, 4096)
        s = s_lo + (t + 1) / 2 * (s_hi - s_lo)
        u_tail = -np.expm1(-s)
        r_tail = np.maximum(r_of(u_tail), 1e-12)
        c_tail = C.chebfit(t, np.log(r_tail), d_tail)
        poly = cls(np.asarray(c_core, np.float32),
                   np.asarray(c_tail, np.float32),
                   float(u_split), float(s_lo), float(s_hi))
        # fit quality over the bulk of the distribution
        uu = np.linspace(1e-4, u_max, 8192)
        ref = r_of(uu)
        x = np.clip(2.0 * np.sqrt(uu / u_split) - 1.0, -1.0, 1.0)
        r_core = C.chebval(x, c_core)
        s = -np.log1p(-np.clip(uu, 0.0, 1.0 - 1e-7))
        tt = np.clip(2.0 * (s - s_lo) / (s_hi - s_lo) - 1.0, -1.0, 1.0)
        got = np.where(uu < u_split, np.maximum(r_core, 0.0),
                       np.exp(C.chebval(tt, c_tail)))
        rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-3 * ref.max())
        return poly, float(rel.max())


def inverse_cdf_table(pdf_x, pdf_y, n=2048) -> UniformTable:
    """Inverse-CDF table u in [0, 1] -> x (numpy float32 y) for sampling
    from a tabulated 1-D pdf (trapezoid CDF, flat spots collapsed)."""
    x = np.asarray(pdf_x, float)
    p = np.clip(np.asarray(pdf_y, float), 0.0, None)
    cdf = np.concatenate([[0.0], np.cumsum(0.5 * (p[1:] + p[:-1])
                                           * np.diff(x))])
    cdf /= cdf[-1]
    u = np.linspace(0.0, 1.0, n)
    eps = np.arange(len(cdf)) * 1e-15
    xi = np.interp(u, cdf + eps, x)
    return UniformTable(0.0, 1.0 / (n - 1), np.asarray(xi, np.float32))
