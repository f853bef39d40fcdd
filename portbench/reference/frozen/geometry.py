"""Ray-surface math on torch tensors (imsim_tpu/optics/geometry.py
counterpart, photon path only).

Every function is elementwise over ray tensors of shape (N,), float32
on the photon path or float64 CPU tensors in the host trace (the WCS);
surface constants (c, kappa, coefs) are python floats.  The operation order is
the reference's, so python-float subexpressions such as (1 + kappa) c^2
are evaluated in float64 and rounded once where they meet a float32
tensor, as there.

Conventions: lengths in meters; optical axis +z pointing at the sky;
rays from the sky travel with vz < 0.  A surface is placed at vertex
z = z0 with sag measured along +z in its local frame.
"""
from __future__ import annotations

import numpy as np
import torch

# the JAX package's legacy fixed Newton budget (kept for reference)
NEWTON_ITERS = 4
# Newton steps after the closed-form conic root (+2 on an asphere)
NEWTON_POLISH = 1


def sqrt(x):
    """torch.sqrt, but numpy's correctly rounded square root for a
    float64 CPU tensor: the host trace (WCS, OPD) then rounds as the JAX
    package's numpy trace does.  PyTorch's vectorized float64 sqrt on the
    CPU is not correctly rounded (1 ulp off on some inputs)."""
    if x.dtype == torch.float64 and x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def rdiv(a: float, t):
    """a / t as one division: PyTorch computes `float / tensor` as
    reciprocal(t) x a, which rounds twice."""
    return torch.full_like(t, a) / t


def conic_sag(r2, c, kappa):
    """Sag of a conic: z = c r^2 / (1 + sqrt(1 - (1+kappa) c^2 r^2))."""
    arg = 1.0 - (1.0 + kappa) * c * c * r2
    return c * r2 / (1.0 + sqrt(torch.clamp(arg, min=1e-12)))


def conic_sag_slope(r2, c, kappa):
    """d(sag)/d(r^2)."""
    arg = torch.clamp(1.0 - (1.0 + kappa) * c * c * r2, min=1e-12)
    s = sqrt(arg)
    # d/dr2 [c r2 / (1+s)] = c/(1+s) + c r2 * (c^2 (1+kappa)/2) / (s (1+s)^2)
    return rdiv(c, 1.0 + s) + c * r2 * (c * c * (1.0 + kappa) * 0.5) \
        / (s * (1.0 + s) ** 2)


def surface_sag(x, y, c, kappa, coefs):
    """Conic + even-polynomial asphere: sag(r) = conic + sum a_i
    r^(4+2i); coefs: (a0, a1, ...) floats, empty for a pure conic."""
    r2 = x * x + y * y
    z = conic_sag(r2, c, kappa)
    if len(coefs):
        # Horner in r^2, overall factor r^4
        acc = 0.0
        for a in reversed(coefs):
            acc = acc * r2 + a
        z = z + r2 * r2 * acc
    return z


def surface_normal(x, y, c, kappa, coefs):
    """+z-facing unit normal of z = sag(x, y) (conic + even-polynomial
    asphere sum a_i r^(4+2i)); reflection and refraction are insensitive
    to its overall sign."""
    r2 = x * x + y * y
    dzdr2 = conic_sag_slope(r2, c, kappa)
    if len(coefs):
        dacc = 0.0
        # d/dr2 [r^4 * P(r2)] where P = sum a_i r2^i
        for i, a in reversed(list(enumerate(coefs))):
            dacc = dacc * r2 + a * (i + 2)
        dzdr2 = dzdr2 + r2 * dacc
    dzdx = 2.0 * x * dzdr2
    dzdy = 2.0 * y * dzdr2
    inv = rdiv(1.0, sqrt(1.0 + dzdx * dzdx + dzdy * dzdy))
    return -dzdx * inv, -dzdy * inv, inv


def _conic_F(px, py, pz, vx, vy, vz, c, kappa, coefs, t):
    """F(t) = z(t) - sag(r2(t)) and dF/dt along the ray."""
    x = px + t * vx
    y = py + t * vy
    z = pz + t * vz
    r2 = x * x + y * y
    s = conic_sag(r2, c, kappa)
    ds = conic_sag_slope(r2, c, kappa)
    if len(coefs):
        acc = 0.0
        dacc = 0.0
        for i, a in reversed(list(enumerate(coefs))):
            acc = acc * r2 + a
            dacc = dacc * r2 + a * (i + 2)
        s = s + r2 * r2 * acc
        ds = ds + r2 * dacc
    dr2dt = 2.0 * (x * vx + y * vy)
    return z - s, vz - ds * dr2dt


def intersect(px, py, pz, vx, vy, vz, c, kappa, coefs):
    """Propagate rays (p, v) to the surface z = sag(x, y) (local frame).

    The conic is solved in closed form, as the near-vertex root of the
    quadric c(x^2+y^2) + c(1+kappa)z^2 - 2z = 0 anchored at the ray's
    z = 0 plane hit (a stable root pair), then polished by Newton steps:
    NEWTON_POLISH, +2 when `coefs` (the asphere terms) are given.
    Returns (x, y, z, t, F): the hit, the path length (|v| = 1) and the
    last step's residual (the trace vignettes on |F| > 1e-5)."""
    k1 = 1.0 + kappa
    t0 = -pz / vz
    x0 = px + t0 * vx
    y0 = py + t0 * vy
    A = c * (vx * vx + vy * vy + k1 * vz * vz)
    B = 2.0 * c * (x0 * vx + y0 * vy) - 2.0 * vz
    C = c * (x0 * x0 + y0 * y0)
    disc = torch.clamp(B * B - 4.0 * A * C, min=0.0)
    sq = sqrt(disc)
    sgn = torch.where(B >= 0.0, 1.0, -1.0)
    q = -0.5 * (B + sgn * sq)
    eps = 1e-30
    s_a = q / torch.where(torch.abs(A) < eps, eps, A)
    s_b = C / torch.where(torch.abs(q) < eps, eps, q)
    # the near-vertex branch is the root nearer the plane point
    t = t0 + torch.where(torch.abs(s_a) < torch.abs(s_b), s_a, s_b)
    n_iter = NEWTON_POLISH + (2 if len(coefs) else 0)
    F = None
    for _ in range(n_iter):
        F, dF = _conic_F(px, py, pz, vx, vy, vz, c, kappa, coefs, t)
        t = t - F / dF
    x = px + t * vx
    y = py + t * vy
    z = pz + t * vz
    return x, y, z, t, F


def reflect(vx, vy, vz, nx, ny, nz):
    """v' = v - 2 (v.n) n for unit normal n."""
    d = vx * nx + vy * ny + vz * nz
    return vx - 2 * d * nx, vy - 2 * d * ny, vz - 2 * d * nz


def refract(vx, vy, vz, nx, ny, nz, n1_over_n2):
    """Snell refraction of unit vector v at unit normal n, in the vector
    form v' = eta v + (eta c1 - c2) n with c1 = -v.n (normal oriented
    against v), c2 = sqrt(1 - eta^2 (1 - c1^2)); total internal
    reflection is clamped."""
    eta = n1_over_n2
    d = vx * nx + vy * ny + vz * nz
    # orient the normal against the ray
    sign = torch.where(d > 0, -1.0, 1.0)
    nx, ny, nz, d = nx * sign, ny * sign, nz * sign, d * sign
    c1 = -d
    c2sq = 1.0 - eta * eta * (1.0 - c1 * c1)
    c2 = sqrt(torch.clamp(c2sq, min=1e-12))
    k = eta * c1 - c2
    return eta * vx + k * nx, eta * vy + k * ny, eta * vz + k * nz


def silica_index(wavelength_nm):
    """Fused-silica refractive index (Malitson 1965 Sellmeier)."""
    w2 = (wavelength_nm * 1e-3) ** 2  # microns^2
    n2 = (1.0
          + 0.6961663 * w2 / (w2 - 0.0684043**2)
          + 0.4079426 * w2 / (w2 - 0.1162414**2)
          + 0.8974794 * w2 / (w2 - 9.896161**2))
    return sqrt(n2)


def air_index_excess(wavelength_nm, pressure_kpa=69.33,
                     temperature_k=293.15, h2o_pressure_kpa=1.0):
    """n_air - 1 (Edlen-style formula, GalSim's DCR parametrization),
    returned as the excess so float32 never computes (1 + 2.7e-4) - 1.
    `wavelength_nm` is a tensor, or a float for the host's float64
    refraction coefficients (optics.astrometry)."""
    sigma2 = (1000.0 / wavelength_nm) ** 2  # 1/um^2
    # dry air at 15C, 101.325 kPa
    n_m1e6 = 64.328 + 29498.1 / (146.0 - sigma2) + 255.4 / (41.0 - sigma2)
    p_mbar = pressure_kpa * 10.0
    t_c = temperature_k - 273.15
    n_m1e6 = n_m1e6 * p_mbar * (1.0 + (1.049 - 0.0157 * t_c) * 1e-6 * p_mbar) \
        / (720.883 * (1.0 + 0.003661 * t_c))
    w_mbar = h2o_pressure_kpa * 10.0
    n_m1e6 = n_m1e6 - ((0.0624 - 0.000680 * sigma2)
                       / (1.0 + 0.003661 * t_c)) * w_mbar
    return 1e-6 * n_m1e6


def air_index(wavelength_nm, pressure_kpa=69.33, temperature_k=293.15,
              h2o_pressure_kpa=1.0):
    """n_air (1 + air_index_excess)."""
    return 1.0 + air_index_excess(wavelength_nm, pressure_kpa,
                                  temperature_k, h2o_pressure_kpa)
