"""Profile samplers (imsim_tpu/photons/profiles.py counterpart).

The Sersic and exponential-disk inverse-CDF fits are built on the host
by the JAX package (profiles.sersic_poly2d, exp_disk_poly, PolyCDF.fit)
and cross as numpy data.  The radial inverse CDFs of the analytic PSF
(`radial_cdf_from_mtf`, `kolmogorov_cdf`) are host numpy/scipy copies of
the JAX package's, held bit-equal to them by the tests.  The samplers run
on the device."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from scipy import special

from ..utils import rng
from ..utils.lookup import PolyCDF, UniformTable

# ---- host: radial inverse CDFs from an MTF --------------------------------


def _enclosed_flux_from_mtf(T, k, r):
    """F(r) = r * int T(k) J1(k r) dk, trapezoid on the k grid, clipped
    to [0, 1] and made monotone, normalised to F(r_max) = 1."""
    kr = np.outer(r, k)
    integrand = T[None, :] * special.j1(kr)
    F = r * np.trapezoid(integrand, k, axis=1)
    F = np.maximum.accumulate(np.clip(F, 0.0, 1.0))
    return F / F[-1]


def radial_cdf_from_mtf(T_func, r_max, n_r=1024, n_k=4096, k_max=None,
                        n_table=2048) -> UniformTable:
    """Inverse-CDF table u -> r (numpy float32 y) of an isotropic
    profile with MTF T(k); r and k in consistent units."""
    if k_max is None:
        k_max = 400.0 / r_max * 50.0
    k = np.linspace(1e-8, k_max, n_k)
    T = T_func(k)
    r = np.linspace(1e-6, r_max, n_r)
    F = _enclosed_flux_from_mtf(T, k, r)
    u = np.linspace(0.0, 1.0, n_table)
    eps = np.arange(len(F)) * 1e-14
    ri = np.interp(u, F + eps, r)
    return UniformTable(0.0, 1.0 / (n_table - 1), np.asarray(ri, np.float32))


@functools.lru_cache(maxsize=8)
def kolmogorov_cdf(n_table: int = 2048) -> UniformTable:
    """Inverse CDF of a Kolmogorov profile with FWHM 1:
    T(kappa) = exp[-3.44 (0.9758834 kappa / 2 pi)^(5/3)]."""
    c = 3.44 * (1.0 / (2 * np.pi * 0.9758834)) ** (5.0 / 3.0)

    def T(k):
        return np.exp(-c * k ** (5.0 / 3.0))

    return radial_cdf_from_mtf(T, r_max=25.0, k_max=60.0, n_table=n_table)


@dataclasses.dataclass(frozen=True)
class SersicPoly:
    """2-D Chebyshev inverse CDF x = r/Re of the Sersic family: u-series
    coefficients that are themselves Chebyshev series in the index n
    (imsim_tpu.photons.profiles.sersic_poly2d)."""

    D_core: np.ndarray   # (d_core+1, d_n+1) float32
    D_tail: np.ndarray   # (d_tail+1, d_n+1) float32
    n_lo: float
    n_hi: float
    u_split: float
    s_lo: float
    s_hi: float


@dataclasses.dataclass(frozen=True)
class ProfileTables:
    """The samplers the intrinsic-profile stage needs."""

    sersic: SersicPoly
    exp_disk: PolyCDF


def sample_sersic_poly(u, srs_n, tab: SersicPoly):
    """x = r/Re from (u, n) via the 2-D Chebyshev inverse CDF."""
    xn = torch.clamp(2 * (srs_n - tab.n_lo) / (tab.n_hi - tab.n_lo) - 1,
                     -1.0, 1.0)
    K = tab.D_core.shape[1]
    T = [torch.ones_like(xn), xn]
    for _ in range(K - 2):
        T.append(2 * xn * T[-1] - T[-2])
    T = T[:K]

    def coef(D, j):
        row = [float(v) for v in D[j]]
        acc = row[0] * T[0]
        for k in range(1, K):
            acc = acc + row[k] * T[k]
        return acc

    def clenshaw(D, z):
        b1 = torch.zeros_like(z)
        b2 = torch.zeros_like(z)
        for j in range(D.shape[0] - 1, 0, -1):
            b1, b2 = coef(D, j) + 2 * z * b1 - b2, b1
        return coef(D, 0) + z * b1 - b2

    u = torch.clamp(u, 0.0, 1.0 - 1e-7)
    z_core = torch.clamp(2.0 * torch.sqrt(u / tab.u_split) - 1.0, -1.0, 1.0)
    r_core = clenshaw(tab.D_core, z_core)
    s = -torch.log1p(-u)
    z_tail = torch.clamp(2.0 * (s - tab.s_lo) / (tab.s_hi - tab.s_lo) - 1.0,
                         -1.0, 1.0)
    r_tail = torch.exp(clenshaw(tab.D_tail, z_tail))
    return torch.where(u < tab.u_split, torch.clamp(r_core, min=0.0), r_tail)


def sample_radial(gen, n: int, table):
    """n photons from an isotropic profile with inverse CDF `table`:
    returns (dx, dy) in the table's units."""
    return radial_offsets(table, rng.uniform(gen, n),
                          rng.uniform(gen, n, 0.0, 2 * np.pi))


def radial_offsets(table, u, theta):
    """sample_radial's pure step: radius table(u) at angle theta."""
    r = table(u)
    return r * torch.cos(theta), r * torch.sin(theta)


def sample_gaussian(gen, n: int, sigma: float):
    """n offsets from a circular Gaussian of standard deviation sigma."""
    return sigma * rng.normal(gen, n), sigma * rng.normal(gen, n)


def apply_ellipse(dx, dy, q, beta):
    """Circular profile -> axis ratio q at position angle beta, area
    preserving."""
    sq = torch.sqrt(q)
    ex = dx / sq
    ey = dy * sq
    c, s = torch.cos(beta), torch.sin(beta)
    return c * ex - s * ey, s * ex + c * ey


def apply_shear_mag(dx, dy, g1, g2, mu):
    """Weak-lensing transform (GSObject.lens(g1, g2, mu) semantics)."""
    gsq = g1**2 + g2**2
    norm = torch.sqrt(torch.abs(mu)) / torch.sqrt(
        torch.clamp(1.0 - gsq, min=1e-12))
    return (norm * ((1 + g1) * dx + g2 * dy),
            norm * (g2 * dx + (1 - g1) * dy))
