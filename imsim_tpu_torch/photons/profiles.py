"""Device-side profile samplers (imsim_tpu/photons/profiles.py
counterpart).  The inverse-CDF fits are built on the host by the JAX
package (profiles.sersic_poly2d, exp_disk_poly, PolyCDF.fit) and cross
as numpy data; the port evaluates them."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import rng
from ..utils.lookup import PolyCDF


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
    r = table(rng.uniform(gen, n))
    theta = rng.uniform(gen, n, 0.0, 2 * np.pi)
    return r * torch.cos(theta), r * torch.sin(theta)


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
