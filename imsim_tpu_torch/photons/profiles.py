"""Profile samplers (imsim_tpu/photons/profiles.py counterpart).

Host half (numpy/scipy copies of the JAX package's, held bit-equal to
them by the tests; cached as numpy, never as a device tensor): the
radial inverse CDFs (`radial_cdf_from_mtf`, `kolmogorov_cdf`,
`vonkarman_cdf`, `airy_cdf`, `second_kick_cdf`), the Sersic grid and its
2-D Chebyshev fit (`sersic_cdf_grid`, `sersic_poly2d`) and the
exponential disk's PolyCDF (`exp_disk_poly`).  The samplers run on the
device."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from scipy import special

from ..psf.atmosphere import vonkarman_phase_spectrum, vonkarman_structure
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


@functools.lru_cache(maxsize=64)
def vonkarman_cdf(lam_nm: float, r0_m: float, L0_m: float = 25.0,
                  n_table: int = 2048) -> UniformTable:
    """Inverse CDF (arcsec) of a von Karman atmospheric PSF."""
    lam = lam_nm * 1e-9
    rho = np.geomspace(1e-4, 30.0, 512)  # meters
    D = vonkarman_structure(rho, r0_m, L0_m)
    arcsec = np.pi / 180.0 / 3600.0

    # T(k_angular) = exp(-D(lambda k / 2 pi)/2), k in rad^-1
    def T(k_arcsec):
        k_rad = k_arcsec / arcsec
        return np.exp(-0.5 * np.interp(lam * k_rad / (2 * np.pi), rho, D,
                                       left=0.0))

    fwhm_kolm = 0.9758834 * lam / r0_m / arcsec
    return radial_cdf_from_mtf(T, r_max=25.0 * fwhm_kolm,
                               k_max=60.0 / fwhm_kolm, n_table=n_table)


def annulus_mtf(lam: float, diam_m: float, obscuration: float):
    """Radial profile of an annular pupil's normalized autocorrelation:
    (nu_axis [cycles/rad], T) on 2 * 256 + 1 bins."""
    n = 512
    x = np.linspace(-1, 1, n)
    X, Y = np.meshgrid(x, x)
    R = np.hypot(X, Y)
    pupil = ((R <= 1.0) & (R >= obscuration)).astype(float)
    P = np.fft.rfft2(pupil)
    ac = np.fft.fftshift(np.fft.irfft2(np.abs(P) ** 2, s=pupil.shape))
    ac /= ac.max()
    cy = n // 2
    prof_r = np.hypot(*np.meshgrid(np.arange(n) - cy, np.arange(n) - cy))
    nbin = 256
    idx = np.minimum((prof_r / (n / 2) * nbin).astype(int), nbin * 2)
    Tr = np.bincount(idx.ravel(), ac.ravel(), minlength=nbin * 2 + 1)
    Tc = np.bincount(idx.ravel(), minlength=nbin * 2 + 1)
    Tr = Tr / np.maximum(Tc, 1)
    return np.arange(nbin * 2 + 1) / (2 * nbin) * (diam_m / lam), Tr


@functools.lru_cache(maxsize=64)
def airy_cdf(lam_nm: float, diam_m: float = 8.36, obscuration: float = 0.612,
             n_table: int = 2048) -> UniformTable:
    """Inverse CDF (arcsec) of an obscured Airy PSF."""
    lam = lam_nm * 1e-9
    arcsec = np.pi / 180.0 / 3600.0
    nu_axis, Tr = annulus_mtf(lam, diam_m, obscuration)

    def T(k_arcsec):
        # k is angular frequency [rad/arcsec]: nu = k / (2 pi)
        return np.interp((k_arcsec / arcsec) / (2 * np.pi), nu_axis, Tr,
                         right=0.0)

    lam_over_D = lam / diam_m / arcsec  # arcsec
    return radial_cdf_from_mtf(T, r_max=80.0 * lam_over_D,
                               k_max=2 * np.pi * 1.05 / lam_over_D,
                               n_table=n_table)


@functools.lru_cache(maxsize=64)
def second_kick_cdf(lam_nm: float, r0_m: float, diam_m: float = 8.36,
                    obscuration: float = 0.612, kcrit: float = 0.2,
                    L0_m: float = 25.0, n_table: int = 2048) -> UniformTable:
    """Inverse CDF (arcsec) of the atmospheric second kick: the obscured
    Airy diffraction times the high-k tail of the von Karman turbulence
    that the phase screens do not carry (split at kcrit / r0 [rad/m]):
    T_2k(k) = T_airy(k) exp(-[D_full(rho) - D_lowk(rho)] / 2)."""
    lam = lam_nm * 1e-9
    arcsec = np.pi / 180.0 / 3600.0
    kc = kcrit / r0_m

    kgrid = np.geomspace(1e-4, 1e4, 4096)
    Phi = vonkarman_phase_spectrum(kgrid, r0_m, L0_m)
    hi = kgrid >= kc
    rho = np.geomspace(1e-5, 30.0, 512)
    J = special.j0(np.outer(rho, kgrid))
    D_hi = 2.0 * np.trapezoid(
        (1.0 - J[:, hi]) * (Phi[hi] * kgrid[hi])[None, :], kgrid[hi], axis=1)
    nu_axis, Tr = annulus_mtf(lam, diam_m, obscuration)

    def T(k_arcsec):
        k_rad = k_arcsec / arcsec
        t_airy = np.interp(k_rad / (2 * np.pi), nu_axis, Tr, right=0.0)
        d_hi = np.interp(lam * k_rad / (2 * np.pi), rho, D_hi, left=0.0)
        return t_airy * np.exp(-0.5 * d_hi)

    lam_over_D = lam / diam_m / arcsec
    r_max = max(80.0 * lam_over_D, 3.0 * 0.9758834 * lam / r0_m / arcsec)
    return radial_cdf_from_mtf(T, r_max=r_max,
                               k_max=2 * np.pi * 1.05 / lam_over_D,
                               n_table=n_table)


# ---- host: the Sersic family ----------------------------------------------

SERSIC_N_GRID = np.linspace(0.3, 6.3, 61)


def _sersic_b(n):
    """Solve gammainc(2n, b) = 0.5 (half-light radius definition)."""
    return special.gammaincinv(2 * n, 0.5)


@functools.lru_cache(maxsize=4)
def sersic_cdf_grid(n_u: int = 1024) -> np.ndarray:
    """(len(SERSIC_N_GRID), n_u) float32 table of x = r/Re as a function
    of (n, u): the inverse of F(x) = gammainc(2n, b x^(1/n)), u capped
    at the 0.9999 quantile."""
    grid = np.empty((len(SERSIC_N_GRID), n_u), np.float32)
    u = np.linspace(0.0, 0.9999, n_u)
    for i, n in enumerate(SERSIC_N_GRID):
        b = _sersic_b(n)
        g = special.gammaincinv(2 * n, u)
        grid[i] = (g / b) ** n
    return grid


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


@functools.lru_cache(maxsize=2)
def sersic_poly2d(d_core=16, d_tail=10, d_n=10, u_split=0.85,
                  u_max=0.9999) -> SersicPoly:
    """The 2-D inverse CDF of the Sersic family: x(u, n) as
    Chebyshev-in-u (the PolyCDF core/tail split) whose coefficients are
    Chebyshev series in the index n over SERSIC_N_GRID (the JAX
    package's sersic_poly2d, returned as a SersicPoly)."""
    import numpy.polynomial.chebyshev as C

    n_lo, n_hi = float(SERSIC_N_GRID[0]), float(SERSIC_N_GRID[-1])
    s_lo = -np.log1p(-u_split)
    s_hi = -np.log1p(-u_max)
    x = np.linspace(-1, 1, 2048)
    u_core = u_split * ((x + 1) / 2) ** 2
    t = np.linspace(-1, 1, 2048)
    s = s_lo + (t + 1) / 2 * (s_hi - s_lo)
    u_tail = -np.expm1(-s)
    cores = []
    tails = []
    for n in SERSIC_N_GRID:
        b = _sersic_b(n)
        r_core = (special.gammaincinv(2 * n, u_core) / b) ** n
        r_tail = (special.gammaincinv(2 * n, u_tail) / b) ** n
        cores.append(C.chebfit(x, r_core, d_core))
        tails.append(C.chebfit(t, np.log(np.maximum(r_tail, 1e-12)),
                               d_tail))
    xn = 2 * (np.asarray(SERSIC_N_GRID) - n_lo) / (n_hi - n_lo) - 1
    D_core = np.stack([C.chebfit(xn, np.array(cores)[:, j], d_n)
                       for j in range(d_core + 1)])
    D_tail = np.stack([C.chebfit(xn, np.array(tails)[:, j], d_n)
                       for j in range(d_tail + 1)])
    return SersicPoly(D_core.astype(np.float32), D_tail.astype(np.float32),
                      n_lo, n_hi, float(u_split), float(s_lo), float(s_hi))


@functools.lru_cache(maxsize=2)
def exp_disk_poly() -> PolyCDF:
    """Inverse CDF of the exponential disk (Sersic n = 1): the PolyCDF
    fit of the n = 1 row of the Sersic grid."""
    grid = sersic_cdf_grid()
    row = int(round((1.0 - SERSIC_N_GRID[0])
                    / (SERSIC_N_GRID[1] - SERSIC_N_GRID[0])))
    tab = UniformTable(0.0, 0.9999 / (grid.shape[1] - 1),
                       np.asarray(grid[row]))
    poly, err = PolyCDF.fit(tab)
    if not err < 0.35:
        raise ValueError(f"exponential-disk fit error {err}")
    return poly


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


def sample_double_gaussian(gen, n: int, fwhm1: float, fwhm2: float,
                           wgt1: float, draws=None):
    """(dx, dy) from a two-component Gaussian mixture (the fallback PSF
    family DoubleGaussianPSF).  draws: (u (n,), xy (n, 2)) uniform and
    standard normal draws (default: from `gen`)."""
    if draws is None:
        draws = (rng.uniform(gen, n),
                 torch.randn((n, 2), generator=gen, device=gen.device,
                             dtype=torch.float32))
    u, xy = draws
    s1 = fwhm1 / 2.3548200450309493
    s2 = fwhm2 / 2.3548200450309493
    s = torch.where(u < wgt1, torch.full_like(u, s1),
                    torch.full_like(u, s2))
    return s * xy[:, 0], s * xy[:, 1]


def sample_sersic(gen, n: int, sersic_n, hlr, grid=None, draws=None):
    """(dx, dy) from a circular Sersic profile by bilinear interpolation
    of the (n, u) grid of sersic_cdf_grid; sersic_n and hlr may be
    per-photon tensors.  draws: (u, theta_u) uniform draws in [0, 1)
    (default: from `gen`)."""
    dev = gen.device if draws is None else draws[0].device
    if grid is None:
        grid = torch.as_tensor(sersic_cdf_grid(), device=dev)
    if draws is None:
        draws = (rng.uniform(gen, n), rng.uniform(gen, n))
    u, tu = draws
    n_u = grid.shape[1]
    fn = (torch.as_tensor(sersic_n, dtype=torch.float32, device=dev)
          - SERSIC_N_GRID[0]) / (SERSIC_N_GRID[1] - SERSIC_N_GRID[0])
    fn = torch.clamp(fn, 0.0, len(SERSIC_N_GRID) - 1.000001)
    i0 = torch.floor(fn).to(torch.int64)
    wn = fn - i0
    fu = u * (n_u - 1.000001)
    j0 = torch.floor(fu).to(torch.int64)
    wu = fu - j0
    i0 = i0.expand_as(j0) if i0.dim() == 0 else i0
    x = (grid[i0, j0] * (1 - wn) * (1 - wu) + grid[i0, j0 + 1] * (1 - wn) * wu
         + grid[i0 + 1, j0] * wn * (1 - wu) + grid[i0 + 1, j0 + 1] * wn * wu)
    r = x * hlr
    theta = tu * (2 * np.pi)
    return r * torch.cos(theta), r * torch.sin(theta)
