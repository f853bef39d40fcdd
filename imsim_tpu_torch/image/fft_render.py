"""FFT rendering of bright objects (imsim_tpu/image/fft_render.py
counterpart): the FFT branch of the pooled CCD render.

Host half (numpy/scipy, copied so the tables come out bit for bit the
same as the JAX package's): the radial MTF tables of the Sersic, von
Karman, obscured-Airy and Gaussian profiles, the peak-surface-brightness
trigger, the stamp sizing from the enclosed-flux curve, and the
Chebyshev fit of the PSF MTF.

Device half (plain PyTorch with torch.fft; the JAX package computes it
with XLA and jnp.fft, outside any Pallas kernel):

  * `render_fft_stamps`: a batch of same-size stamps from radial MTF
    tables (galaxies: PSF MTF x the galaxy's unit-hlr MTF under its
    lensing matrix), one batched irfft2;
  * `add_stamps`: slice adds of a bucket's stamps into a padded frame;
  * `star_frame` / `star_field` / `star_field_pass`: every FFT-mode star
    of a CCD in one Fourier synthesis.  All stars share the PSF MTF T(k)
    and a position is a separable phase ramp, so the field's transform
    is T (*) (Py^T @ (flux * Px)), one complex matmul, and the field one
    padded irfft2.  `star_field` is the noiseless part (synthesis, clip,
    spike overlay, Parseval `realized`); `star_field_pass` adds the
    Poisson draw and the image.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from scipy import special

from ..psf.atmosphere import vonkarman_structure
from ..utils.lookup import UniformTable, clenshaw_const

STAMP_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)


# ---- host: radial MTF tables ----------------------------------------------

@functools.lru_cache(maxsize=32)
def sersic_mtf_table(n_sersic: float, n_k: int = 1024, k_max: float = 120.0):
    """T(k) of a circular Sersic profile with half-light radius 1:
    Hankel transform T(k) = int 2 pi r I(r) J0(k r) dr / flux."""
    b = special.gammaincinv(2 * n_sersic, 0.5)
    r = np.geomspace(1e-4, 50.0, 2048)
    I = np.exp(-b * (r ** (1.0 / n_sersic) - 1.0))
    w = 2 * np.pi * r * I
    k = np.linspace(0.0, k_max, n_k)
    J = special.j0(np.outer(k, r))
    T = np.trapezoid(J * w[None, :], r, axis=1)
    T /= T[0]
    return UniformTable(0.0, k_max / (n_k - 1), T.astype(np.float32))


@functools.lru_cache(maxsize=32)
def vonkarman_mtf_table(lam_nm: float, r0_m: float, L0_m: float = 25.0,
                        n_k: int = 1024):
    """T(k) of the von Karman seeing profile; k in rad/arcsec."""
    arcsec = np.pi / 180 / 3600
    lam = lam_nm * 1e-9
    rho = np.geomspace(1e-4, 30.0, 512)
    D = vonkarman_structure(rho, r0_m, L0_m)
    fwhm = 0.9758834 * lam / r0_m / arcsec
    k = np.linspace(0.0, 60.0 / fwhm, n_k)
    rr = lam * (k / arcsec) / (2 * np.pi)
    T = np.exp(-0.5 * np.interp(rr, rho, D, left=0.0))
    return UniformTable(0.0, k[-1] / (n_k - 1), T.astype(np.float32))


@functools.lru_cache(maxsize=32)
def airy_mtf_table(lam_nm: float, diam_m: float = 8.36,
                   obscuration: float = 0.612, n_k: int = 1024):
    """Annular-pupil MTF; k in rad/arcsec."""
    arcsec = np.pi / 180 / 3600
    lam = lam_nm * 1e-9
    n = 512
    x = np.linspace(-1, 1, n)
    X, Y = np.meshgrid(x, x)
    R = np.hypot(X, Y)
    pupil = ((R <= 1.0) & (R >= obscuration)).astype(float)
    ac = np.fft.fftshift(np.fft.irfft2(
        np.abs(np.fft.rfft2(pupil)) ** 2, s=pupil.shape))
    ac /= ac.max()
    cy = n // 2
    prof_r = np.hypot(*np.meshgrid(np.arange(n) - cy, np.arange(n) - cy))
    nbin = 256
    idx = np.minimum((prof_r / (n / 2) * nbin).astype(int), 2 * nbin)
    Tr = np.bincount(idx.ravel(), ac.ravel(), minlength=2 * nbin + 1) \
        / np.maximum(np.bincount(idx.ravel(), minlength=2 * nbin + 1), 1)
    nu = np.arange(2 * nbin + 1) / (2 * nbin) * (diam_m / lam)
    k_cut = 2 * np.pi * (diam_m / lam) * arcsec
    k = np.linspace(0.0, 1.05 * k_cut, n_k)
    T = np.interp((k / arcsec) / (2 * np.pi), nu, Tr, right=0.0)
    return UniformTable(0.0, k[-1] / (n_k - 1), T.astype(np.float32))


def _grid(t: UniformTable) -> np.ndarray:
    return t.x0 + np.arange(len(t.y)) * t.dx


def psf_mtf_table(lam_nm: float, r0_500: float, L0: float = 25.0,
                  gauss_fwhm: float = 0.3, n_k: int = 2048):
    """Combined analytic-PSF MTF: von Karman x Airy x Gaussian."""
    r0 = r0_500 * (lam_nm / 500.0) ** 1.2
    vk = vonkarman_mtf_table(lam_nm, r0, L0)
    ai = airy_mtf_table(lam_nm)
    sig = gauss_fwhm / 2.3548200450309493
    k_max = vk.x_max
    k = np.linspace(0.0, k_max, n_k)
    T = (np.interp(k, _grid(vk), np.asarray(vk.y))
         * np.interp(k, _grid(ai), np.asarray(ai.y), right=0.0)
         * np.exp(-0.5 * (sig * k) ** 2))
    return UniformTable(0.0, k_max / (n_k - 1), T.astype(np.float32))


def combined_mtf_table(psf_table: UniformTable, gal_table=None,
                       gal_scale=1.0, n_k: int = 2048):
    """PSF (x) galaxy: multiply MTFs; galaxy k-axis scaled by its hlr."""
    k = np.linspace(0.0, psf_table.x_max, n_k)
    T = np.interp(k, _grid(psf_table), np.asarray(psf_table.y), right=0.0)
    if gal_table is not None:
        kg = k * gal_scale
        T = T * np.interp(kg, _grid(gal_table), np.asarray(gal_table.y),
                          right=0.0)
    return UniformTable(0.0, psf_table.x_max / (n_k - 1),
                        T.astype(np.float32))


def peak_surface_brightness(flux, mtf: UniformTable, pixel_scale=0.2):
    """Predicted peak pixel value [e-]: flux/(2 pi) int T(k) k dk x px^2."""
    k = _grid(mtf)
    central = np.trapezoid(np.asarray(mtf.y) * k, k) / (2 * np.pi)
    return flux * central * pixel_scale**2


def galaxy_peak_factor(psf_mtf: UniformTable, n_sersic: float,
                       hlr_as: float) -> float:
    """Peak-SB suppression of a circular Sersic(n, hlr) convolved with
    the PSF, relative to the PSF alone:
    int T_psf T_gal k dk / int T_psf k dk."""
    k = _grid(psf_mtf)
    Tp = np.asarray(psf_mtf.y, float)
    gt = sersic_mtf_table(round(float(n_sersic), 1))
    Tg = np.interp(k * max(hlr_as, 1e-4), _grid(gt),
                   np.asarray(gt.y, float), right=0.0)
    denom = np.trapezoid(Tp * k, k)
    return float(np.trapezoid(Tp * Tg * k, k) / max(denom, 1e-30))


def lens_matrix(q, beta, g1, g2, mu, hlr=1.0):
    """Real-space 2x2 transform of a unit-hlr circular profile draw,
    A = hlr * Shear(g1, g2, mu) @ Ellipse(q, beta), the photon path's
    composition; in k-space the profile's MTF factor is T0(|A^T k|).
    Vectorized over trailing array args; returns (..., 2, 2)."""
    q, beta, g1, g2, mu, hlr = np.broadcast_arrays(
        *[np.asarray(a, float) for a in (q, beta, g1, g2, mu, hlr)])
    sq = np.sqrt(q)
    c, s = np.cos(beta), np.sin(beta)
    E = np.stack([np.stack([c / sq, -s * sq], -1),
                  np.stack([s / sq, c * sq], -1)], -2)
    gsq = g1 * g1 + g2 * g2
    norm = np.sqrt(np.abs(mu)) / np.sqrt(np.maximum(1.0 - gsq, 1e-12))
    S = np.stack([np.stack([norm * (1 + g1), norm * g2], -1),
                  np.stack([norm * g2, norm * (1 - g1)], -1)], -2)
    return hlr[..., None, None] * (S @ E)


_ENCLOSED_CACHE: dict = {}


def _enclosed_flux_curve(mtf: UniformTable, pixel_scale: float,
                         n_grid: int = 2048, oversize: float = 2.0):
    """E(r): cumulative enclosed flux of the profile defined by the
    radial MTF, from one host irfft2 of the table on an n_grid^2 grid at
    `oversize x pixel_scale` sampling; cached per table content."""
    key = (float(mtf.x0), float(mtf.dx), len(mtf.y), float(pixel_scale),
           hash(np.asarray(mtf.y).tobytes()))
    hit = _ENCLOSED_CACHE.get(key)
    if hit is not None:
        return hit
    d = pixel_scale * oversize
    ky = np.fft.fftfreq(n_grid, d=d) * 2 * np.pi
    kx = np.fft.rfftfreq(n_grid, d=d) * 2 * np.pi
    KY, KX = np.meshgrid(ky, kx, indexing="ij")
    kr = np.hypot(KX, KY)
    y = np.asarray(mtf.y, np.float64)
    T = np.interp(kr, mtf.x0 + np.arange(len(y)) * mtf.dx, y, right=0.0)
    img = np.fft.irfft2(T, s=(n_grid, n_grid))
    img = np.roll(img, (n_grid // 2, n_grid // 2), axis=(0, 1))
    c = n_grid // 2
    yy, xx = np.mgrid[:n_grid, :n_grid]
    rr = np.hypot(xx - c, yy - c).ravel()
    order = np.argsort(rr)
    cum = np.cumsum(np.maximum(img.ravel()[order], 0.0))
    cum /= cum[-1]
    r_as = rr[order] * d
    r_grid = np.geomspace(max(d, 1e-3), r_as[-1], 512)
    E = np.interp(r_grid, r_as, cum)
    _ENCLOSED_CACHE[key] = (r_grid, E)
    return r_grid, E


def stamp_bucket(flux, mtf: UniformTable, pixel_scale=0.2,
                 noise_var: float = 0.0, folding_threshold=5e-3, nmax=4096):
    """Bucketed stamp size from the profile's enclosed-flux radius: the
    folding threshold noise_var / flux floored to the nearest e-folding
    (never above 5e-3), then the radius enclosing 1 - threshold."""
    ft = noise_var / flux if (flux > 0 and noise_var > 0) else 0.0
    if ft >= folding_threshold or ft == 0:
        ft = folding_threshold
    else:
        ft = float(np.exp(np.floor(np.log(ft))))
    r_grid, E = _enclosed_flux_curve(mtf, pixel_scale)
    r_as = float(np.interp(1.0 - ft, E, r_grid))
    n = int(2 * r_as / pixel_scale)
    for b in STAMP_BUCKETS:
        if n <= b:
            return b
    return nmax


def good_fft_size(n: int) -> int:
    """Smallest 5-smooth integer >= n."""
    best = 1 << (n - 1).bit_length()
    p5 = 1
    while p5 < best:
        p3 = p5
        while p3 < best:
            p2 = p3
            while p2 < n:
                p2 *= 2
            best = min(best, p2)
            p3 *= 3
        p5 *= 5
    return best


_MTF_CHEB_CACHE: dict = {}


def mtf_cheb(mtf: UniformTable, deg: int = 96):
    """Chebyshev coefficients of the radial MTF over x = 2k/k_max - 1,
    the gather-free evaluator of full-frame k-grids.  Returns
    (coeffs float32 (deg+1,), k_max, max_abs_err)."""
    key = (float(mtf.x0), float(mtf.dx), len(mtf.y), deg,
           hash(np.asarray(mtf.y).tobytes()))
    hit = _MTF_CHEB_CACHE.get(key)
    if hit is not None:
        return hit
    import numpy.polynomial.chebyshev as C

    k_max = float(mtf.x_max)
    k = np.linspace(0.0, k_max, 8192)
    T = np.interp(k, mtf.x0 + np.arange(len(mtf.y)) * mtf.dx,
                  np.asarray(mtf.y, np.float64))
    x = 2.0 * k / k_max - 1.0
    c = C.chebfit(x, T, deg)
    err = float(np.abs(C.chebval(x, c) - T).max())
    out = (np.asarray(c, np.float32), k_max, err)
    _MTF_CHEB_CACHE[key] = out
    return out


# ---- device: stamps -------------------------------------------------------

def _interp_rows(Ty: torch.Tensor, fidx: torch.Tensor) -> torch.Tensor:
    """Per-row linear interpolation: Ty (B, K) at fractional indices
    fidx (B, ...), clamped to the table (the reference's clamped
    gather)."""
    B, K = Ty.shape
    fidx = torch.clamp(fidx, 0.0, K - 1.000001)
    i0 = torch.clamp(torch.floor(fidx).to(torch.int64), max=K - 2)
    w = fidx - i0
    flat = i0.reshape(B, -1)
    y0 = torch.gather(Ty, 1, flat).reshape(fidx.shape)
    y1 = torch.gather(Ty, 1, flat + 1).reshape(fidx.shape)
    return y0 * (1 - w) + y1 * w


def _kgrid(n: int, pixel_scale: float, device, half: bool) -> torch.Tensor:
    """Angular frequencies [rad/arcsec] of an n-point (r)fft axis, f32."""
    f = np.fft.rfftfreq(n, d=pixel_scale) if half \
        else np.fft.fftfreq(n, d=pixel_scale)
    return torch.as_tensor(f.astype(np.float32), device=device) \
        * np.float32(2.0 * np.pi)


def render_fft_stamps(mtf_y, mtf_dx, flux, q, beta, sub_dx, sub_dy, N: int,
                      pixel_scale: float = 0.2, gal_y=None, gal_dx=None,
                      gal_A=None) -> torch.Tensor:
    """Batch of B stamps (B, N, N) from radial MTF tables, on mtf_y's
    device.

    mtf_y: (B, K) radial T(k) per object (uniform k, step mtf_dx (B,));
    q, beta: ellipticity applied in k-space to the whole MTF;
    sub_dx/dy: subpixel centre offsets [pixels].  With (gal_y (B, Kg),
    gal_dx, gal_A (B, 2, 2)) each stamp is PSF x galaxy, the galaxy's
    unit-hlr MTF evaluated at |gal_A^T k|."""
    KY = _kgrid(N, pixel_scale, mtf_y.device, False)[:, None]
    KX = _kgrid(N, pixel_scale, mtf_y.device, True)[None, :]

    def per(v):
        return v[:, None, None]

    c, s = per(torch.cos(beta)), per(torch.sin(beta))
    kx_r = c * KX + s * KY
    ky_r = -s * KX + c * KY
    sq = per(torch.sqrt(q))
    kr = torch.hypot(kx_r * sq, ky_r / sq)
    T = _interp_rows(mtf_y, kr / per(mtf_dx))
    if gal_y is not None:
        A = gal_A
        kx_g = per(A[:, 0, 0]) * KX + per(A[:, 1, 0]) * KY
        ky_g = per(A[:, 0, 1]) * KX + per(A[:, 1, 1]) * KY
        T = T * _interp_rows(gal_y, torch.hypot(kx_g, ky_g) / gal_dx)
    ang = -((KX * per(sub_dx) + KY * per(sub_dy)) * pixel_scale)
    F = torch.complex(torch.cos(ang), torch.sin(ang)) * (T * per(flux))
    img = torch.fft.irfft2(F, s=(N, N), dim=(-2, -1))
    return torch.roll(img, (N // 2, N // 2), dims=(-2, -1))


def add_stamps(image: torch.Tensor, stamps: torch.Tensor, x0, y0):
    """Add a batch of same-size stamps (B, N, N) into the (H, W) image at
    integer corners (x0, y0) (host ints, pre-clamped to [-N, dim]),
    clipping at the edges: one slice add per stamp into a frame padded
    by N, then the crop."""
    N = stamps.shape[-1]
    H, W = image.shape
    padded = torch.nn.functional.pad(image, (N, N, N, N))
    for st, xx, yy in zip(stamps, np.asarray(x0).tolist(),
                          np.asarray(y0).tolist()):
        padded[yy + N:yy + 2 * N, xx + N:xx + 2 * N] += st
    return padded[N:N + H, N:N + W]


# ---- device: whole-frame star synthesis -----------------------------------

def _sep_phases(freqs: torch.Tensor, pos: torch.Tensor,
                Npad: int) -> torch.Tensor:
    """exp(-2 pi i freqs pos / Npad) for (B,) positions and (N,) signed
    integer frequencies, (B, N) complex64: each position splits into an
    integer part, whose phase freqs * int % Npad is exact in integer
    arithmetic (freqs * pos reaches ~3e7, past float32's 2^24), and a
    fraction."""
    fl = torch.floor(pos)
    pi_ = fl.to(torch.int64)
    fr = (pos - fl).to(torch.float32)
    ip = torch.remainder(freqs[None, :].to(torch.int64) * pi_[:, None], Npad)
    ang = np.float32(-2.0 * np.pi) * (
        ip.to(torch.float32) / Npad
        + freqs[None, :].to(torch.float32) * fr[:, None] / Npad)
    return torch.complex(torch.cos(ang), torch.sin(ang))


def star_frame(cheb, k_max: float, flux, x, y, Npad: int, H: int, W: int,
               pad: int, pixel_scale: float = 0.2):
    """The padded (Npad, Npad) field of all FFT-mode stars, negatives
    clipped, and each star's expected flux inside the visible frame
    (B,) by Parseval on the window transform.

    cheb/k_max: the PSF MTF as Chebyshev coefficients (mtf_cheb, host);
    flux, x, y (B,): float32 device tensors, positions in unpadded frame
    pixels; the frame sits at [pad, pad + H) x [pad, pad + W)."""
    dev = flux.device
    Nk = Npad // 2 + 1
    ky = _kgrid(Npad, pixel_scale, dev, False)
    kx = _kgrid(Npad, pixel_scale, dev, True)
    kr = torch.hypot(kx[None, :], ky[:, None])
    xg = torch.clamp(2.0 * kr / k_max - 1.0, -1.0, 1.0)
    # Clenshaw with host coefficients over the grid (the reference's
    # _cheb_grid)
    T = torch.where(kr <= k_max, clenshaw_const(cheb, xg), 0.0)
    del kr, xg

    fy = torch.remainder(torch.arange(Npad, device=dev) + Npad // 2,
                         Npad) - Npad // 2
    vx = torch.arange(Nk, device=dev)
    Py = _sep_phases(fy, y + pad, Npad)
    Px = _sep_phases(vx, x + pad, Npad)

    F = T * (Py.T @ (flux[:, None].to(torch.complex64) * Px))
    field = torch.clamp(torch.fft.irfft2(F, s=(Npad, Npad)), min=0.0)
    del F

    wy = torch.zeros(Npad, device=dev)
    wy[pad:pad + H] = 1.0
    wx = torch.zeros(Npad, device=dev)
    wx[pad:pad + W] = 1.0
    Wy = torch.conj(torch.fft.fft(wy))
    Wx = torch.conj(torch.fft.fft(wx))[:Nk]
    cv = torch.where((vx == 0) | (vx == Npad // 2), 1.0, 2.0)
    A = (Py * Wy[None, :]) @ T.to(torch.complex64)
    realized = flux * torch.real(
        torch.sum(A * Px * (Wx * cv)[None, :], dim=1)) / (Npad * Npad)
    return field, realized


def spike_crop(field: torch.Tensor, spike_kernel, sat_level: float, H: int,
               W: int, pad: int, margin: int = 0) -> torch.Tensor:
    """The visible (H, W) window of a padded star field; with a spike
    kernel, the saturation spike overlay runs first on a crop extended by
    `margin`, so off-frame saturated cores still throw spikes into the
    frame."""
    if spike_kernel is None:
        return field[pad:pad + H, pad:pad + W]
    from .diffraction_fft import apply_spikes

    m = margin
    ext = field[pad - m:pad + H + m, pad - m:pad + W + m]
    return apply_spikes(ext, spike_kernel, sat_level)[m:m + H, m:m + W]


def star_field(cheb, k_max, flux, x, y, spike_kernel, sat_level, Npad: int,
               H: int, W: int, pad: int, pixel_scale: float = 0.2,
               margin: int = 0):
    """The noiseless part of star_field_pass: (visible field (H, W),
    realized (B,))."""
    field, realized = star_frame(cheb, k_max, flux, x, y, Npad, H, W, pad,
                                 pixel_scale)
    return spike_crop(field, spike_kernel, sat_level, H, W, pad,
                      margin), realized


def star_field_pass(image, cheb, k_max, flux, x, y, spike_kernel,
                    sat_level, gen: torch.Generator, Npad: int, H: int,
                    W: int, pad: int, pixel_scale: float = 0.2,
                    margin: int = 0):
    """All FFT-mode stars of a CCD: Fourier synthesis -> clip ->
    saturation spike overlay -> Poisson (from `gen`) -> add to image.
    Returns (image + star field, realized (B,)): realized is each star's
    expected flux inside the visible frame (the fields merge, so photons
    are no longer attributable to stars)."""
    from ..utils.rng import poisson_approx

    vis, realized = star_field(cheb, k_max, flux, x, y, spike_kernel,
                               sat_level, Npad, H, W, pad, pixel_scale,
                               margin)
    return image + poisson_approx(gen, vis), realized
