"""Noll-indexed Zernike polynomials, values and Cartesian gradients
(imsim_tpu/utils/zernike.py counterpart, host numpy, the same code).

Used for the mirror-surface perturbations' slope textures
(optics.trace.build_zk_textures), the sag maps and the OPD output's
Zernike fits (optics.opd).

Implementation: each Z_j is expanded once into a dense xy-monomial
coefficient matrix C[p, q] (Z = sum C_pq x^p y^q), so values and exact
gradients are Horner evaluations — no trig, valid at r = 0.
"""
from __future__ import annotations

import functools

import numpy as np
from math import factorial


def noll_to_nm(j: int):
    """Noll index j >= 1 -> (n, m) with sign convention: m<0 = sin term."""
    n = 0
    j1 = j - 1
    while j1 >= n + 1:
        n += 1
        j1 -= n
    m = (-1) ** j * ((n % 2) + 2 * ((j1 + ((n + 1) % 2)) // 2))
    return n, m


@functools.lru_cache(maxsize=128)
def zernike_xy_coeffs(j: int) -> np.ndarray:
    """Dense (n+1, n+1) matrix C with Z_j(x, y) = sum C[p, q] x^p y^q,
    normalized to unit RMS over the unit disk (Noll convention)."""
    n, m = noll_to_nm(j)
    am = abs(m)
    C = np.zeros((n + 1, n + 1))
    # radial part: R(r) = sum_k (-1)^k (n-k)! / (k! ((n+am)/2-k)! ((n-am)/2-k)!) r^(n-2k)
    for k in range((n - am) // 2 + 1):
        c_rad = ((-1) ** k * factorial(n - k)
                 / (factorial(k) * factorial((n + am) // 2 - k)
                    * factorial((n - am) // 2 - k)))
        p_r = n - 2 * k          # power of r; r^p_r * angular(am)
        # r^(p_r) * cos(am θ) (or sin) as xy-polynomial:
        # r^(p_r-am) = (x^2+y^2)^((p_r-am)/2); cos(amθ) r^am = Re[(x+iy)^am]
        half = (p_r - am) // 2
        # binomial expansion of (x^2+y^2)^half
        for b in range(half + 1):
            c_bin = c_rad * factorial(half) / (factorial(b)
                                               * factorial(half - b))
            # times Re or Im of (x+iy)^am
            for t in range(am + 1):
                c_ang = factorial(am) / (factorial(t) * factorial(am - t))
                # (x + iy)^am term: x^(am-t) (iy)^t
                if m >= 0:      # cos: Re -> even t, sign (-1)^(t/2)
                    if t % 2 == 0:
                        C[2 * (half - b) + am - t, 2 * b + t] += \
                            c_bin * c_ang * (-1) ** (t // 2)
                else:           # sin: Im -> odd t, sign (-1)^((t-1)/2)
                    if t % 2 == 1:
                        C[2 * (half - b) + am - t, 2 * b + t] += \
                            c_bin * c_ang * (-1) ** ((t - 1) // 2)
    # Noll normalization: sqrt(n+1) for m=0 else sqrt(2(n+1))
    C *= np.sqrt(n + 1.0) * (1.0 if m == 0 else np.sqrt(2.0))
    return C


def zernike_eval(coef, x, y):
    """sum_j coef[j-1] * Z_j(x, y) over the unit disk (vectorized)."""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    out = np.zeros(np.broadcast(x, y).shape)
    for j, cj in enumerate(np.asarray(coef), start=1):
        if cj == 0.0:
            continue
        C = zernike_xy_coeffs(j)
        out += cj * _poly2d(C, x, y)
    return out


def zernike_grad(coef, x, y):
    """(d/dx, d/dy) of the Zernike sum."""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    gx = np.zeros(np.broadcast(x, y).shape)
    gy = np.zeros_like(gx)
    for j, cj in enumerate(np.asarray(coef), start=1):
        if cj == 0.0:
            continue
        C = zernike_xy_coeffs(j)
        Cx = C[1:, :] * np.arange(1, C.shape[0])[:, None]
        Cy = C[:, 1:] * np.arange(1, C.shape[1])[None, :]
        gx += cj * _poly2d(Cx, x, y)
        gy += cj * _poly2d(Cy, x, y)
    return gx, gy


def _poly2d(C, x, y):
    """Evaluate sum C[p, q] x^p y^q by nested Horner."""
    out = np.zeros(np.broadcast(x, y).shape)
    for p in range(C.shape[0] - 1, -1, -1):
        row = np.zeros_like(out)
        for q in range(C.shape[1] - 1, -1, -1):
            row = row * y + C[p, q]
        out = out * x + row
    return out


def fit_zernikes(x, y, z, jmax, mask=None):
    """Least-squares Zernike coefficients of samples z(x, y) on the unit
    disk (used by the OPD output's annular-Zernike analysis)."""
    x = np.asarray(x, float).ravel()
    y = np.asarray(y, float).ravel()
    z = np.asarray(z, float).ravel()
    if mask is not None:
        m = np.asarray(mask, bool).ravel()
        x, y, z = x[m], y[m], z[m]
    A = np.stack([_poly2d(zernike_xy_coeffs(j), x, y)
                  for j in range(1, jmax + 1)], axis=-1)
    coef, *_ = np.linalg.lstsq(A, z, rcond=None)
    return coef
