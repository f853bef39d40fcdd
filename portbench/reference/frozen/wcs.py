"""TAN and TAN-SIP world coordinate systems + least-squares SIP fitting,
host numpy float64 (copy of imsim_tpu/optics/wcs.py): the raytraced
(pixel -> sky) samples of a detector are fit with a TAN projection plus
order-3 SIP distortion polynomials, once per CCD.  `header_cards` gives
the FITS WCS keywords.
"""
from __future__ import annotations

import numpy as np

from .coords import gnomonic_deproject, gnomonic_project


def _poly_terms(u, v, order):
    """All monomials u^p v^q with 2 <= p+q <= order (SIP convention:
    linear part lives in the CD matrix)."""
    terms = []
    powers = []
    for p in range(order + 1):
        for q in range(order + 1 - p):
            if 2 <= p + q:
                terms.append(u**p * v**q)
                powers.append((p, q))
    return np.stack(terms, axis=-1), powers


class TanSipWCS:
    """x,y (pixel) <-> ra,dec via: SIP distortion -> CD matrix -> gnomonic.

    Convention (FITS): [u;v]_deg = CD @ ([x;y] - crpix + [f(x,y); g(x,y)])
    where f,g are the SIP A/B polynomials in pixel offsets.
    """

    def __init__(self, crpix, cd, crval, a_coeffs=None, b_coeffs=None,
                 ab_powers=None):
        self.crpix = np.asarray(crpix, float)        # (2,)
        self.cd = np.asarray(cd, float)              # (2,2) degrees/pixel
        self.crval = np.asarray(crval, float)        # (ra0, dec0) radians
        self.a = a_coeffs                             # SIP A coeffs or None
        self.b = b_coeffs
        self.ab_powers = ab_powers
        self.order = 0 if ab_powers is None else max(p + q for p, q in ab_powers)

    # ---- forward: pixel -> sky -------------------------------------------
    def xy_to_radec(self, x, y):
        dx = np.asarray(x, float) - self.crpix[0]
        dy = np.asarray(y, float) - self.crpix[1]
        if self.a is not None:
            T, _ = _poly_terms(dx, dy, self.order)
            dx = dx + T @ self.a
            dy = dy + T @ self.b
        u = (self.cd[0, 0] * dx + self.cd[0, 1] * dy) * np.pi / 180.0
        v = (self.cd[1, 0] * dx + self.cd[1, 1] * dy) * np.pi / 180.0
        # FITS TAN: u is -RA direction when CD has the usual sign; we keep
        # u = east offset and let the fitted CD carry the signs.
        return gnomonic_deproject(u, v, self.crval[0], self.crval[1])

    # ---- inverse: sky -> pixel (Newton iteration on SIP) ------------------
    def radec_to_xy(self, ra, dec, niter=4):
        u, v = gnomonic_project(np.asarray(ra, float), np.asarray(dec, float),
                                self.crval[0], self.crval[1])
        cdinv = np.linalg.inv(self.cd)
        U = u * 180.0 / np.pi
        V = v * 180.0 / np.pi
        px = cdinv[0, 0] * U + cdinv[0, 1] * V
        py = cdinv[1, 0] * U + cdinv[1, 1] * V
        if self.a is None:
            return px + self.crpix[0], py + self.crpix[1]
        dx, dy = px, py
        for _ in range(niter):
            T, _ = _poly_terms(dx, dy, self.order)
            dx = px - T @ self.a
            dy = py - T @ self.b
        return dx + self.crpix[0], dy + self.crpix[1]

    def pixel_scale(self, x=None, y=None):
        """Mean pixel scale in arcsec/pixel at the reference point."""
        return np.sqrt(abs(np.linalg.det(self.cd))) * 3600.0

    def local_jacobian(self, x, y, h=1.0):
        """d(u,v)[arcsec]/d(x,y)[pix] at (x,y) by finite differences."""
        ra0, dec0 = self.xy_to_radec(x, y)
        rax, decx = self.xy_to_radec(x + h, y)
        ray, decy = self.xy_to_radec(x, y + h)
        cd0 = np.cos(dec0)
        j = np.array([
            [(rax - ra0) * cd0 / h, (ray - ra0) * cd0 / h],
            [(decx - dec0) / h, (decy - dec0) / h],
        ]) / (np.pi / 180 / 3600)
        return j

    # ---- FITS header ------------------------------------------------------
    def header_cards(self):
        cards = {
            "CTYPE1": "RA---TAN-SIP" if self.a is not None else "RA---TAN",
            "CTYPE2": "DEC--TAN-SIP" if self.a is not None else "DEC--TAN",
            "CRPIX1": self.crpix[0] + 1,   # FITS 1-based
            "CRPIX2": self.crpix[1] + 1,
            "CRVAL1": self.crval[0] * 180 / np.pi,
            "CRVAL2": self.crval[1] * 180 / np.pi,
            # internal cd already maps pixels to (u=east, v=north) —
            # exactly the FITS intermediate world coordinates (axis 1 =
            # RA, increasing EAST): write it unchanged.  (A historical
            # negation here mirrored every written WCS east-west; the
            # textbook reading of the reference's golden header is the
            # regression oracle, tests/test_golden_wcs.py.)
            "CD1_1": self.cd[0, 0],
            "CD1_2": self.cd[0, 1],
            "CD2_1": self.cd[1, 0],
            "CD2_2": self.cd[1, 1],
            "RADESYS": "ICRS",
        }
        if self.a is not None:
            cards["A_ORDER"] = self.order
            cards["B_ORDER"] = self.order
            for (p, q), av, bv in zip(self.ab_powers, self.a, self.b):
                cards[f"A_{p}_{q}"] = av
                cards[f"B_{p}_{q}"] = bv
        return cards


def fit_tan_sip(x, y, ra, dec, order=3, crpix=None, crval=None):
    """Least-squares TAN-SIP fit to matched (pixel, sky) samples —
    the FittedSIPWCS equivalent (imsim/batoid_wcs.py:429-453).

    Parameters
    ----------
    x, y : pixel coords (0-based)
    ra, dec : radians
    order : SIP polynomial order (reference uses 3)
    """
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    if crpix is None:
        crpix = np.array([x.mean(), y.mean()])
    if crval is None:
        i0 = np.argmin((x - crpix[0]) ** 2 + (y - crpix[1]) ** 2)
        crval = np.array([ra[i0], dec[i0]])
    u, v = gnomonic_project(ra, dec, crval[0], crval[1])
    U = u * 180 / np.pi
    V = v * 180 / np.pi

    # Stage 1: affine fit; fold the constant term into crpix so the tangent
    # point (u=v=0) sits exactly at crpix.
    A = np.stack([x - crpix[0], y - crpix[1], np.ones_like(x)], axis=-1)
    cu, *_ = np.linalg.lstsq(A, U, rcond=None)
    cv, *_ = np.linalg.lstsq(A, V, rcond=None)
    cd = np.array([cu[:2], cv[:2]])
    crpix = crpix + np.linalg.solve(cd, -np.array([cu[2], cv[2]]))

    if order < 2:
        return TanSipWCS(crpix, cd, crval)

    # Stage 2: SIP fit on residuals in pixel space. Jointly fit constant +
    # linear + polynomial terms; fold the constant into crpix and the linear
    # part into CD, iterating until only pure >=2-order terms remain.
    powers = None
    for _ in range(6):
        dx = x - crpix[0]
        dy = y - crpix[1]
        T, powers = _poly_terms(dx, dy, order)
        ones = np.ones_like(dx)
        design = np.concatenate([ones[:, None],
                                 np.stack([dx, dy], -1), T], axis=-1)
        cdinv = np.linalg.inv(cd)
        px = cdinv[0, 0] * U + cdinv[0, 1] * V
        py = cdinv[1, 0] * U + cdinv[1, 1] * V
        coef_x, *_ = np.linalg.lstsq(design, px - dx, rcond=None)
        coef_y, *_ = np.linalg.lstsq(design, py - dy, rcond=None)
        # px = dx + c0 + l.dx + T@a  ->  absorb c0 into crpix, l into CD
        crpix = crpix - np.array([coef_x[0], coef_y[0]])
        L = np.array([[1 + coef_x[1], coef_x[2]],
                      [coef_y[1], 1 + coef_y[2]]])
        cd = cd @ L
        leak = (abs(coef_x[0]) + abs(coef_y[0])
                + 1e3 * (abs(coef_x[1] - 0) + abs(coef_x[2])
                         + abs(coef_y[1]) + abs(coef_y[2])))
        if leak < 1e-10:
            break
    a, b = coef_x[3:], coef_y[3:]
    return TanSipWCS(crpix, cd, crval, a, b, powers)
