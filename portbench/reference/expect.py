"""What the program should produce, worked out anew from the benchmark's
own inputs: each CCD's WCS, which catalog rows the cull keeps and where
they land, each row's expected photons (SED, redshift, dust, bandpass,
lensing), and the raw amps' expected ADU for a given eimage.

Plain numpy (and the frozen copies of the plain host code); nothing
here imports the program or reads what it made.
"""
from __future__ import annotations

import functools

import numpy as np

from .frozen.bandpass import rubin_bandpass
from .frozen.camera import VENDOR_SPECS, get_camera
from .frozen.loader import load_telescope
from .frozen.sed import SED
from .frozen.wcs_factory import make_wcs_factory
from .generate import BANDS, POINT, RUBIN_AREA, Objects

DEG = np.pi / 180.0
# config/templates/imsim-config.yaml's image.wcs: 280 K, H2O 1 kPa,
# pressure from the site altitude
WEATHER = dict(temperature_k=280.0, h2o_pressure_kpa=1.0)


class Visit:
    """One visit of a configuration: header, camera, WCS per CCD,
    bandpass and the SED library's numbers."""

    def __init__(self, cfg: dict, head: dict, seds: dict):
        self.cfg, self.head, self.seds = cfg, head, seds
        self.band = BANDS[int(head["filter"])]
        self.exptime = float(head["vistime"])
        alt = float(head["altitude"]) * DEG
        self.airmass = 1.0 / np.sqrt(1.0 - 0.96 * np.cos(alt) ** 2)
        self.camera = get_camera(cfg["camera"])
        mjd_mid = float(head["mjd"]) + self.exptime / 2.0 / 86400.0
        tel = load_telescope(band=self.band, rotTelPos=float(
            head["rottelpos"]) * DEG)
        self.factory = make_wcs_factory(
            float(head["rightascension"]) * DEG,
            float(head["declination"]) * DEG, mjd_mid, band=self.band,
            telescope=tel, **WEATHER)
        self.bandpass = rubin_bandpass(self.band, airmass=self.airmass)
        self._wcs = {}

    def wcs(self, det: str):
        if det not in self._wcs:
            self._wcs[det] = self.factory.get_wcs(self.camera[det])
        return self._wcs[det]

    @functools.lru_cache(maxsize=None)
    def sed(self, name: str) -> SED:
        return SED.from_flambda(*self.seds[name]).normalized_magnorm0()

    def flux(self, rows: Objects) -> np.ndarray:
        """Each row's expected photons: magnorm through the area and the
        exposure, the SED with internal dust (rest frame), the redshift,
        Milky Way dust, the bandpass, times the lensing magnification."""
        base = np.exp(-0.9210340371976184 * rows["magnorm"]) * RUBIN_AREA \
            * self.exptime
        out = np.empty(rows.n)
        for i in range(rows.n):
            s = self.sed(rows["sed"][i]).extinguished(float(
                rows["int_av"][i]), 3.1)
            s = s.at_redshift(float(rows["z"][i]))
            s = s.extinguished(float(rows["mw_av"][i]), 3.1)
            out[i] = self.bandpass.photon_rate(s.wave, s.fphot, 1.0, 1.0)
        return base * out * _magnification(rows)

    def fluxes(self, rows: Objects) -> np.ndarray:
        """About flux(rows), each SED's rows at once, with the Milky Way
        curve taken at the bandpass's own wavelengths rather than at the
        SED's columns around them (a relative gap near 1e-4: the
        kernels' work counts and the charge's amounts, not flux_rel)."""
        from .frozen.sed import _ccm89_ab, ccm89_ab

        base = np.exp(-0.9210340371976184 * rows["magnorm"]) * RUBIN_AREA \
            * self.exptime * _magnification(rows)
        bw, thr = self.bandpass.wave, self.bandpass.throughput
        a_mw, b_mw = ccm89_ab(1e3 / bw)
        k_mw = -0.4 * np.log(10.0) * (a_mw + b_mw / 3.1)
        out = np.zeros(rows.n)
        for name in np.unique(rows["sed"]):
            sel = np.nonzero(rows["sed"] == name)[0]
            sed = self.sed(name)
            w0, f0 = sed.wave, sed.fphot
            a_r, b_r = _ccm89_ab(np.ascontiguousarray(w0).tobytes())
            k_int = -0.4 * np.log(10.0) * (a_r + b_r / 3.1)
            s = 1.0 + rows["z"][sel][:, None]
            iav = rows["int_av"][sel][:, None]
            # np.interp(bw, w0 * s, f) row by row: bw / s on w0's grid
            q = bw[None, :] / s
            j = np.clip(np.searchsorted(w0, q), 1, len(w0) - 1)
            f_lo = f0[j - 1] * np.exp(iav * k_int[j - 1])
            f_hi = f0[j] * np.exp(iav * k_int[j])
            t = (q - w0[j - 1]) / (w0[j] - w0[j - 1])
            val = np.where((q < w0[0]) | (q > w0[-1]), 0.0,
                           f_lo + t * (f_hi - f_lo)) / s
            val *= np.exp(rows["mw_av"][sel][:, None] * k_mw[None, :])
            out[sel] = base[sel] * np.trapezoid(val * thr[None, :], bw,
                                                axis=1)
        return out

    def total_flux(self, rows: Objects) -> float:
        """About the sum of flux(rows) (fluxes)."""
        return float(np.sum(self.fluxes(rows)))


def _magnification(rows: Objects) -> np.ndarray:
    k, g1, g2 = rows["kappa"], rows["g1"], rows["g2"]
    return np.abs(1.0 / np.maximum((1.0 - k) ** 2 - (g1 ** 2 + g2 ** 2),
                                   1e-6))


def components(objs: Objects) -> Objects:
    """skyCatalogs' DC2 galaxies as component rows (the mapped schema's
    rule): bulge_frac to a bulge, the rest to a disk and, with knots,
    knots_flux_ratio of it to the knots; each share's magnorm moves by
    -2.5 log10(share).  Stars keep their row.  Adds `comp` (0 star, 1
    bulge, 2 disk, 3 knots)."""
    gal = objs["kind"] != POINT
    star = objs.take(np.nonzero(~gal)[0])
    star["comp"] = np.zeros(star.n, np.int64)
    g = objs.take(np.nonzero(gal)[0])
    bf = np.clip(g["bulge_frac"], 0.0, 1.0)
    kr = np.clip(g["knots_flux_ratio"], 0.0, 1.0)
    f_b = bf * (g["size_bulge_true"] > 0)
    f_d = (1 - bf) * (1 - kr) * (g["size_disk_true"] > 0)
    f_k = (1 - bf) * kr * ((g["size_disk_true"] > 0) & (g["n_knots"] >= 1))
    total = f_b + f_d + f_k
    scale = np.where(total > 0, 1.0 / np.maximum(total, 1e-12), 0.0)
    parts = [star]
    for comp, frac, size in ((1, f_b, "size_bulge_true"),
                             (2, f_d, "size_disk_true"),
                             (3, f_k, "size_disk_true")):
        share = frac * scale
        keep = (share > 1e-6) & (g[size] > 0)
        if comp == 3:
            keep &= g["n_knots"] >= 1
        sub = g.take(np.nonzero(keep)[0])
        sub["magnorm"] = sub["magnorm"] - 2.5 * np.log10(
            np.maximum(share[keep], 1e-12))
        sub["comp"] = np.full(sub.n, comp, np.int64)
        parts.append(sub)
    return Objects({k: np.concatenate([p[k] for p in parts])
                    for k in parts[0]})


def cull(visit: Visit, rows: Objects, det: str, edge_pix: float):
    """(indices of the rows the cull keeps on `det`, their x, y)."""
    ccd = visit.camera[det]
    x, y = visit.wcs(det).radec_to_xy(rows["ra"] * DEG, rows["dec"] * DEG)
    nx, ny = ccd.bounds.width, ccd.bounds.height
    keep = ((x >= -edge_pix) & (x <= nx + edge_pix)
            & (y >= -edge_pix) & (y <= ny + edge_pix))
    idx = np.nonzero(keep)[0]
    return idx, x[idx], y[idx]


# ---- the readout -------------------------------------------------------------

def cte_bands(npix: int, cti: float) -> np.ndarray:
    """(nband+1, npix): bands[k, p] = binom(p, k) (1-cti)^(p+1-k) cti^k,
    the charge that reaches pixel p's output from k pixels before it;
    the band grows until (npix cti)^k / k! is below float32 epsilon."""
    from scipy.special import binom

    x, nband, term = npix * cti, 1, npix * cti
    while term > 1.2e-7 and nband < npix - 1:
        nband += 1
        term *= x / nband
    nband = max(nband, 2)
    i = np.arange(1, npix + 1, dtype=np.float64)
    bands = np.zeros((nband + 1, npix))
    bands[0] = (1.0 - cti) ** i
    for k in range(1, nband + 1):
        val = binom(i - 1, k) * (1.0 - cti) ** (i - k) * cti ** k
        val[i - k < 1] = 0.0
        bands[k] = val
    return bands


def _shift_sum(raw: np.ndarray, bands: np.ndarray, axis: int):
    out = np.zeros_like(raw)
    n = raw.shape[axis]
    shape = [1] * raw.ndim
    shape[axis] = n
    for k in range(bands.shape[0]):
        src = np.take(raw, np.arange(0, n - k), axis=axis)
        dst = [slice(None)] * raw.ndim
        dst[axis] = slice(k, n)
        out[tuple(dst)] += src * bands[k][k:].reshape(
            [n - k if a == axis else 1 for a in range(raw.ndim)])
    return out


def segments(image: np.ndarray, vendor: str) -> np.ndarray:
    """(ny, nx) -> (16, amp_ny, amp_nx) in readout order: E2V's bottom
    row as it is, its top row flipped in both axes; ITL's segments
    flipped in x (the top row in y too)."""
    spec = VENDOR_SPECS[vendor]
    anx, any_ = spec["amp_nx"], spec["amp_ny"]
    ny = image.shape[0]
    bottom = image[:any_].reshape(any_, 8, anx).transpose(1, 0, 2)
    top = image[ny - any_:].reshape(any_, 8, anx).transpose(1, 0, 2)
    top = top[:, ::-1, ::-1]
    if vendor.startswith("ITL"):
        bottom = bottom[:, :, ::-1]
    return np.concatenate([bottom, top], axis=0)


def readout_expectation(visit: Visit, det: str, eimage: np.ndarray,
                        rcfg: dict, amps=range(16)):
    """(expected ADU (16, raw_ny, raw_nx) before read noise, its
    variance per amp (16,), and the mask of pixels the bleed can move):
    the dark current's mean, the gains, crosstalk, the prescan and
    overscan frame, parallel and serial CTE and the bias.  Columns
    holding a pixel above full well (and the three after them in the
    serial direction, where CTE trails their charge), in every amp
    (crosstalk copies them), are masked: the bleed is not modelled.
    Only the rows of `amps` are filled."""
    ccd = visit.camera[det]
    spec = VENDOR_SPECS[ccd.vendor]
    anx, any_ = spec["amp_nx"], spec["amp_ny"]
    pre = spec["prescan"]
    raw_nx = pre + anx + spec["serial_oscan"]
    raw_ny = any_ + spec["parallel_oscan"]
    amp_list = [ccd[a] for a in ccd.amp_names]
    gains = np.array([a.gain for a in amp_list])
    rn = np.array([a.read_noise for a in amp_list])
    bias = np.full(16, float(rcfg["bias_level"]))
    dark = float(rcfg["dark_current"]) * (visit.exptime
                                          + float(rcfg["readout_time"]))
    img = np.asarray(eimage, np.float64)
    seg = segments(img + dark, ccd.vendor) / gains[:, None, None]
    amps = list(amps)
    xt = np.asarray(ccd.xtalk, float)[amps]
    raw = np.zeros((16, raw_ny, raw_nx))
    raw[amps, :any_, pre:pre + anx] = seg[amps] + np.einsum(
        "ij,jhw->ihw", xt, seg)
    sub = raw[amps]
    sub = _shift_sum(sub, cte_bands(raw_ny, float(rcfg["pcti"])), 1)
    sub = _shift_sum(sub, cte_bands(raw_nx, float(rcfg["scti"])), 2)
    raw[amps] = sub + bias[amps, None, None]
    sat = segments(img, ccd.vendor) > ccd.full_well
    cols = sat.any(axis=(0, 1))                 # amp-local columns
    for k in range(1, 4):
        cols[k:] |= cols[:-k].copy()
    cols[:-1] |= cols[1:].copy()
    mask = np.zeros((raw_ny, raw_nx), bool)
    mask[:, pre:pre + anx] = cols[None, :]
    # the dark current's Poisson variance and the rounding to integers
    var = rn ** 2 + dark / gains ** 2 + 1.0 / 12.0
    return raw, var, mask
