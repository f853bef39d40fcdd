"""Electronics readout chain: eimage -> per-amp raw images, on the
eimage's device (imsim_tpu/electronics/readout.py counterpart).

bleed -> dark current -> amp segmentation, gains and readout flips ->
crosstalk (one 16 x 16 einsum) -> prescan/overscan embed -> CTE (the
banded form of the CTI matrix: a few multiply-adds of shifted slices)
-> bias and read noise.  The HDU and FITS assembly is not ported.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy import special as _sp

from .camera import VENDOR_SPECS


def cte_matrix(npix: int, cti: float, ntransfers: int = 20) -> np.ndarray:
    """Charge-transfer-inefficiency matrix, q_out = M @ q_in: diagonal
    (1-cti)^i, off-diagonal binom(i-1, i-j) (1-cti)^j cti^(i-j)."""
    M = np.zeros((npix, npix))
    i = np.arange(1, npix + 1)
    M[i - 1, i - 1] = (1.0 - cti) ** i
    for ii in range(1, npix + 1):
        jmin = max(1, ii - ntransfers)
        j = np.arange(jmin, ii)
        M[ii - 1, jmin - 1:ii - 1] = (
            _sp.binom(ii - 1, ii - j) * (1.0 - cti) ** j
            * cti ** (ii - j))
    return M


def cte_bands(npix: int, cti: float, nband: int = None) -> np.ndarray:
    """(nband+1, npix) banded form of cte_matrix: bands[k, p] = M[p, p-k].
    nband=None sizes the band from npix*cti: grow until the next term's
    bound (npix*cti)^k / k! drops below float32 epsilon."""
    if nband is None:
        x = npix * abs(cti)
        nband, term = 1, x
        while term > 1.2e-7 and nband < npix - 1:
            nband += 1
            term *= x / nband
        nband = max(nband, 2)
    i = np.arange(1, npix + 1, dtype=np.float64)
    bands = np.zeros((nband + 1, npix))
    bands[0] = (1.0 - cti) ** i
    for k in range(1, nband + 1):
        val = _sp.binom(i - 1, k) * (1.0 - cti) ** (i - k) * cti ** k
        val[i - k < 1] = 0.0
        bands[k] = val
    return bands


def apply_cte_bands(raw: torch.Tensor, bands: torch.Tensor,
                    axis: int) -> torch.Tensor:
    """out[..., p, ...] = sum_k bands[k, p] * raw[..., p-k, ...] along
    `axis` (the banded q_out = M q_in)."""
    npix = raw.shape[axis]
    coef_shape = [1] * raw.ndim
    coef_shape[axis] = npix
    out = None
    for k in range(bands.shape[0]):
        if k == 0:
            shifted = raw
        else:
            zshape = list(raw.shape)
            zshape[axis] = k
            shifted = torch.cat([raw.new_zeros(zshape),
                                 raw.narrow(axis, 0, npix - k)], dim=axis)
        term = shifted * bands[k].reshape(coef_shape)
        out = term if out is None else out + term
    return out


def _first_true(mask: torch.Tensor, idx: torch.Tensor, none: int):
    """Index of the first True along axis 0 of each column, or `none`."""
    return torch.where(mask, idx, none).amin(dim=0)


def _bleed_first_runs(v: torch.Tensor, fw: float) -> torch.Tensor:
    """The first remaining saturated run of every column, with the
    reference's alternating outward fill: the run is clamped to full
    well and its excess walks out from the run's ends at increasing
    distance j, below(j) then above(j), filling each visited pixel to
    full well.  Below the bottom edge each step swallows one full well
    (escape); above the top edge nothing absorbs; the walk stops after
    max(y0, H - y1) steps.  A visited pixel that is itself above full
    well gives its surplus to the walk (a negative capacity fw - v).

    Every pixel outside the run has one index k in the visit order
    (below j -> 2j - 2, above j -> 2j - 1); a cumulative-capacity scan
    over k finds where the charge runs out, and each pixel reads its
    fate (full, partial or untouched) from its own k."""
    H, W = v.shape
    dev = v.device
    idx = torch.arange(H, device=dev)[:, None]
    mask = v > fw
    has = mask.any(dim=0)
    y0 = torch.where(has, _first_true(mask, idx, H), 0)
    after = (~mask) & (idx >= y0[None, :])
    y1 = _first_true(after, idx, H)
    in_run = (idx >= y0[None, :]) & (idx < y1[None, :])
    E = torch.where(in_run, v - fw, 0.0).sum(dim=0)
    v = torch.where(in_run, fw, v)

    k2 = torch.arange(2 * H, device=dev)[:, None]
    is_below = (k2 % 2) == 0
    j = torch.where(is_below, k2 // 2 + 1, (k2 + 1) // 2)
    tgt = torch.where(is_below, y0[None, :] - j, y1[None, :] + j - 1)
    dy_max = torch.maximum(y0, H - y1)[None, :]
    vt = torch.gather(v, 0, torch.clamp(tgt, 0, H - 1))
    ci = torch.where(j > dy_max, 0.0,
                     torch.where(is_below & (tgt < 0), fw,
                                 torch.where(~is_below & (tgt >= H), 0.0,
                                             fw - vt)))
    cum = torch.cumsum(ci, dim=0)
    # first k where the walk's cumulative absorption reaches E (the
    # running max guards the non-monotonic negative-capacity case)
    reached = torch.cummax(cum, dim=0).values >= E[None, :]
    stop = _first_true(reached, k2, 2 * H)

    jb = y0[None, :] - idx
    ja = idx - y1[None, :] + 1
    k_pix = torch.where(idx < y0[None, :], 2 * jb - 2, 2 * ja - 1)
    cum_prev = torch.gather(cum - ci, 0, torch.clamp(k_pix, 0, 2 * H - 1))
    part = torch.clamp(E[None, :] - cum_prev, min=0.0)
    out = torch.where(k_pix < stop[None, :], fw,
                      torch.where(k_pix == stop[None, :], v + part, v))
    return torch.where(has[None, :], out, v)


def bleed_image(image: torch.Tensor, full_well: float,
                midline_stop: bool = False) -> torch.Tensor:
    """Charge bleeding along columns (y) with the reference's semantics
    (imsim/bleed_trails.py): per saturated run, clamp to full well and
    walk the excess outward, one pixel below then one above per distance
    step; charge escapes off the bottom edge only.  Runs are taken in
    ascending y per column, "first remaining run" until no pixel is
    above full well (one host check per round); columns run in parallel.
    midline_stop: the two halves bleed separately (E2V)."""
    H = image.shape[0]
    if midline_stop:
        return torch.cat([bleed_image(image[:H // 2], full_well),
                          bleed_image(image[H // 2:], full_well)], dim=0)
    fw = float(full_well)
    v = image
    while bool((v > fw).any()):
        v = _bleed_first_runs(v, fw)
    return v


def segment_image(image: torch.Tensor, vendor: str) -> torch.Tensor:
    """CCD image (ny, nx) -> (n_amps, amp_ny, amp_nx) in readout order:
    E2V reads the bottom row (C00-C07) unflipped and the top row
    (C10-C17) flipped in both axes; every ITL segment is x-flipped (top
    row also y-flipped).  ITL_WF carries only the bottom row."""
    spec = VENDOR_SPECS[vendor]
    anx, any_ = spec["amp_nx"], spec["amp_ny"]
    ny = image.shape[0]
    bottom = image[:any_].reshape(any_, 8, anx).permute(1, 0, 2)
    if vendor.startswith("ITL"):
        bottom = bottom.flip(2)
    if vendor == "ITL_WF":
        return bottom
    top = image[ny - any_:].reshape(any_, 8, anx).permute(1, 0, 2).flip(1, 2)
    return torch.cat([bottom, top], dim=0)


def unsegment_image(amps: torch.Tensor, vendor: str, ny: int,
                    nx: int) -> torch.Tensor:
    """Inverse of segment_image."""
    spec = VENDOR_SPECS[vendor]
    anx, any_ = spec["amp_nx"], spec["amp_ny"]
    bottom = amps[:8]
    if vendor.startswith("ITL"):
        bottom = bottom.flip(2)
    img = amps.new_zeros((ny, nx))
    img[:any_] = bottom.permute(1, 0, 2).reshape(any_, 8 * anx)
    if vendor != "ITL_WF":
        img[ny - any_:] = amps[8:].flip(1, 2).permute(1, 0, 2).reshape(
            any_, 8 * anx)
    return img


def readout_chain(gen: torch.Generator, image: torch.Tensor, gains, xtalk,
                  bias_levels, read_noises, pcte, scte, vendor: str,
                  full_well: float, midline_stop: bool,
                  dark_current: float = 0.02, exptime: float = 30.0,
                  readout_time: float = 2.0) -> torch.Tensor:
    """Device readout of an eimage [electrons]: (16, raw_ny, raw_nx)
    float32 ADU (the caller rounds).  gains, bias_levels, read_noises
    (16,), xtalk (16, 16) and the CTE bands are tensors on the image's
    device; the dark current and the read noise are drawn from `gen`,
    in that order."""
    spec = VENDOR_SPECS[vendor]
    anx, any_ = spec["amp_nx"], spec["amp_ny"]
    pre = spec["prescan"]
    raw_nx = pre + anx + spec["serial_oscan"]
    raw_ny = any_ + spec["parallel_oscan"]

    image = bleed_image(image, full_well, midline_stop)
    dark = torch.full_like(image, dark_current * (exptime + readout_time))
    image = image + torch.poisson(dark, generator=gen)
    amps = segment_image(image, vendor) / gains[:, None, None]
    # crosstalk: out_i = amp_i + sum_j xtalk[i, j] amp_j
    amps = amps + torch.einsum("ij,jhw->ihw", xtalk.to(amps.dtype), amps)
    raw = amps.new_zeros((amps.shape[0], raw_ny, raw_nx))
    raw[:, :any_, pre:pre + anx] = amps
    # CTE: parallel along columns (axis 1), serial along rows (axis 2)
    raw = apply_cte_bands(raw, pcte.to(raw.dtype), axis=1)
    raw = apply_cte_bands(raw, scte.to(raw.dtype), axis=2)
    noise = torch.randn(raw.shape, generator=gen, device=raw.device,
                        dtype=raw.dtype)
    return raw + bias_levels[:, None, None] + noise * read_noises[:, None,
                                                                  None]


class CcdReadout:
    """One CCD's readout parameters on a device: from the camera model
    (`from_ccd`) or from numpy arrays (an exported state,
    convert.readout_from_numpy)."""

    def __init__(self, vendor: str, gains, read_noises, bias_levels, xtalk,
                 full_well: float, readout_time: float = 2.0,
                 dark_current: float = 0.02, scti: float = 1e-6,
                 pcti: float = 1e-6, device="cuda"):
        spec = VENDOR_SPECS[vendor]
        self.vendor = vendor
        self.full_well = float(full_well)
        self.readout_time = readout_time
        self.dark_current = dark_current
        raw_nx = spec["prescan"] + spec["amp_nx"] + spec["serial_oscan"]
        raw_ny = spec["amp_ny"] + spec["parallel_oscan"]

        def dev(a):
            return torch.tensor(np.asarray(a, np.float32), device=device)

        self.pcte = dev(cte_bands(raw_ny, pcti))
        self.scte = dev(cte_bands(raw_nx, scti))
        self.gains = dev(gains)
        self.read_noises = dev(read_noises)
        self.bias_levels = dev(bias_levels)
        self.xtalk = dev(xtalk)

    @classmethod
    def from_ccd(cls, ccd, device="cuda", readout_time: float = 2.0,
                 dark_current: float = 0.02, scti: float = 1e-6,
                 pcti: float = 1e-6, full_well=None, read_noise=None,
                 bias_level=None) -> "CcdReadout":
        """The JAX package's CcdReadout(ccd, ...) parameters from a
        camera CCD (electronics.camera): per-amp gains, read noises and
        bias levels in amp order (or one read noise / bias level for
        every amp), the crosstalk matrix and the CCD's full well unless
        given."""
        amps = [ccd[a] for a in ccd.amp_names]
        return cls(
            ccd.vendor, [a.gain for a in amps],
            [read_noise if read_noise is not None else a.read_noise
             for a in amps],
            [bias_level if bias_level is not None else a.bias_level
             for a in amps], ccd.xtalk,
            full_well if full_well is not None else ccd.full_well,
            readout_time=readout_time, dark_current=dark_current,
            scti=scti, pcti=pcti, device=device)

    def chain(self, gen: torch.Generator, eimage: torch.Tensor,
              exptime: float = 30.0) -> torch.Tensor:
        """readout_chain with these parameters: float32 ADU."""
        return readout_chain(
            gen, eimage, self.gains, self.xtalk, self.bias_levels,
            self.read_noises, self.pcte, self.scte, self.vendor,
            self.full_well, VENDOR_SPECS[self.vendor]["midline_bleed_stop"],
            self.dark_current, float(exptime), self.readout_time)

    def run(self, gen: torch.Generator, eimage: torch.Tensor,
            exptime: float = 30.0) -> torch.Tensor:
        """eimage (ny, nx) electrons -> (16, raw_ny, raw_nx) int32 ADU."""
        return torch.round(self.chain(gen, eimage, exptime)).to(torch.int32)
