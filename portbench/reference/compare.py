"""The numbers that decide `correct`, for one CCD the window produced,
each a gap that a sound run keeps small:

  kept_diff     catalog rows kept by exactly one side (the reader, the
                component expansion and the cull);
  pos_px        the largest gap between a kept row's pixel position and
                the reference's (the WCS of the host preparation);
  flux_rel      the largest relative gap of a sampled row's expected
                photons (SED, redshift, dust, bandpass, lensing) from
                the reference's, rows of 100 photons or more;
  realized_chi2 |mean((realized - expected)^2 / expected) - 1| over the
                sampled rows outside the FFT pass of 100 expected photons
                or more: each row's realized photons (the render's tally)
                are a Poisson draw of the reference's expectation;
  centroid_px   the 90th percentile of the distances of isolated stars'
                centroids in the rendered charge from the reference's
                positions, a star without charge at its place counting
                as infinitely far (the pooled render: shooting, the ray
                chain, rows, sensor, binning);
  readout_chi2  over the amps compared, the largest |chi2 / pixel - 1|
                of the raw amps against the reference's readout of the
                eimage (gains, crosstalk, CTE, bias, read noise);
  charge_rel    |median over tiles of (rendered charge / the reference's
                expected photons of the rows centred there) - 1|, tiles
                clear of the bright stars (the pooled render's amounts:
                shooting, sensor, binning scatter);
  fft_charge_rel |charge / expected photons - 1| over boxes around the
                bright stars inside the frame (the FFT pass's amounts);
  sky_chi2      |chi2 / pixel - 1| of eimage - image (the sky and its
                noise, cosmic rays clipped) about its own per-tile mean,
                against that mean's Poisson variance;
  file_gap      (visits) the largest gap between the eimage file read
                back and the eimage in memory.

`Produced` is what the program gave; `control` builds the reference's
own answers at bfloat16 in its place.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import expect, measure
from .generate import POINT, Objects


@dataclasses.dataclass
class Produced:
    det: str
    ids: np.ndarray            # kept rows' object ids (int64)
    x: np.ndarray              # their pixel positions
    y: np.ndarray
    nominal: np.ndarray        # their expected photons
    realized: np.ndarray       # their realized photons (the render's tally)
    image: np.ndarray | None   # the rendered charge (ny, nx)
    eimage: np.ndarray | None  # with sky, noise and cosmic rays
    amps: dict                 # amp index -> (raw_ny, raw_nx) int32 ADU
    file_gap: float | None = None
    # what the amounts read in place of image and eimage - image (the
    # control's bfloat16 tally and frame); None: those two
    charge: np.ndarray | None = None
    sky: np.ndarray | None = None


def _by_id(ids, *cols):
    """Rows sorted by (id, first column)."""
    order = np.lexsort((cols[0], ids))
    return (ids[order],) + tuple(c[order] for c in cols)


def kept_diff(prog_ids, ref_ids) -> int:
    a, ca = np.unique(prog_ids, return_counts=True)
    b, cb = np.unique(ref_ids, return_counts=True)
    allk = np.union1d(a, b)
    na = np.zeros(len(allk), np.int64)
    nb = np.zeros(len(allk), np.int64)
    na[np.searchsorted(allk, a)] = ca
    nb[np.searchsorted(allk, b)] = cb
    return int(np.abs(na - nb).sum())


def pos_px(prog: Produced, ref_ids, rx, ry) -> float:
    """The largest position gap over ids both sides keep (components of
    one galaxy share its position)."""
    pi, first = np.unique(prog.ids, return_index=True)
    ri, rfirst = np.unique(ref_ids, return_index=True)
    common, ia, ib = np.intersect1d(pi, ri, return_indices=True)
    if not len(common):
        return float("inf")
    dx = prog.x[first[ia]] - rx[rfirst[ib]]
    dy = prog.y[first[ia]] - ry[rfirst[ib]]
    return float(np.max(np.hypot(dx, dy)))


def paired(prog: Produced, ref_ids, ref_flux, ref_bright):
    """(program nominal, program realized, reference flux, reference
    bright flag) of the rows of ref_ids, the rows of one id matched in
    flux order (an id whose rows the two sides count differently is
    kept_diff's and left out)."""
    pid, pn, pr = _by_id(prog.ids, prog.nominal, prog.realized)
    rid, rf, rb = _by_id(ref_ids, ref_flux, ref_bright)
    out = [[], [], [], []]
    for i in np.unique(rid):
        a0, a1 = np.searchsorted(pid, i), np.searchsorted(pid, i, "right")
        b0, b1 = np.searchsorted(rid, i), np.searchsorted(rid, i, "right")
        if a1 - a0 != b1 - b0:
            continue
        for col, arr in zip(out, (pn[a0:a1], pr[a0:a1], rf[b0:b1],
                                  rb[b0:b1])):
            col.append(arr)
    return tuple(np.concatenate(c) if c else np.zeros(0) for c in out)


def flux_rel(nominal, ref_flux, min_flux=100.0) -> float:
    """The largest |program / reference - 1| over rows of min_flux
    expected photons or more."""
    big = ref_flux >= min_flux
    if not big.any():
        return float("inf")
    return float(np.max(np.abs(nominal[big] / ref_flux[big] - 1.0)))


def realized_chi2(realized, ref_flux, bright, min_flux=100.0) -> float:
    """|mean((realized - expected)^2 / expected) - 1| over the rows
    outside the FFT pass (not bright) of min_flux expected photons or
    more: 0 for Poisson draws of the expectation, up to the sampling."""
    use = (ref_flux >= min_flux) & ~bright.astype(bool)
    if not use.any():
        return float("inf")
    e = ref_flux[use]
    return float(abs(np.mean((realized[use] - e) ** 2 / e) - 1.0))


def isolated_stars(visit, rows: Objects, det: str, idx, x, y,
                   cfg) -> np.ndarray:
    """Indices into idx of point sources inside the frame by `edge` px,
    of at least `min_flux` generated photons, with no other row within
    `radius` px above `share` of their flux; the `count` brightest."""
    c = cfg["centroid"]
    ccd = visit.camera[det]
    nx, ny = ccd.bounds.width, ccd.bounds.height
    f = rows["flux0"][idx]
    star = ((rows["kind"][idx] == POINT) & (f >= c["min_flux"])
            & (x >= c["edge"]) & (x <= nx - 1 - c["edge"])
            & (y >= c["edge"]) & (y <= ny - 1 - c["edge"]))
    cand = np.nonzero(star)[0]
    cand = cand[np.argsort(-f[cand])]
    # neighbours on a grid of radius-sized cells
    r = float(c["radius"])
    cell = {}
    for j, (cx, cy) in enumerate(zip((x // r).astype(int),
                                     (y // r).astype(int))):
        cell.setdefault((cx, cy), []).append(j)
    keep = []
    for j in cand:
        cx, cy = int(x[j] // r), int(y[j] // r)
        near = [k for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                for k in cell.get((cx + dx, cy + dy), ()) if k != j]
        near = [k for k in near if np.hypot(x[k] - x[j], y[k] - y[j]) < r
                and f[k] > c["share"] * f[j]]
        if not near:
            keep.append(j)
        if len(keep) >= c["count"]:
            break
    return np.asarray(keep, np.int64)


def centroid_px(image, sx, sy) -> float:
    """The 90th percentile of the distances between the charge's
    centroids around the reference positions (sx, sy) and those
    positions (no charge there: infinitely far)."""
    if not len(sx):
        return float("inf")
    cx, cy = measure.centroids(np.asarray(image, np.float32), sx, sy)
    d = np.hypot(cx - sx, cy - sy)
    d = np.sort(np.where(np.isfinite(d), d, np.inf))
    return float(d[min(int(np.ceil(0.9 * len(d))) - 1, len(d) - 1)])


def readout_chi2(visit, det, eimage, amps: dict, rcfg,
                 detail: dict | None = None) -> float:
    """The largest |mean((amp - expected)^2 / variance) - 1| over the
    amps given, outside the masked (bleed) columns; `detail` takes each
    amp's chi2 and the masked columns' count."""
    if not amps:
        return float("inf")
    exp, var, mask = expect.readout_expectation(visit, det, eimage, rcfg,
                                                sorted(amps))
    worst, per_amp = 0.0, {}
    for k, a in amps.items():
        r = np.asarray(a, np.float64) - exp[k]
        chi2 = float(np.mean((r[~mask] ** 2)) / var[k])
        per_amp[int(k)] = round(chi2, 5)
        worst = max(worst, abs(chi2 - 1.0))
    if detail is not None:
        detail["readout_amp_chi2"] = per_amp
        detail["readout_masked_columns"] = int(mask[0].sum())
    return worst


def _tiles(a: np.ndarray, t: int) -> np.ndarray:
    """(ty, t, tx, t) view of the whole t x t tiles of a (ny, nx)."""
    ty, tx = a.shape[0] // t, a.shape[1] // t
    return a[:ty * t, :tx * t].reshape(ty, t, tx, t)


def charge_rel(image, x, y, flux, bright, ccfg) -> float:
    """|median over tiles of charge / expected - 1|: the rendered charge
    of each tile of `tile` px against the expected photons of the rows
    centred in it, over tiles that hold some and lie `bright_clear` px
    or more from every bright row (whose wings and pass are
    fft_charge_rel's).  Light that crosses a tile's border goes both
    ways, so a sound render reads near 0 and a charge scaled by s
    near |s - 1|."""
    t = int(ccfg["tile"])
    q = _tiles(np.asarray(image), t).sum(axis=(1, 3), dtype=np.float64)
    ty, tx = q.shape
    ix = np.floor((np.asarray(x) + 0.5) / t).astype(np.int64)
    iy = np.floor((np.asarray(y) + 0.5) / t).astype(np.int64)
    inside = (ix >= 0) & (ix < tx) & (iy >= 0) & (iy < ty)
    e = np.bincount((iy * tx + ix)[inside], weights=flux[inside],
                    minlength=ty * tx).reshape(ty, tx)
    # the distance from each bright row to each tile's pixels
    lo_x = np.arange(tx) * t - 0.5
    lo_y = np.arange(ty) * t - 0.5
    clear = np.ones((ty, tx), bool)
    for bx, by in zip(np.asarray(x)[bright], np.asarray(y)[bright]):
        dx = np.maximum(np.maximum(lo_x - bx, bx - (lo_x + t)), 0.0)
        dy = np.maximum(np.maximum(lo_y - by, by - (lo_y + t)), 0.0)
        clear &= np.hypot(dy[:, None], dx[None, :]) >= ccfg["bright_clear"]
    use = clear & (e > 0)
    if not use.any():
        return float("inf")
    return float(abs(np.median(q[use] / e[use]) - 1.0))


def fft_charge_rel(image, x, y, flux, bright, ccfg) -> float | None:
    """|charge / expected - 1| over the union of the boxes of half-size
    `fft_box` px around the bright rows whose box lies in the frame: the
    charge there against the expected photons of every row centred
    there (the bright stars' own, most of it).  None where no bright
    row's box lies in the frame."""
    img = np.asarray(image)
    ny, nx = img.shape
    h = int(ccfg["fft_box"])
    x, y = np.asarray(x), np.asarray(y)
    cx, cy = np.round(x).astype(np.int64), np.round(y).astype(np.int64)
    mask = np.zeros((ny, nx), bool)
    for i in np.nonzero(bright)[0]:
        if h <= cx[i] < nx - h and h <= cy[i] < ny - h:
            mask[cy[i] - h:cy[i] + h + 1, cx[i] - h:cx[i] + h + 1] = True
    if not mask.any():
        return None
    on = (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
    on[on] = mask[cy[on], cx[on]]
    e = float(np.sum(flux[on]))
    return float(abs(np.sum(img[mask], dtype=np.float64) / e - 1.0))


def sky_chi2(sky, scfg) -> float:
    """|chi2 / pixel - 1| of the sky frame (eimage - image: the sky's
    expectation, its Poisson noise rounded to whole electrons, the
    cosmic rays) about each `tile` px tile's own mean, against that
    mean's variance (the mean + 1/12, the rounding's); pixels over
    `clip` sigmas from the tile's median (cosmic rays) left out.  A sky
    without its noise reads 1, a frame scaled by s about |s - 1|."""
    d = _tiles(np.asarray(sky, np.float64), int(scfg["tile"]))
    d = d.transpose(0, 2, 1, 3).reshape(d.shape[0] * d.shape[2], -1)
    med = np.median(d, axis=1, keepdims=True)
    keep = np.abs(d - med) <= scfg["clip"] * np.sqrt(np.maximum(med, 1.0))
    n = keep.sum(axis=1)
    mean = np.where(keep, d, 0.0).sum(axis=1) / np.maximum(n, 1)
    ss = (np.where(keep, d - mean[:, None], 0.0) ** 2).sum(axis=1)
    var = np.maximum(mean, 0.0) + 1.0 / 12.0
    return float(abs(np.sum(ss / var) / np.sum(np.maximum(n - 1, 0)) - 1.0))


def amounts(idx, rx, ry, flux, rows: Objects, charge, sky, cfg) -> dict:
    """charge_rel, fft_charge_rel (where the frame holds a bright star's
    box) and sky_chi2 of a rendered charge and its sky frame; flux: the
    expected photons of the culled rows idx at (rx, ry)."""
    bright = rows["bright"][idx].astype(bool)
    ccfg = cfg["charge"]
    out = {"charge_rel": charge_rel(charge, rx, ry, flux, bright, ccfg)}
    f = fft_charge_rel(charge, rx, ry, flux, bright, ccfg)
    if f is not None:
        out["fft_charge_rel"] = f
    out["sky_chi2"] = sky_chi2(sky, cfg["sky"])
    return out


def numbers(visit, rows: Objects, prog: Produced, cfg: dict,
            rng: np.random.Generator, rcfg: dict,
            detail: dict | None = None) -> dict:
    """Every number for one CCD, from the program's answers (`detail`
    takes what explains them: per-amp chi2, the stars measured)."""
    det = prog.det
    edge = float(cfg["edge_pix"])
    idx, rx, ry = expect.cull(visit, rows, det, edge)
    ref_ids = rows["id"][idx]
    out = {"kept_diff": float(kept_diff(prog.ids, ref_ids)),
           "pos_px": pos_px(prog, ref_ids, rx, ry)}
    # a sample of ids, all of their rows
    uniq = np.unique(ref_ids)
    ids = rng.choice(uniq, size=min(int(cfg["flux_sample"]), len(uniq)),
                     replace=False)
    sel = np.isin(ref_ids, ids)
    nom, real, ref, bright = paired(prog, ref_ids[sel],
                                    visit.flux(rows.take(idx[sel])),
                                    rows["bright"][idx[sel]])
    out["flux_rel"] = flux_rel(nom, ref)
    out["realized_chi2"] = realized_chi2(real, ref, bright)
    if prog.image is not None:
        st = isolated_stars(visit, rows, det, idx, rx, ry, cfg)
        out["centroid_px"] = centroid_px(prog.image, rx[st], ry[st])
        if detail is not None:
            detail["centroid_stars"] = int(len(st))
    if prog.image is not None and prog.eimage is not None:
        charge = prog.image if prog.charge is None else prog.charge
        sky = prog.sky
        if sky is None:
            sky = (np.asarray(prog.eimage, np.float64)
                   - np.asarray(prog.image, np.float64))
        out.update(amounts(idx, rx, ry, visit.fluxes(rows.take(idx)), rows,
                           charge, sky, cfg))
    if prog.eimage is not None:
        out["readout_chi2"] = readout_chi2(visit, det, prog.eimage,
                                           prog.amps, rcfg, detail)
    if prog.file_gap is not None:
        out["file_gap"] = float(prog.file_gap)
    return out


# ---- the control: the reference in the program's place, in bfloat16 ----------

# a bfloat16 sum of ones: exact to 256, then 256 + 1 rounds to 256
BF16_TALLY_STALL = 256.0


def bf16(a) -> np.ndarray:
    """Round float64 values to the nearest bfloat16 (8 significant
    bits), as float64."""
    import torch

    return torch.as_tensor(np.asarray(a, np.float64)).to(
        torch.bfloat16).to(torch.float64).numpy()


def control(visit, rows: Objects, det: str, cfg: dict, rcfg: dict,
            rng: np.random.Generator, image, eimage, amps_k,
            noise_rng: np.random.Generator) -> Produced:
    """The reference's own answers computed in bfloat16: positions and
    the cull from bfloat16 pixel positions, bfloat16 expected photons,
    realized photons tallied one photon at a time in bfloat16 (a sum of
    ones stalls at 256, where 257 rounds back to 256), centroids at the
    bfloat16 positions (an image that puts each star's charge there),
    raw amps from the bfloat16 expected ADU with the read noise and the
    rounding added; for the amounts, the rendered charge's photons
    (`image`) tallied per pixel in bfloat16 (stalled at 256) and the
    frame (`eimage`) held in bfloat16."""
    ccd = visit.camera[det]
    edge = float(cfg["edge_pix"])
    x, y = visit.wcs(det).radec_to_xy(rows["ra"] * expect.DEG,
                                      rows["dec"] * expect.DEG)
    xb, yb = bf16(x), bf16(y)
    nx, ny = ccd.bounds.width, ccd.bounds.height
    keep = ((xb >= -edge) & (xb <= nx + edge) & (yb >= -edge)
            & (yb <= ny + edge))
    idx = np.nonzero(keep)[0]
    flux = np.zeros(len(idx))
    ref_idx, rx, ry = expect.cull(visit, rows, det, edge)
    uniq = np.unique(rows["id"][ref_idx])
    ids = rng.choice(uniq, size=min(int(cfg["flux_sample"]), len(uniq)),
                     replace=False)
    sel = np.isin(rows["id"][idx], ids)
    e = visit.flux(rows.take(idx[sel]))
    flux[sel] = bf16(e)
    realized = np.zeros(len(idx))
    realized[sel] = np.minimum(noise_rng.poisson(e), BF16_TALLY_STALL)
    # the charge image: each isolated star's flux as a small Gaussian at
    # its bfloat16 position
    st = isolated_stars(visit, rows, det, ref_idx, rx, ry, cfg)
    img = np.zeros((ny, nx), np.float32)
    k = np.arange(-6, 7)
    for j in st:
        cx, cy = float(bf16(rx[j])), float(bf16(ry[j]))
        ix, iy = int(round(cx)), int(round(cy))
        gy, gx = np.meshgrid(iy + k, ix + k, indexing="ij")
        ok = (gx >= 0) & (gx < nx) & (gy >= 0) & (gy < ny)
        g = np.exp(-0.5 * ((gx - cx) ** 2 + (gy - cy) ** 2) / 2.0 ** 2)
        img[gy[ok], gx[ok]] += (rows["flux0"][ref_idx[j]] * g[ok]
                                / g.sum()).astype(np.float32)
    exp, var, _ = expect.readout_expectation(visit, det, eimage, rcfg,
                                             sorted(amps_k))
    amps = {}
    for a in amps_k:
        noisy = bf16(exp[a]) + noise_rng.normal(
            0.0, np.sqrt(var[a] - 1.0 / 12.0), exp[a].shape)
        amps[a] = np.round(noisy).astype(np.int32)
    image = np.asarray(image, np.float64)
    return Produced(det=det, ids=rows["id"][idx], x=xb[idx], y=yb[idx],
                    nominal=flux, realized=realized, image=img,
                    eimage=eimage, amps=amps, file_gap=None,
                    charge=bf16(np.minimum(image, BF16_TALLY_STALL)),
                    sky=bf16(eimage) - image)


def scaled_amounts(visit, rows: Objects, prog: Produced, cfg: dict,
                   scale: float) -> dict:
    """The amounts of a fault planted in the program's answer: its
    charge and its frame (eimage) scaled by `scale`."""
    idx, rx, ry = expect.cull(visit, rows, prog.det, float(cfg["edge_pix"]))
    image = np.asarray(prog.image, np.float64)
    sky = np.asarray(prog.eimage, np.float64) - image
    return amounts(idx, rx, ry, visit.fluxes(rows.take(idx)), rows,
                   image * scale, sky * scale, cfg)
