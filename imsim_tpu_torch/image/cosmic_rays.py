"""Cosmic rays (imsim_tpu/image/cosmic_rays.py counterpart).

The footprint bank (muon tracks, worms, spots) and the Poisson draw of
the CRs' number, footprints and positions are host numpy, copied from
the JAX package so that the same seeds give bit-equal hits; a saved
bank (.npz) or the reference's measured span catalog (FITS) loads in
its place.  The
painting runs on the eimage's device: the hits cross as three small
arrays and never the 64 MB frame.
"""
from __future__ import annotations

import numpy as np
import torch

CR_RATE_DEFAULT = 0.2  # CRs / cm^2 / s
PIXEL_CM = 10e-4       # 10 um


def _synth_track(rng: np.random.Generator):
    """One muon track footprint: (dx, dy, e-) along a straight line."""
    length = rng.uniform(2.0, 40.0)
    theta = rng.uniform(0, 2 * np.pi)
    n = max(int(length) + 1, 2)
    t = np.linspace(0, length, n)
    x = t * np.cos(theta)
    y = t * np.sin(theta)
    core = rng.uniform(1500.0, 4000.0)
    e = core + rng.exponential(1500.0, n)
    return x, y, e


def _synth_worm(rng: np.random.Generator):
    n = rng.integers(4, 25)
    steps = rng.normal(0, 1.0, (n, 2)).cumsum(axis=0)
    e = rng.uniform(500.0, 3000.0, n) + rng.exponential(800.0, n)
    return steps[:, 0], steps[:, 1], e


def _synth_spot(rng: np.random.Generator):
    n = rng.integers(1, 5)
    x = rng.normal(0, 0.7, n)
    y = rng.normal(0, 0.7, n)
    e = rng.uniform(1000.0, 30000.0, n)
    return x, y, e


class CosmicRayCatalog:
    """A bank of CR footprints, each (dx, dy, e-) float64 arrays."""

    def __init__(self, footprints):
        self.footprints = footprints

    def __len__(self):
        return len(self.footprints)

    @classmethod
    def synthesize(cls, n=1000, seed=2017):
        """n footprints: 55% tracks, 30% worms, 15% spots."""
        rng = np.random.default_rng(seed)
        fps = []
        for k in rng.uniform(0, 1, n):
            if k < 0.55:
                fps.append(_synth_track(rng))
            elif k < 0.85:
                fps.append(_synth_worm(rng))
            else:
                fps.append(_synth_spot(rng))
        return cls(fps)

    def save(self, path):
        """The footprint bank as an .npz (read back by load)."""
        np.savez_compressed(
            path,
            lens=np.array([len(f[0]) for f in self.footprints]),
            x=np.concatenate([f[0] for f in self.footprints]),
            y=np.concatenate([f[1] for f in self.footprints]),
            e=np.concatenate([f[2] for f in self.footprints]))

    @classmethod
    def load(cls, path):
        z = np.load(path)
        fps = []
        i = 0
        for n in z["lens"]:
            fps.append((z["x"][i:i + n], z["y"][i:i + n], z["e"][i:i + n]))
            i += n
        return cls(fps)

    @classmethod
    def read_catalog_fits(cls, path, extname="COSMIC_RAYS"):
        """Read the reference's measured CR footprint catalog
        (imsim/cosmic_rays.py:112-147): a FITS binary table of spans
        with columns fp_id (int), x0, y0 (span start pixel) and
        pixel_values (variable-length int array along +x).  Spans with
        the same fp_id form one footprint; each span's pixels become
        (dx, dy, e-) samples relative to the footprint's first span.

        Returns (catalog, ccd_rate) with ccd_rate = n_footprints /
        EXPTIME from the table header (the reference's default rate
        derivation, :123-126)."""
        from ..io.fits import read_bintable, read_fits

        for hdr, payload in read_fits(path):
            if str(hdr.get("EXTNAME", "")).strip() == extname:
                break
        else:
            raise KeyError(f"no {extname} extension in {path}")
        tab = read_bintable(hdr, payload)
        fps = {}
        for fp, x0, y0, vals in zip(tab["fp_id"], tab["x0"], tab["y0"],
                                    tab["pixel_values"]):
            fps.setdefault(int(fp), []).append(
                (int(x0), int(y0), np.asarray(vals, float)))
        out = []
        for spans in fps.values():
            ox, oy = spans[0][0], spans[0][1]
            xs, ys, es = [], [], []
            for x0, y0, vals in spans:
                xs.append(np.arange(len(vals), dtype=float) + (x0 - ox))
                ys.append(np.full(len(vals), float(y0 - oy)))
                es.append(vals)
            out.append((np.concatenate(xs), np.concatenate(ys),
                        np.concatenate(es)))
        exptime = float(hdr.get("EXPTIME", 1.0))
        return cls(out), len(out) / max(exptime, 1e-9)

    def write_catalog_fits(self, path, exptime, num_pix=16_000_000,
                           extname="COSMIC_RAYS"):
        """Write the reference-format span catalog (the inverse of
        read_catalog_fits; imsim/cosmic_rays.py:150-185): footprint
        pixels quantized to integer-pixel runs along +x."""
        from ..io.fits import HDU, BinTableHDU, write_fits

        fp_id, x0s, y0s, vals = [], [], [], []
        for i, (x, y, e) in enumerate(self.footprints):
            ix = np.round(x).astype(int)
            iy = np.round(y).astype(int)
            for yy in np.unique(iy):
                m = iy == yy
                xs = ix[m]
                es = e[m]
                order = np.argsort(xs)
                xs, es = xs[order], es[order]
                # split into contiguous runs
                brk = np.nonzero(np.diff(xs) != 1)[0] + 1
                for seg_x, seg_e in zip(np.split(xs, brk),
                                        np.split(es, brk)):
                    fp_id.append(i)
                    x0s.append(int(seg_x[0]))
                    y0s.append(int(yy))
                    vals.append(np.asarray(seg_e, np.int32))
        hdu = BinTableHDU(
            dict(fp_id=np.asarray(fp_id, np.int32),
                 x0=np.asarray(x0s, np.int16),
                 y0=np.asarray(y0s, np.int16),
                 pixel_values=vals),
            name=extname,
            header={"EXPTIME": exptime, "NUM_PIX": num_pix})
        write_fits(path, [HDU(None, is_primary=True), hdu])


_default_catalog = None


def get_default_catalog() -> CosmicRayCatalog:
    global _default_catalog
    if _default_catalog is None:
        _default_catalog = CosmicRayCatalog.synthesize()
    return _default_catalog


def cosmic_ray_hits(shape, exptime: float, seed: int,
                    ccd_rate=CR_RATE_DEFAULT,
                    catalog: CosmicRayCatalog | None = None):
    """The in-frame hits of Poisson(rate x exptime x area) CRs at uniform
    positions, in the JAX package's draw order: (flat pixel index int64,
    charge float64), in painting order."""
    catalog = catalog or get_default_catalog()
    rng = np.random.default_rng(seed)
    ny, nx = shape
    area_cm2 = nx * ny * PIXEL_CM * PIXEL_CM
    n_cr = rng.poisson(ccd_rate * exptime * area_cm2)
    pix, charge = [], []
    for _ in range(n_cr):
        fx, fy, fe = catalog.footprints[rng.integers(0, len(catalog))]
        x0 = rng.uniform(0, nx)
        y0 = rng.uniform(0, ny)
        ix = np.round(fx + x0).astype(int)
        iy = np.round(fy + y0).astype(int)
        m = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
        pix.append(iy[m].astype(np.int64) * nx + ix[m])
        charge.append(np.asarray(fe[m], np.float64))
    if not pix:
        return np.zeros(0, np.int64), np.zeros(0, np.float64)
    return np.concatenate(pix), np.concatenate(charge)


def paint_cosmic_rays(image: torch.Tensor, exptime: float, seed: int,
                      ccd_rate=CR_RATE_DEFAULT,
                      catalog: CosmicRayCatalog | None = None) -> torch.Tensor:
    """Add the CR hits of cosmic_ray_hits to the (H, W) float32 image in
    place, on its device, and return it.  A pixel hit k times takes k
    float64 adds, each rounded to float32, in hit order (numpy's add.at on
    a float32 frame): one index_put_ per hit rank, each over distinct
    pixels."""
    pix, charge = cosmic_ray_hits(image.shape, exptime, seed, ccd_rate,
                                  catalog)
    if not len(pix):
        return image
    # rank of each hit among the earlier hits of its pixel
    order = np.argsort(pix, kind="stable")
    first = np.r_[True, pix[order][1:] != pix[order][:-1]]
    start = np.maximum.accumulate(np.where(first, np.arange(len(pix)), 0))
    rank = np.empty(len(pix), np.int64)
    rank[order] = np.arange(len(pix)) - start
    flat = image.view(-1)
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        idx = torch.as_tensor(pix[sel], device=image.device)
        add = torch.as_tensor(charge[sel], device=image.device)
        flat.index_put_((idx,), (flat[idx].to(torch.float64) + add).to(
            torch.float32))
    return image
