"""The skyCatalogs workload, generated from a seed with numpy only (no
pandas or pyarrow: it is written on the card's machine too):

    python -m imsim_tpu_torch.benchmarks.skycat_workload OUT_DIR [--seed 0]

writes under OUT_DIR

  * `seds/`: the SED library of benchmarks/instcat_workload (200 star and
    100 galaxy SEDs);
  * (a) `skycat_r22_s11.parquet`, the mapped (DC2-style) schema at full
    width: 120,000 rows uniform over R22_S11's pixel box widened by 300
    px (mapped to RA/Dec through the port's WCS of that CCD at the bench
    pointing), a quarter stars, the rest galaxies with the bulge / disk /
    knots columns `catalog/skycat._expand_components` reads (knots on
    about 10%), the instcat workload's size, index, shear and dust draws,
    magnorms set so that the CCD carries about 1e8 photons in r, 24
    bright stars above the FFT threshold; a few null fields (the bulge's
    Sersic index, the disk's minor axis, the knots' flux ratio), so that
    the expanded columns' fallbacks run;
  * (b) `native/skycat.yaml` with the tophat bins, and
    `native/pointsource_<hp>.parquet` / `native/galaxy_<hp>.parquet` for
    the healpix pixels (nside 32, ring) under the CCD: 1,000 stars and
    10,000 galaxies over the full frame (fewer than (a): every component
    builds its own inline SED on the host), the galaxies with
    `sed_val_{bulge,disk,knots}` list columns;
  * (c) `sensor_models/lsst_{e2v,itl}_synth.dat` and `.cfg`: Poisson-solver
    vertex files forward-generated from a known radial BF potential (so a
    config names them `lsst_{vendor}_synth`);
  * (d) `tables/visits.csv` and `tables/sensors.parquet`, small tables for
    RowData.

The parquet writer here writes the least the workload needs: one row
group, one uncompressed page a column, OPTIONAL columns with definition
levels (bit-packed runs), PLAIN values except `sed_filepath`, which is
RLE_DICTIONARY as skyCatalogs writes it, and the three-level LIST.  It
writes workload files only; nothing in the package's user path calls it.
"""
from __future__ import annotations

import argparse
import hashlib
import os

import numpy as np

from . import instcat_workload as IW

DET = "R22_S11"
# the visit: the instance-catalog workload's header as opsim_meta
OPSIM_META = dict(fieldRA=30.0, fieldDec=-20.0, observationStartMJD=60674.2,
                  band="r", rawSeeing=0.7, exptime=30.0, rotTelPos=0.0,
                  observationId=181000, altitude=60.0, moonRA=100.0,
                  moonDec=10.0, moonAlt=20.0, moonPhase=30.0, sunAlt=-35.0)
NSIDE = 32
# 30 tophat bins, 1000-17000 A, log-spaced starts (cosmoDC2-like)
_EDGES = np.round(np.geomspace(1000.0, 17000.0, 31))
TOPHAT_BINS = [[float(a), float(b - a)] for a, b in zip(_EDGES[:-1],
                                                         _EDGES[1:])]
# the synthetic sensor models: K(r) = amp / sqrt(r^2 + core^2) [per e-]
SENSOR_MODELS = {"e2v": (1.5e-6, 0.6), "itl": (1.2e-6, 0.55)}
SENSOR_MODEL_NAME = "lsst_{vendor}_synth"


# ---- a minimal parquet writer ----------------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag(v: int) -> bytes:
    return _varint((v << 1) ^ (v >> 63))


def _thrift(fields: list) -> bytes:
    """A Thrift compact struct from [(field id, kind, value)], ids rising;
    kind 'i32' / 'i64' / 'bin' / 'struct' (value: a field list) /
    'list' (value: (element kind, items))."""
    out, last = bytearray(), 0
    code = {"i32": 5, "i64": 6, "bin": 8, "list": 9, "struct": 12}
    for fid, kind, value in fields:
        delta = fid - last
        out.append((delta << 4) | code[kind] if 0 < delta < 16 else
                   code[kind])
        if not 0 < delta < 16:
            out += _zigzag(fid)
        out += _thrift_value(kind, value)
        last = fid
    out.append(0)
    return bytes(out)


def _thrift_value(kind, value) -> bytes:
    if kind in ("i32", "i64"):
        return _zigzag(int(value))
    if kind == "bin":
        b = value.encode() if isinstance(value, str) else bytes(value)
        return _varint(len(b)) + b
    if kind == "struct":
        return _thrift(value)
    ekind, items = value
    code = {"i32": 5, "i64": 6, "bin": 8, "struct": 12}[ekind]
    head = bytes([(len(items) << 4) | code]) if len(items) < 15 else \
        bytes([0xF0 | code]) + _varint(len(items))
    return head + b"".join(_thrift_value(ekind, v) for v in items)


def _bitpacked(values: np.ndarray, width: int) -> bytes:
    """One bit-packed run of the RLE / bit-packed hybrid (values padded
    with zeros to a multiple of 8)."""
    n = len(values)
    groups = (n + 7) // 8
    v = np.zeros(groups * 8, np.uint64)
    v[:n] = values
    bits = ((v[:, None] >> np.arange(width, dtype=np.uint64)) & 1)
    packed = np.packbits(bits.astype(np.uint8).ravel(), bitorder="little")
    return _varint((groups << 1) | 1) + packed.tobytes()


def _levels(values: np.ndarray, max_level: int) -> bytes:
    body = _bitpacked(values, int(max_level).bit_length())
    return len(body).to_bytes(4, "little") + body


def _plain(kind: str, values) -> bytes:
    if kind == "f64":
        return np.asarray(values, "<f8").tobytes()
    if kind == "i64":
        return np.asarray(values, "<i8").tobytes()
    return b"".join(len(b).to_bytes(4, "little") + b
                    for b in (str(s).encode() for s in values))


_PTYPE = {"f64": 5, "i64": 2, "str": 6}


def write_parquet(path: str, columns: dict, dictionary=()) -> None:
    """`columns`: {name: values}, float64 (NaN written as null), int64,
    an object array of str (None as null) or an object array of float
    arrays (a list column; None as a null list).  Names in `dictionary`
    are RLE_DICTIONARY-encoded."""
    n_rows = len(next(iter(columns.values())))
    body = bytearray(b"PAR1")
    schema = [[(4, "bin", "schema"), (5, "i32", len(columns))]]
    chunks = []
    for name, vals in columns.items():
        vals = np.asarray(vals)
        is_list = vals.dtype == object and any(
            isinstance(v, np.ndarray) for v in vals)
        if is_list:
            kind = "f64"
            null_row = np.array([v is None for v in vals])
            lens = np.array([0 if v is None else len(v) for v in vals])
            # one level entry per element, or one for an empty / null list
            n_ent = np.maximum(lens, 1)
            rep = np.ones(int(n_ent.sum()), np.int64)
            rep[np.concatenate([[0], np.cumsum(n_ent)[:-1]])] = 0
            dfn = np.repeat(np.where(null_row, 0, np.where(lens == 0, 1, 3)),
                            n_ent)
            present = np.concatenate([np.asarray(v, float) for v in vals
                                      if v is not None and len(v)] or
                                     [np.zeros(0)])
            max_def, max_rep = 3, 1
            levels = _levels(rep, max_rep) + _levels(dfn, max_def)
            n_values = len(dfn)
            path_in_schema = [name, "list", "element"]
            schema += [
                [(3, "i32", 1), (4, "bin", name), (5, "i32", 1),
                 (6, "i32", 3), (10, "struct", [(3, "struct", [])])],
                [(3, "i32", 2), (4, "bin", "list"), (5, "i32", 1)],
                [(1, "i32", 5), (3, "i32", 1), (4, "bin", "element")]]
        else:
            kind = ("f64" if vals.dtype.kind == "f" else
                    "i64" if vals.dtype.kind in "iu" else "str")
            null = (np.isnan(vals) if kind == "f64" else
                    np.array([v is None for v in vals]) if kind == "str"
                    else np.zeros(n_rows, bool))
            present = vals[~null]
            levels = _levels((~null).astype(np.int64), 1)
            n_values = n_rows
            path_in_schema = [name]
            elem = [(1, "i32", _PTYPE[kind]), (3, "i32", 1),
                    (4, "bin", name)]
            if kind == "str":
                elem += [(6, "i32", 0), (10, "struct", [(1, "struct", [])])]
            schema.append(elem)
        start = len(body)
        dict_offset = None
        if name in dictionary:
            uniq, idx = np.unique(present.astype(str), return_inverse=True)
            page = _plain(kind, uniq)
            body += _thrift([(1, "i32", 2), (2, "i32", len(page)),
                             (3, "i32", len(page)),
                             (7, "struct", [(1, "i32", len(uniq)),
                                            (2, "i32", 0)])])
            body += page
            dict_offset = start
            width = max(1, int(len(uniq) - 1).bit_length())
            values = bytes([width]) + _bitpacked(idx, width)
            encoding = 8
        else:
            values = _plain(kind, present)
            encoding = 0
        data_offset = len(body)
        page = levels + values
        body += _thrift([(1, "i32", 0), (2, "i32", len(page)),
                         (3, "i32", len(page)),
                         (5, "struct", [(1, "i32", n_values),
                                        (2, "i32", encoding),
                                        (3, "i32", 3), (4, "i32", 3)])])
        body += page
        size = len(body) - start
        meta = [(1, "i32", _PTYPE[kind]),
                (2, "list", ("i32", [3, encoding] + ([0] if dict_offset
                                                      is not None else []))),
                (3, "list", ("bin", path_in_schema)), (4, "i32", 0),
                (5, "i64", n_values), (6, "i64", size), (7, "i64", size),
                (9, "i64", data_offset)]
        if dict_offset is not None:
            meta.append((11, "i64", dict_offset))
        chunks.append([(2, "i64", start), (3, "struct", meta)])
    total = len(body) - 4
    footer = _thrift([
        (1, "i32", 1), (2, "list", ("struct", schema)),
        (3, "i64", n_rows),
        (4, "list", ("struct", [[(1, "list", ("struct", chunks)),
                                 (2, "i64", total), (3, "i64", n_rows)]])),
        (6, "bin", "imsim_tpu_torch skycat_workload")])
    body += footer + len(footer).to_bytes(4, "little") + b"PAR1"
    with open(path, "wb") as f:
        f.write(bytes(body))


# ---- the workload ----------------------------------------------------------

def visit_config(catalog: str, sed_dir: str, over: dict | None = None):
    """The sky-catalog template over `catalog` at the workload's visit
    (opsim_meta), with `over` (dotted keys)."""
    return {"template": "imsim-config-skycat",
            "input.sky_catalog.file_name": catalog,
            "input.sky_catalog.sed_dir": sed_dir,
            "opsim_meta": dict(OPSIM_META), **(over or {})}


def visit_context(catalog: str, sed_dir: str, over: dict | None = None):
    """config.runner.build_visit_context of visit_config."""
    from ..config.interpreter import load_config
    from ..config.runner import build_visit_context

    return build_visit_context(load_config(visit_config(catalog, sed_dir,
                                                        over)))


def _box(ctx, det_name, window):
    """(wcs, x0, y0, w, h): the CCD's WCS and the pixel box (or its
    central window) that the objects fill."""
    from ..convert import ccd_optics

    ccd = ctx.camera[det_name]
    nx, ny = ccd.bounds.width, ccd.bounds.height
    wcs = ccd_optics(ctx.wcs_factory, ccd)[0]
    if window is None:
        return wcs, 0.0, 0.0, float(nx), float(ny)
    h, w = (float(v) for v in window)
    return wcs, (nx - w) / 2, (ny - h) / 2, w, h


def _magnorm(flux, rate, exptime):
    from ..catalog.instcat import RUBIN_AREA

    return -np.log(flux / (RUBIN_AREA * exptime * np.maximum(rate, 1e-30))
                   ) / 0.9210340371976184


def _nulls(rng, a, k):
    """a with k random entries set to NaN (nulls in the file)."""
    a = np.array(a, float)
    a[rng.choice(len(a), size=min(k, len(a)), replace=False)] = np.nan
    return a


def mapped_columns(rng, ctx, det_name, window, n, margin, n_bright,
                   total_photons, edge_pix, stars, gals, rate_star,
                   rate_gal, z_grid) -> dict:
    """The mapped-schema catalog's columns over one CCD (see the module
    docstring)."""
    wcs, x0, y0, w, h = _box(ctx, det_name, window)
    gal = rng.uniform(0, 1, n) >= 0.25
    gal[:n_bright] = False
    x = rng.uniform(x0 - margin, x0 + w + margin, n)
    y = rng.uniform(y0 - margin, y0 + h + margin, n)
    x[:n_bright] = rng.uniform(x0, x0 + w, n_bright)
    y[:n_bright] = rng.uniform(y0, y0 + h, n_bright)
    ra, dec = wcs.xy_to_radec(x, y)
    ra, dec = np.degrees(ra) % 360.0, np.degrees(dec)
    # the disk and the bulge: major axis, axis ratio, Sersic index
    disk_a = np.clip(rng.lognormal(np.log(0.45), 0.6, n), 0.05, 3.0)
    disk_q = rng.uniform(0.3, 1.0, n)
    bulge_a = disk_a * rng.uniform(0.2, 0.6, n)
    bulge_q = rng.uniform(0.5, 1.0, n)
    n_bulge = np.clip(rng.normal(3.5, 0.6, n), 1.5, 6.0)
    n_disk = np.clip(rng.normal(1.0, 0.2, n), 0.5, 2.0)
    bulge_frac = rng.uniform(0.0, 0.6, n)
    knotty = gal & (rng.uniform(0, 1, n) < 0.1)
    n_knots = np.where(knotty, rng.integers(5, 41, n), 0)
    knots_ratio = np.where(knotty, rng.uniform(0.1, 0.4, n), 0.0)
    pa = np.degrees(rng.uniform(0, np.pi, n))
    gamma = np.where(gal[:, None], rng.normal(0, 0.02, (n, 2)), 0.0)
    kappa = np.where(gal, rng.normal(0, 0.01, n), 0.0)
    sed_idx = np.where(gal, rng.integers(0, len(gals), n),
                       rng.integers(0, len(stars), n))
    z = np.where(gal, np.round(rng.uniform(0.05, 2.5, n), 4), 0.0)
    mw_av = np.round(rng.uniform(0.0, 0.3, n), 3)
    # fluxes: the instance-catalog workload's draw over the kept objects
    raw = 10 ** rng.uniform(0.0, 2.4, n) ** 1.35
    kept = ((x >= x0 - edge_pix) & (x <= x0 + w + edge_pix)
            & (y >= y0 - edge_pix) & (y <= y0 + h + edge_pix))
    flux = raw / raw[kept].sum() * total_photons
    flux[:n_bright] = 10 ** rng.uniform(*IW.BRIGHT_LOG_FLUX, n_bright)
    f = z / z_grid[1]
    j = np.minimum(f.astype(int), len(z_grid) - 2)
    k = np.where(gal, sed_idx, 0)
    rate = np.where(gal, rate_gal[k, j] * (j + 1 - f) + rate_gal[k, j + 1]
                    * (f - j), rate_star[np.where(gal, 0, sed_idx)])
    magnorm = _magnorm(flux, rate, float(ctx.opsim.get("exptime", 30.0)))
    galf = np.where(gal, 1.0, np.nan)
    k_null = max(1, n // 6000)
    return {
        "id": np.arange(n, dtype=np.int64),
        "ra": ra, "dec": dec,
        "object_type": np.where(gal, "galaxy", "star").astype(object),
        "magnorm": magnorm,
        "sed_filepath": np.array([gals[i] if g else stars[i]
                                  for i, g in zip(sed_idx, gal)], object),
        "redshift": z,
        "shear_1": gamma[:, 0], "shear_2": gamma[:, 1], "convergence": kappa,
        "MW_av": mw_av, "MW_rv": np.full(n, 3.1),
        # the single-component columns (the stars' own; the galaxies'
        # disk, the expanded columns' fallbacks)
        "size_true": np.where(gal, disk_a * np.sqrt(disk_q), 0.0),
        "sersic_index": np.where(gal, n_disk, 1.0),
        "axis_ratio": np.where(gal, disk_q, 1.0),
        "position_angle": np.where(gal, pa, 0.0),
        "size_bulge_true": bulge_a * galf,
        "size_minor_bulge_true": bulge_a * bulge_q * galf,
        "sersic_bulge": _nulls(rng, n_bulge * galf, k_null),
        "size_disk_true": disk_a * galf,
        "size_minor_disk_true": _nulls(rng, disk_a * disk_q * galf, k_null),
        "sersic_disk": n_disk * galf,
        "bulge_frac": bulge_frac * galf,
        "knots_flux_ratio": _nulls(rng, knots_ratio * galf, k_null),
        "n_knots": n_knots.astype(float) * galf,
    }


def native_files(rng, ctx, det_name, window, n_gal, n_star, margin,
                 stars, rate_star, total_photons, out_dir, sed_dir) -> list:
    """The native catalog: its yaml and healpix files (see the module
    docstring); returns the parquet paths."""
    from ..catalog.skycat_native import ang2pix_ring, tophat_sed

    os.makedirs(out_dir, exist_ok=True)
    wcs, x0, y0, w, h = _box(ctx, det_name, window)
    exptime = float(ctx.opsim.get("exptime", 30.0))
    n = n_gal + n_star

    def sky(m):
        x = rng.uniform(x0 - margin, x0 + w + margin, m)
        y = rng.uniform(y0 - margin, y0 + h + margin, m)
        ra, dec = wcs.xy_to_radec(x, y)
        return np.degrees(ra) % 360.0, np.degrees(dec)

    flux = 10 ** rng.uniform(0.0, 2.4, n) ** 1.35
    flux *= total_photons / flux.sum()
    # stars
    sra, sdec = sky(n_star)
    sidx = rng.integers(0, len(stars), n_star)
    star = {"id": np.arange(n_star, dtype=np.int64) + 10**9,
            "ra": sra, "dec": sdec,
            "magnorm": _magnorm(flux[:n_star], rate_star[sidx], exptime),
            "sed_filepath": np.array([stars[i] for i in sidx], object),
            "MW_av": np.round(rng.uniform(0.0, 0.3, n_star), 3),
            "MW_rv": np.full(n_star, 3.1)}
    # galaxies: components' fluxes from a flat-f_nu tophat's rate at z = 0
    flat = tophat_sed(np.asarray(TOPHAT_BINS), np.ones(len(TOPHAT_BINS)),
                      0.0, 0.0, 3.1)
    rate0 = ctx.bandpass.photon_rate(flat.wave, flat.fphot, 1.0, 1.0)
    gra, gdec = sky(n_gal)
    gflux = flux[n_star:]
    bulge_frac = rng.uniform(0.05, 0.6, n_gal)
    knotty = rng.uniform(0, 1, n_gal) < 0.1
    knots_frac = np.where(knotty, rng.uniform(0.1, 0.4, n_gal), 0.0)
    disk_frac = (1 - bulge_frac) * (1 - knots_frac)
    disk_a = np.clip(rng.lognormal(np.log(0.45), 0.6, n_gal), 0.05, 3.0)
    bulge_a = disk_a * rng.uniform(0.2, 0.6, n_gal)
    z = np.round(rng.uniform(0.05, 2.0, n_gal), 4)
    nb = len(TOPHAT_BINS)
    centre = np.array([b[0] + b[1] / 2 for b in TOPHAT_BINS])

    def seds(m, slope_lo, slope_hi):
        beta = rng.uniform(slope_lo, slope_hi, m)
        vals = (centre[None, :] / 5000.0) ** beta[:, None] * rng.uniform(
            0.8, 1.2, (m, nb))
        return np.array(list(vals), object)

    def mag(frac):
        with np.errstate(divide="ignore"):
            return _magnorm(gflux * frac, np.full(n_gal, rate0), exptime)

    knots_sed = seds(n_gal, 0.5, 2.0)
    knots_sed[~knotty] = None
    gal = {"galaxy_id": np.arange(n_gal, dtype=np.int64),
           "ra": gra, "dec": gdec, "redshift": z,
           "shear_1": rng.normal(0, 0.02, n_gal),
           "shear_2": rng.normal(0, 0.02, n_gal),
           "convergence": rng.normal(0, 0.01, n_gal),
           "position_angle_unlensed": np.degrees(rng.uniform(0, np.pi,
                                                             n_gal)),
           "MW_av": np.round(rng.uniform(0.0, 0.3, n_gal), 3),
           "MW_rv": np.full(n_gal, 3.1),
           "size_bulge_true": bulge_a,
           "size_minor_bulge_true": bulge_a * rng.uniform(0.5, 1.0, n_gal),
           "sersic_bulge": np.clip(rng.normal(3.5, 0.6, n_gal), 1.5, 6.0),
           "size_disk_true": disk_a,
           "size_minor_disk_true": disk_a * rng.uniform(0.3, 1.0, n_gal),
           "sersic_disk": np.clip(rng.normal(1.0, 0.2, n_gal), 0.5, 2.0),
           "bulge_magnorm": mag(bulge_frac),
           "disk_magnorm": mag(disk_frac),
           "knots_magnorm": np.where(knotty, mag(knots_frac), np.nan),
           "n_knots": np.where(knotty, rng.integers(5, 41, n_gal),
                               0).astype(float),
           "sed_val_bulge": seds(n_gal, -1.0, 0.5),
           "sed_val_disk": seds(n_gal, 0.0, 1.5),
           "sed_val_knots": knots_sed}
    paths = []
    for prefix, cols in (("pointsource", star), ("galaxy", gal)):
        hp = ang2pix_ring(NSIDE, cols["ra"], cols["dec"])
        for p in np.unique(hp):
            sel = hp == p
            path = os.path.join(out_dir, f"{prefix}_{p}.parquet")
            write_parquet(path, {k: v[sel] for k, v in cols.items()},
                          dictionary=("sed_filepath",))
            paths.append(path)
    bins = ", ".join(f"[{a:.1f}, {b:.1f}]" for a, b in TOPHAT_BINS)
    with open(os.path.join(out_dir, "skycat.yaml"), "w") as f:
        f.write(
            "catalog_name: skycat_workload\n"
            "catalog_dir: .\n"
            f"area_partition: {{type: healpix, ordering: ring, "
            f"nside: {NSIDE}}}\n"
            "SED_models:\n"
            "  tophat:\n"
            "    units: angstrom\n"
            f"    bins: [{bins}]\n"
            "object_types:\n"
            "  galaxy:\n"
            "    file_template: 'galaxy_(?P<healpix>\\d+).parquet'\n"
            "    data_file_type: parquet\n"
            "    sed_model: tophat\n"
            "    composite: {bulge: required, disk: required, "
            "knots: optional}\n"
            "  bulge_basic: {parent: galaxy, subtype: bulge, "
            "sed_model: tophat, spatial_model: sersic2D}\n"
            "  disk_basic: {parent: galaxy, subtype: disk, "
            "sed_model: tophat, spatial_model: sersic2D}\n"
            "  knots_basic: {parent: galaxy, subtype: knots, "
            "sed_model: tophat, spatial_model: knots}\n"
            "  star:\n"
            "    file_template: 'pointsource_(?P<healpix>\\d+).parquet'\n"
            "    data_file_type: parquet\n"
            "    sed_model: file_nm\n"
            f"    sed_file_root: '{sed_dir}'\n")
    return paths


def synth_vertex_file(path: str, q=100000.0, amp=2.0e-6, core=0.7, npix=9,
                      nv=8, pix=10.0):
    """A Poisson solver's vertex file forward-generated from the radial
    potential K(r) = amp / sqrt(r^2 + core^2) [r in px]: each boundary
    vertex of the 9 x 9 stamp shifts by Q grad(K) at its undistorted
    place (the logic of tests/test_sensor_model.py's generator), and the
    .cfg beside it."""
    cx = (npix // 2 + 1) * pix + pix / 2
    lines = ["X0             Y0             Theta          X"
             "              Y              "]
    thetas = (np.arange(4 * nv + 4) + 0.5) / (4 * nv + 4) * 2 * np.pi
    thetas = np.sort(np.where(thetas > np.pi, thetas - 2 * np.pi, thetas))
    for iy in range(npix):
        for ix in range(npix):
            x0 = (ix + 1) * pix + pix / 2
            y0 = (iy + 1) * pix + pix / 2
            for t in thetas:
                s = (pix / 2) / max(abs(np.cos(t)), abs(np.sin(t)))
                vx, vy = x0 + s * np.cos(t), y0 + s * np.sin(t)
                rx, ry = vx - cx, vy - cx
                r_px = np.hypot(rx, ry) / pix
                if r_px > 1e-9:
                    mr = q * (-amp * r_px / (r_px**2 + core**2) ** 1.5) * pix
                    vx += mr * rx / (r_px * pix)
                    vy += mr * ry / (r_px * pix)
                lines.append(f"{x0:<15.4f}{y0:<15.4f}{t:<15.4f}"
                             f"{vx:<15.4f}{vy:<15.4f}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(path[:-4] + ".cfg", "w") as f:
        f.write(f"# synthetic Poisson-solver run\nPixelSizeX = {pix}\n"
                f"CollectedCharge_0_0 = {int(q)}\n"
                f"FilledPixelCoords_0_0 = {cx} {cx}\n")


def write_row_tables(out_dir: str) -> dict:
    """(d): visits.csv (observationId, seeing, airmass, note) and
    sensors.parquet (vendor, strength, diffusion_um)."""
    os.makedirs(out_dir, exist_ok=True)
    csv = os.path.join(out_dir, "visits.csv")
    with open(csv, "w") as f:
        f.write("observationId,seeing,airmass,note\n"
                "181000,0.7,1.1547,bench\n"
                "181001,0.85,1.2,\"later, windy\"\n"
                "181002,1.05,,no airmass\n")
    pq = os.path.join(out_dir, "sensors.parquet")
    write_parquet(pq, {"vendor": np.array(["E2V", "ITL"], object),
                       "strength": np.array([1.0, 1.0]),
                       "diffusion_um": np.array([4.0, 4.5])})
    return {"csv": csv, "parquet": pq}


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def write_workload(out_dir: str, seed: int = 0, n_rows: int = 120_000,
                   det_name: str = DET, margin: float = 300.0, window=None,
                   n_bright: int = 24, total_photons: float = 1.6e8,
                   edge_pix: float = 100.0, n_gal_native: int = 10_000,
                   n_star_native: int = 1_000,
                   native_photons: float = 1.0e7) -> dict:
    """Write the workload; returns dict(catalog: (a)'s parquet, native:
    (b)'s yaml, sed_dir, sensor_model_dir, tables: (d)'s paths, sha256:
    {relative path: digest} of every parquet file).  window=(h, w) puts
    (a) and (b) over the CCD's central window instead (tests and
    rehearsals)."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    sed_dir = os.path.join(out_dir, "seds")
    stars, gals = IW.write_sed_library(sed_dir, rng)
    catalog = os.path.join(out_dir, f"skycat_{det_name.lower()}.parquet")
    ctx = visit_context(catalog, sed_dir)
    z_grid = np.linspace(0.0, 2.5, 51)
    rate_star = IW._rates(stars, sed_dir, ctx.bandpass, z_grid[:1])[:, 0]
    rate_gal = IW._rates(gals, sed_dir, ctx.bandpass, z_grid)
    write_parquet(catalog, mapped_columns(
        rng, ctx, det_name, window, n_rows, margin, n_bright, total_photons,
        edge_pix, stars, gals, rate_star, rate_gal, z_grid),
        dictionary=("sed_filepath",))
    native_dir = os.path.join(out_dir, "native")
    paths = [catalog] + native_files(
        np.random.default_rng((seed, 1)), ctx, det_name, window,
        n_gal_native, n_star_native, margin, stars, rate_star,
        native_photons, native_dir, sed_dir)
    sm_dir = os.path.join(out_dir, "sensor_models")
    os.makedirs(sm_dir, exist_ok=True)
    for vendor, (amp, core) in SENSOR_MODELS.items():
        synth_vertex_file(os.path.join(sm_dir, SENSOR_MODEL_NAME.format(
            vendor=vendor) + ".dat"), amp=amp, core=core)
    tables = write_row_tables(os.path.join(out_dir, "tables"))
    return dict(catalog=catalog,
                native=os.path.join(native_dir, "skycat.yaml"),
                sed_dir=sed_dir, sensor_model_dir=sm_dir, tables=tables,
                sha256={os.path.relpath(p, out_dir): _sha256(p)
                        for p in paths})


# ---- the digest (chip_smoke gate (w)) ---------------------------------------

DIGEST = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "skycat_r22_s11_digest.npz")


def table_digest(tab) -> dict:
    """An ObjectTable's columns as sha256 digests of their bytes (object
    columns of their reprs; the inline SEDs of their wave and fphot)."""
    out = {"n": np.int64(len(tab))}
    for k in tab.__dataclass_fields__:
        v = np.asarray(getattr(tab, k))
        if k == "sed_obj":
            h = hashlib.sha256()
            for s in v:
                if s is None:
                    h.update(b"none")
                else:
                    h.update(np.ascontiguousarray(s.wave).tobytes())
                    h.update(np.ascontiguousarray(s.fphot).tobytes())
            out[k] = h.hexdigest()
        elif v.dtype == object:
            out[k] = hashlib.sha256("\n".join(
                repr(x) for x in v).encode()).hexdigest()
        else:
            out[k] = str(v.dtype) + ":" + hashlib.sha256(
                np.ascontiguousarray(v).tobytes()).hexdigest()
    return out


def table_mismatches(got: dict, want: dict) -> list:
    """The table digest's keys that differ."""
    return sorted(k for k in want if str(got.get(k)) != str(want[k]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    res = write_workload(args.out_dir, args.seed)
    for path, digest in res["sha256"].items():
        print(f"{path} sha256 {digest}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
