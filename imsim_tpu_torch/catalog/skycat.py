"""The sky-catalog interface (imsim_tpu/catalog/skycat.py counterpart,
host numpy): skyCatalogs-style object files read into the port's
ObjectTable, culled to a CCD's pixel box.

Two forms: one or more flat files (parquet or CSV) with a column mapping
(DC2-era and newer names both load; DC2's per-component bulge / disk /
knots columns expand each galaxy into component rows), or the native
skyCatalogs yaml with its healpix files (catalog/skycat_native).  The
files are read by catalog/table (io/parquet for parquet), whose columns
hold the values pandas 3 gives, so every step below is the JAX
package's arithmetic on the same arrays.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..utils.coords import DEG
from .instcat import KNOTS, ObjectTable, POINT, SERSIC
from .table import concat, isna, read_csv, read_table

# the default column mapping (DC2 / skyCatalogs names)
DEFAULT_COLUMNS = dict(
    id="id", ra="ra", dec="dec",
    magnorm="magnorm",
    sed="sed_filepath",
    redshift="redshift",
    obj_kind="object_type",        # 'star' | 'galaxy' | ...
    hlr="size_true",               # arcsec (half-light radius)
    sersic="sersic_index",
    q="axis_ratio",
    beta="position_angle",         # degrees
    g1="shear_1", g2="shear_2", kappa="convergence",
    mw_av="MW_av", mw_rv="MW_rv",
)


@dataclass
class SkyCatalogInterface:
    """One or more catalog files (or a native yaml), serving culled
    ObjectTables.  obj_types filters by kind; apply_dc2_dilation dilates
    galaxy sizes by sqrt(a/b), so that the catalog's half-light radius
    is the semi-major axis (DC2's convention); skycatalog_root overrides
    the native catalog's root directory."""

    file_name: str | list
    columns: dict | None = None
    obj_types: tuple | None = None
    apply_dc2_dilation: bool = False
    skycatalog_root: str | None = None

    def __post_init__(self):
        files = ([self.file_name] if isinstance(self.file_name, str)
                 else list(self.file_name))
        self.native = None
        if len(files) == 1 and files[0].endswith((".yaml", ".yml")):
            from .skycat_native import NativeSkyCatalog

            self.native = NativeSkyCatalog(
                files[0], skycatalog_root=self.skycatalog_root)
            self.df = None
            self.cols = dict(DEFAULT_COLUMNS)
            return
        frames = []
        for f in files:
            if not os.path.exists(f):
                raise OSError(f"sky catalog not found: {f}")
            # parquet by suffix, anything else as CSV (no comments)
            frames.append(read_table(f) if f.endswith((".parquet", ".pq"))
                          else read_csv(f))
        self.df = concat(frames)
        self.cols = dict(DEFAULT_COLUMNS)
        if self.columns:
            self.cols.update(self.columns)

    def _get(self, name, default=None, df=None, cols=None):
        df = self.df if df is None else df
        cols = self.cols if cols is None else cols
        col = cols.get(name)
        if col and col in df:
            return df[col]
        return default

    def _expand_components(self):
        """DC2's multi-component galaxies: where the table carries the
        per-component columns, each galaxy row becomes one row per
        component it can build (bulge: Sersic(sersic_bulge) of
        size_bulge_true and q from size_minor_bulge_true; disk: the same
        from the disk's columns; knots: n_knots points with the disk's
        shape).  The flux splits bulge_frac to the bulge and the rest to
        disk (1 - knots_flux_ratio) and knots; a share whose component
        cannot be built (size <= 0, or n_knots < 1) goes to the others;
        magnorm moves by -2.5 log10(share).  The rows are the stars (and
        other kinds) first, then the bulges, disks and knots in catalog
        order; the expanded columns fall back to the mapped ones where
        null.  Returns (table, mapping) and leaves self as it is."""
        df = self.df
        cols = dict(self.cols)
        if "size_bulge_true" not in df and "size_disk_true" not in df:
            return df, cols
        kind = np.array([str(k).lower() for k in
                         self._get("obj_kind",
                                   np.array(["star"] * len(df), object))],
                        object)
        gal = kind == "galaxy"
        if not gal.any():
            return df, cols
        base = df[~gal]
        g = df[gal]

        def col(name, default):
            return (np.asarray(g[name], float) if name in g
                    else np.full(len(g), default))

        bulge_frac = np.clip(col("bulge_frac", 0.0), 0.0, 1.0)
        knots_ratio = np.clip(col("knots_flux_ratio", 0.0), 0.0, 1.0)
        n_knots = col("n_knots", 0.0)
        size_bulge = col("size_bulge_true", 0.0)
        size_disk = col("size_disk_true", 0.0)
        # the nominal split, less the unbuildable components, renormalized
        f_bulge = bulge_frac * (size_bulge > 0)
        f_disk = (1 - bulge_frac) * (1 - knots_ratio) * (size_disk > 0)
        f_knots = ((1 - bulge_frac) * knots_ratio
                   * ((size_disk > 0) & (n_knots >= 1)))
        total = f_bulge + f_disk + f_knots
        scale = np.where(total > 0, 1.0 / np.maximum(total, 1e-12), 0.0)
        rows = []
        specs = [
            ("bulge", f_bulge * scale, "size_bulge_true",
             "size_minor_bulge_true", col("sersic_bulge", 4.0), None),
            ("disk", f_disk * scale, "size_disk_true",
             "size_minor_disk_true", col("sersic_disk", 1.0), None),
            ("knots", f_knots * scale, "size_disk_true",
             "size_minor_disk_true", None, n_knots),
        ]
        mag = (np.asarray(g[cols["magnorm"]], float)
               if cols["magnorm"] in g else np.full(len(g), 25.0))
        for cname, frac, scol, smcol, sersic, nk in specs:
            size = col(scol, 0.0)
            keep = (frac > 1e-6) & (size > 0)
            if nk is not None:
                keep &= nk >= 1
            if not keep.any():
                continue
            sub = g[keep]
            size_k = size[keep]
            minor = col(smcol, 0.0)[keep]
            sub["object_type_expanded"] = "knots" if cname == "knots" \
                else "galaxy"
            sub["size_true_expanded"] = np.sqrt(
                size_k * np.where(minor > 0, minor, size_k))
            sub["axis_ratio_expanded"] = np.where(
                minor > 0, minor / size_k, 1.0)
            sub["sersic_expanded"] = (nk[keep] if nk is not None
                                      else sersic[keep])
            sub["magnorm_expanded"] = mag[keep] - 2.5 * np.log10(
                np.maximum(frac[keep], 1e-12))
            rows.append(sub)
        if not rows:
            return df, cols
        out = concat([base] + rows)
        # the mapped names point at the expanded columns, which take the
        # mapped column's value where they are null
        for key, newcol in (("obj_kind", "object_type_expanded"),
                            ("hlr", "size_true_expanded"),
                            ("q", "axis_ratio_expanded"),
                            ("sersic", "sersic_expanded"),
                            ("magnorm", "magnorm_expanded")):
            old = cols.get(key)
            out[newcol] = _where_null(out[newcol], out[old] if old in out
                                      else np.nan)
            cols[key] = newcol
        return out, cols

    def _native_table(self, wcs, xsize, ysize, edge_pix, logger):
        """The native catalog: the healpix query around the CCD's corners
        (widened by edge_pix), then the pixel-box cull."""
        if wcs is not None:
            corners = [(-edge_pix, -edge_pix), (xsize + edge_pix, -edge_pix),
                       (xsize + edge_pix, ysize + edge_pix),
                       (-edge_pix, ysize + edge_pix)]
            xs = np.array([c[0] for c in corners], float)
            ys = np.array([c[1] for c in corners], float)
            ra, dec = wcs.xy_to_radec(xs, ys)
            vertices = np.stack([np.asarray(ra) / DEG,
                                 np.asarray(dec) / DEG], -1)
            tab = self.native.get_objects_by_region(
                vertices, obj_types=self.obj_types, logger=logger)
        else:
            # no WCS: every file
            tab = self.native.get_objects_by_region(
                None, obj_types=self.obj_types, logger=logger)
        if self.apply_dc2_dilation and len(tab):
            gal = tab.obj_type != POINT
            qc = np.clip(np.asarray(tab.p2, float), 0.05, 1.0)
            tab.p0 = np.where(gal, tab.p0 / np.sqrt(qc), tab.p0)
        if wcs is not None and len(tab):
            tab = _cull(tab, wcs, xsize, ysize, edge_pix)
        if logger:
            logger.info("skycat (native): %d objects kept", len(tab))
        return tab

    def to_object_table(self, wcs=None, xsize=4096, ysize=4096,
                        edge_pix=100, logger=None) -> ObjectTable:
        """The catalog's objects in the CCD's pixel box widened by
        edge_pix (every object without a WCS), as an ObjectTable."""
        if self.native is not None:
            return self._native_table(wcs, xsize, ysize, edge_pix, logger)
        df, cols = self._expand_components()
        n = len(df)

        def get(name, default=None):
            return self._get(name, default, df=df, cols=cols)

        ra = get("ra") * DEG
        dec = get("dec") * DEG
        kind = get("obj_kind", np.array(["star"] * n, object))
        kind = np.array([str(k).lower() for k in kind], object)
        if self.obj_types:
            keep_kind = np.isin(kind, [k.lower() for k in self.obj_types])
        else:
            keep_kind = np.ones(n, bool)

        obj_type = np.where(kind == "galaxy", SERSIC,
                            np.where(kind == "knots", KNOTS, POINT))
        hlr = np.asarray(get("hlr", np.zeros(n)), float)
        sersic = get("sersic", np.ones(n))
        q = get("q", np.ones(n))
        if self.apply_dc2_dilation:
            gal_row = obj_type != POINT
            qc = np.clip(np.asarray(q, float), 0.05, 1.0)
            hlr = np.where(gal_row, hlr / np.sqrt(qc), hlr)
        beta = get("beta", np.zeros(n)) * DEG
        g1 = get("g1", np.zeros(n))
        g2 = get("g2", np.zeros(n))
        kappa = get("kappa", np.zeros(n))
        g1r = g1 / (1.0 - kappa)
        g2r = g2 / (1.0 - kappa)
        mu = 1.0 / np.maximum((1.0 - kappa) ** 2 - (g1**2 + g2**2), 1e-6)

        sed = get("sed", np.array(["flatSED/sed_flat.txt"] * n, object))
        tab = ObjectTable(
            id=np.asarray(get("id", np.arange(n)), object),
            ra=ra, dec=dec, x=np.zeros(n), y=np.zeros(n),
            magnorm=np.asarray(get("magnorm", np.full(n, 25.0)), float),
            obj_type=obj_type.astype(np.int32),
            p0=np.asarray(hlr, float),
            # p1: the Sersic index of galaxies, n_knots of knots rows
            p1=np.where(obj_type == KNOTS,
                        np.maximum(np.asarray(sersic, float), 1.0),
                        np.clip(np.asarray(sersic, float), 0.3, 6.2)),
            p2=np.clip(np.asarray(q, float), 0.05, 1.0),
            p3=np.asarray(beta, float),
            g1=g1r, g2=g2r, mu=mu,
            sed_name=np.asarray(sed, object),
            redshift=np.asarray(get("redshift", np.zeros(n)), float),
            int_av=np.zeros(n), int_rv=np.full(n, 3.1),
            mw_av=np.asarray(get("mw_av", np.zeros(n)), float),
            mw_rv=np.asarray(get("mw_rv", np.full(n, 3.1)), float),
            image_file=np.array([""] * n, object),
        )
        tab = tab.select(keep_kind)
        if wcs is not None and len(tab):
            tab = _cull(tab, wcs, xsize, ysize, edge_pix)
        if logger:
            logger.info("skycat: %d objects kept", len(tab))
        return tab

    def getNObjects(self):
        if self.native is not None:
            return len(self.native.get_objects_by_region(
                None, obj_types=self.obj_types))
        return len(self.df)


def _where_null(values: np.ndarray, fallback) -> np.ndarray:
    """values.where(values.notna(), fallback): the fallback (a column or
    a scalar) where values is null."""
    null = isna(values)
    if not null.any():
        return values
    fb = np.broadcast_to(np.asarray(fallback), values.shape)
    out = values.astype(np.result_type(values.dtype, fb.dtype)
                        if values.dtype != object else object)
    out[null] = fb[null]
    return out


def _cull(tab: ObjectTable, wcs, xsize, ysize, edge_pix) -> ObjectTable:
    """The objects whose pixel position lies in the box widened by
    edge_pix, with x and y filled."""
    x, y = wcs.radec_to_xy(tab.ra, tab.dec)
    tab.x, tab.y = np.asarray(x, float), np.asarray(y, float)
    keep = ((tab.x >= -edge_pix) & (tab.x <= xsize + edge_pix)
            & (tab.y >= -edge_pix) & (tab.y <= ysize + edge_pix))
    return tab.select(keep)
