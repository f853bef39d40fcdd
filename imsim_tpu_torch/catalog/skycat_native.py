"""The native skyCatalogs format (imsim_tpu/catalog/skycat_native.py
counterpart, host numpy): a yaml catalog config naming object types,
parquet files keyed by healpix pixel, and per-component tophat SEDs,
read into the port's ObjectTable with no external package (the yaml
through config/yaml_subset, the parquet through io/parquet).

  * `area_partition: {type: healpix, ordering: ring, nside: N}`; object
    files match `file_template`, a regex with a `(?P<healpix>\\d+)`
    group; a CCD's query selects the pixels that may overlap it.
  * Galaxy rows are composites: bulge, disk and optional knots, each with
    its tophat SED (`sed_val_<comp>`, one value per bin of
    `SED_models.tophat.bins`, rest frame) and `<comp>_magnorm`; a
    Sersic of half-light radius sqrt(a b) from `size_<comp>_true` and
    `size_minor_<comp>_true`, axis ratio b/a, beta = 90 deg + the
    position angle, index `sersic_<comp>`; knots take the disk's shape
    and `n_knots` points; the shear and convergence lens every
    component.
  * Star rows are points with `sed_filepath` (under the type's
    `sed_file_root`) and `magnorm`; Milky Way CCM dust from MW_av and
    MW_rv on every row.
"""
from __future__ import annotations

import os
import re
import time
from dataclasses import dataclass, field

import numpy as np

from ..config.yaml_subset import safe_load
from ..utils import trace
from ..utils.coords import DEG
from .instcat import KNOTS, ObjectTable, POINT, SERSIC
from .sed import SED
from .table import read_table


def ang2pix_ring(nside: int, ra_deg, dec_deg) -> np.ndarray:
    """The HEALPix ring-ordering pixel of (ra, dec) [deg] (Gorski et al.
    2005), in the JAX package's float64 arithmetic."""
    ra = np.atleast_1d(np.asarray(ra_deg, float))
    dec = np.atleast_1d(np.asarray(dec_deg, float))
    z = np.sin(np.radians(dec))
    phi = np.radians(ra % 360.0)
    za = np.abs(z)
    tt = (2.0 / np.pi) * phi % 4.0
    pix = np.empty(ra.shape, np.int64)

    eq = za <= 2.0 / 3.0
    temp1 = nside * (0.5 + tt[eq])
    temp2 = nside * z[eq] * 0.75
    jp = np.floor(temp1 - temp2).astype(np.int64)
    jm = np.floor(temp1 + temp2).astype(np.int64)
    ir = nside + 1 + jp - jm
    kshift = 1 - (ir & 1)
    ip = ((jp + jm - nside + kshift + 1) // 2) % (4 * nside)
    pix[eq] = 2 * nside * (nside - 1) + (ir - 1) * 4 * nside + ip

    po = ~eq
    tp = tt[po] - np.floor(tt[po])
    tmp = nside * np.sqrt(3.0 * (1.0 - za[po]))
    jp = np.floor(tp * tmp).astype(np.int64)
    jm = np.floor((1.0 - tp) * tmp).astype(np.int64)
    ir = jp + jm + 1
    ip = np.floor(tt[po] * ir).astype(np.int64) % (4 * ir)
    pix[po] = np.where(z[po] > 0, 2 * ir * (ir - 1) + ip,
                       12 * nside * nside - 2 * ir * (ir + 1) + ip)
    return pix


def region_healpix_pixels(vertices_deg, nside: int) -> set[int]:
    """The ring pixels that may overlap a small sky polygon: every pixel
    of a sampled disc of the polygon's circumradius plus 1.2 pixel radii
    around its centre (too many is harmless: absent files are skipped and
    objects are culled by position afterwards)."""
    v = np.asarray(vertices_deg, float)
    ra0 = np.mean(v[:, 0])
    dec0 = np.mean(v[:, 1])
    cosd = max(np.cos(np.radians(dec0)), 1e-6)
    rad = np.max(np.hypot((v[:, 0] - ra0) * cosd, v[:, 1] - dec0))
    pix_rad = np.degrees(np.sqrt(4.0 * np.pi / (12.0 * nside * nside)))
    r = rad + 1.2 * pix_rad
    t = np.linspace(0.0, 2 * np.pi, 64, endpoint=False)
    rr = np.linspace(0.0, 1.0, 24)[:, None]
    ras = ra0 + (r * rr * np.cos(t)) / cosd
    decs = np.clip(dec0 + r * rr * np.sin(t), -90.0, 90.0)
    return set(int(p) for p in ang2pix_ring(nside, ras.ravel(),
                                            decs.ravel()))


def tophat_sed(bins_angstrom: np.ndarray, values: np.ndarray,
               redshift: float, mw_av: float, mw_rv: float) -> SED:
    """The observer-frame SED of tophat bins ((start, width) [A], f_nu
    values): two samples just inside each bin's edges, photon density
    f_nu / lambda, the redshift stretch, normalized at 500 nm for
    magnorm 0, then Milky Way CCM dust."""
    b = np.asarray(bins_angstrom, float)
    vals = np.asarray(values, float)
    order = np.argsort(b[:, 0])
    b, vals = b[order], vals[order]
    lo = b[:, 0] / 10.0
    hi = (b[:, 0] + b[:, 1]) / 10.0
    eps = 1e-4
    wave = np.empty(2 * len(b))
    fnu = np.empty(2 * len(b))
    wave[0::2] = lo + eps
    wave[1::2] = hi - eps
    fnu[0::2] = vals
    fnu[1::2] = vals
    fphot = np.clip(fnu, 0.0, None) / wave
    sed = SED(wave, fphot).at_redshift(float(redshift))
    sed = sed.normalized_magnorm0()
    return sed.extinguished(float(mw_av), float(mw_rv))


@dataclass
class SkyObjectType:
    name: str
    file_template: str | None = None
    sed_model: str | None = None
    sed_file_root: str | None = None
    spatial_model: str | None = None
    subtype: str | None = None
    parent: str | None = None
    composite: dict = field(default_factory=dict)


@dataclass
class NativeSkyCatalog:
    """A skyCatalogs yaml config and its object files; skycatalog_root
    defaults to the yaml's directory."""

    yaml_file: str
    skycatalog_root: str | None = None

    def __post_init__(self):
        # host seconds of the galaxies' inline SEDs, over every read
        self.seconds = {"tophat seds": 0.0}
        with open(self.yaml_file) as f:
            self.cfg = safe_load(f)
        if self.skycatalog_root is None:
            self.skycatalog_root = os.path.dirname(
                os.path.abspath(self.yaml_file))
        part = self.cfg.get("area_partition", {}) or {}
        if part and part.get("type") != "healpix":
            raise ValueError(
                f"unsupported area_partition: {part.get('type')}")
        if part.get("ordering", "ring") != "ring":
            raise ValueError("only ring-ordered healpix is supported")
        self.nside = int(part.get("nside", 32))
        th = (self.cfg.get("SED_models", {}) or {}).get("tophat", {}) or {}
        self.tophat_bins = np.asarray(th.get("bins", []), float)
        if th and th.get("units", "angstrom") != "angstrom":
            raise ValueError("tophat bins must be in angstroms")
        self.object_types: dict[str, SkyObjectType] = {}
        for name, spec in (self.cfg.get("object_types", {}) or {}).items():
            spec = spec or {}
            self.object_types[name] = SkyObjectType(
                name=name,
                file_template=spec.get("file_template"),
                sed_model=spec.get("sed_model"),
                sed_file_root=spec.get("sed_file_root"),
                spatial_model=spec.get("spatial_model"),
                subtype=spec.get("subtype"),
                parent=spec.get("parent"),
                composite=spec.get("composite", {}) or {},
            )

    @property
    def catalog_dir(self) -> str:
        d = self.cfg.get("catalog_dir", ".")
        return os.path.normpath(os.path.join(self.skycatalog_root, d))

    def sed_dirs_hint(self) -> list[str]:
        """The object types' sed_file_root directories that exist (with
        environment variables and ~ expanded): extra places to look for
        SED files."""
        out = []
        for ot in self.object_types.values():
            root = ot.sed_file_root
            if not root:
                continue
            root = os.path.expandvars(os.path.expanduser(root))
            if "$" not in root and os.path.isdir(root):
                out.append(root)
        return out

    def files_for_region(self, obj_type: str, pixels: set[int]) -> list[str]:
        """The catalog directory's files of `obj_type` (names matching its
        template, sorted) whose healpix group is in `pixels` (or that have
        none)."""
        ot = self.object_types[obj_type]
        if not ot.file_template:
            return []
        pat = re.compile(ot.file_template)
        out = []
        try:
            names = sorted(os.listdir(self.catalog_dir))
        except OSError:
            return []
        for name in names:
            m = pat.fullmatch(name)
            if not m:
                continue
            try:
                hp = int(m.group("healpix"))
            except (IndexError, ValueError):
                hp = None
            if hp is None or hp in pixels:
                out.append(os.path.join(self.catalog_dir, name))
        return out

    def component_spec(self, parent: str,
                       subtype: str) -> SkyObjectType | None:
        """The object type of `parent`'s `subtype` component, or None."""
        for ot in self.object_types.values():
            if ot.parent == parent and ot.subtype == subtype:
                return ot
        return None

    def get_objects_by_region(self, vertices_deg, obj_types=None,
                              logger=None) -> ObjectTable:
        """Every object (galaxies as their components) in the files that
        may overlap the polygon (every file for vertices_deg=None); the
        exact cull is the caller's."""
        if vertices_deg is None:
            pixels = set(range(12 * self.nside * self.nside))
        else:
            pixels = region_healpix_pixels(vertices_deg, self.nside)
        want = set(obj_types) if obj_types else None
        tables = []
        for name, ot in self.object_types.items():
            if ot.parent is not None:       # components ride their parent
                continue
            if want is not None and name not in want:
                continue
            for path in self.files_for_region(name, pixels):
                tab = (self._read_galaxy_file(path, name)
                       if ot.composite else self._read_pointlike_file(
                           path, name))
                if len(tab):
                    tables.append(tab)
                if logger:
                    logger.info("skycat: %s -> %d rows", path, len(tab))
        if not tables:
            return _empty_table()
        return _concat_tables(tables)

    def _read_pointlike_file(self, path: str, type_name: str) -> ObjectTable:
        df = read_table(path)
        n = len(df)
        if n == 0:
            return _empty_table()

        def col(name, default=0.0):
            return (np.asarray(df[name], float) if name in df
                    else np.full(n, default))

        sed = (np.asarray(df["sed_filepath"], object)
               if "sed_filepath" in df
               else np.array(["flatSED/sed_flat.txt"] * n, object))
        return ObjectTable(
            id=np.asarray(df["id"], object) if "id" in df
            else np.arange(n).astype(object),
            ra=col("ra") * DEG, dec=col("dec") * DEG,
            x=np.zeros(n), y=np.zeros(n),
            magnorm=col("magnorm", 25.0),
            obj_type=np.full(n, POINT, np.int32),
            p0=np.zeros(n), p1=np.ones(n), p2=np.ones(n), p3=np.zeros(n),
            g1=np.zeros(n), g2=np.zeros(n), mu=np.ones(n),
            sed_name=sed,
            redshift=col("redshift", 0.0),
            int_av=np.zeros(n), int_rv=np.full(n, 3.1),
            mw_av=col("MW_av"), mw_rv=col("MW_rv", 3.1),
            image_file=np.array([""] * n, object),
            sed_obj=np.array([None] * n, object),
        )

    def _read_galaxy_file(self, path: str, type_name: str) -> ObjectTable:
        """Composite galaxy rows: one ObjectTable row per component, each
        with its inline tophat SED."""
        df = read_table(path)
        n = len(df)
        if n == 0:
            return _empty_table()

        def col(name, default=0.0):
            return (np.asarray(df[name], float) if name in df
                    else np.full(n, default))

        gid = (np.asarray(df["galaxy_id"], object) if "galaxy_id" in df
               else np.arange(n).astype(object))
        ra = col("ra") * DEG
        dec = col("dec") * DEG
        z = col("redshift")
        g1 = col("shear_1")
        g2 = col("shear_2")
        kappa = col("convergence")
        # reduced shear and magnification
        g1r = g1 / (1.0 - kappa)
        g2r = g2 / (1.0 - kappa)
        mu = 1.0 / np.maximum((1.0 - kappa) ** 2 - (g1**2 + g2**2), 1e-6)
        # galsim beta = 90 deg + the position angle (E of N)
        beta = np.radians(90.0 + col("position_angle_unlensed"))
        mw_av = col("MW_av")
        mw_rv = col("MW_rv", 3.1)

        parts = []
        comp_names = list(self.object_types[type_name].composite) or \
            ["bulge", "disk", "knots"]
        for comp in comp_names:
            size_comp = "disk" if comp == "knots" else comp
            a = col(f"size_{size_comp}_true")
            b = col(f"size_minor_{size_comp}_true")
            magnorm = col(f"{comp}_magnorm", np.nan)
            sed_col = f"sed_val_{comp}"
            has_sed = sed_col in df
            keep = np.isfinite(magnorm) & (magnorm < 50.0) & (a > 0)
            if comp == "knots":
                keep &= col("n_knots") >= 1
            if not (has_sed and keep.any()):
                continue
            idx = np.nonzero(keep)[0]
            m = len(idx)
            seds = df[sed_col]
            sed_objs = np.empty(m, object)
            t0 = time.perf_counter()
            with trace.span("prep.tophat_seds"):
                for j, i in enumerate(idx):
                    sed_objs[j] = tophat_sed(self.tophat_bins,
                                             np.asarray(seds[i]),
                                             z[i], mw_av[i], mw_rv[i])
            self.seconds["tophat seds"] += time.perf_counter() - t0
            hlr = np.sqrt(a[idx] * np.maximum(b[idx], 1e-12))
            q = np.clip(b[idx] / np.maximum(a[idx], 1e-12), 0.05, 1.0)
            if comp == "knots":
                otype = np.full(m, KNOTS, np.int32)
                p1 = np.maximum(np.round(col("n_knots")[idx]), 1.0)
            else:
                otype = np.full(m, SERSIC, np.int32)
                p1 = np.clip(col(f"sersic_{comp}", 1.0)[idx], 0.3, 6.2)
            parts.append(ObjectTable(
                id=np.array([f"{g}_{comp}" for g in gid[idx]], object),
                ra=ra[idx], dec=dec[idx],
                x=np.zeros(m), y=np.zeros(m),
                magnorm=magnorm[idx],
                obj_type=otype,
                p0=hlr, p1=p1, p2=q, p3=beta[idx],
                g1=g1r[idx], g2=g2r[idx], mu=mu[idx],
                sed_name=np.array([f"tophat:{comp}"] * m, object),
                redshift=z[idx],
                int_av=np.zeros(m), int_rv=np.full(m, 3.1),
                mw_av=mw_av[idx], mw_rv=mw_rv[idx],
                image_file=np.array([""] * m, object),
                sed_obj=sed_objs,
            ))
        if not parts:
            return _empty_table()
        return _concat_tables(parts)


def _empty_table() -> ObjectTable:
    return ObjectTable(sed_obj=np.array([], object))


def _concat_tables(tables: list[ObjectTable]) -> ObjectTable:
    kw = {}
    for k in ObjectTable.__dataclass_fields__:
        vals = [np.asarray(getattr(t, k)) for t in tables]
        n_rows = [len(t) for t in tables]
        # optional fields absent from some tables
        for i, (v, m) in enumerate(zip(vals, n_rows)):
            if len(v) != m:
                vals[i] = (np.array([None] * m, object) if k == "sed_obj"
                           else np.zeros(m))
        kw[k] = np.concatenate(vals)
    return ObjectTable(**kw)
