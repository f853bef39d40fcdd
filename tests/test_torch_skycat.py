"""The port's sky-catalog readers against the JAX package's, on the CPU,
on files pyarrow writes:

  * SkyCatalogInterface on the three catalogs tests/test_flat_skycat.py
    builds (single-component rows, DC2 components, dropped component
    shares), from parquet and CSV, with obj_types, the DC2 dilation, a
    column mapping, several files and a WCS cull: every ObjectTable
    column bit-equal;
  * the native format on a generated yaml with healpix files rewritten by
    pyarrow (snappy, dictionary): the ObjectTable bit-equal, the inline
    tophat SEDs' wave and fphot bit-equal; ang2pix_ring on 1e5 random
    points, the region query and the file match;
  * load_row and RowData on CSV, ECSV and parquet tables: the values
    (types included) of the JAX package's pandas row."""
import os
import shutil

import numpy as np
import pandas as pd
import pyarrow.parquet as pq
import pytest
import yaml

from imsim_tpu.catalog import skycat as JS
from imsim_tpu.catalog import skycat_native as JN
from imsim_tpu.catalog import table_row as JT
from imsim_tpu.config.interpreter import ConfigView as JView
from imsim_tpu.config.interpreter import load_config as jload
from imsim_tpu_torch.benchmarks import skycat_workload as W
from imsim_tpu_torch.catalog import skycat as TS
from imsim_tpu_torch.catalog import skycat_native as TN
from imsim_tpu_torch.catalog import table_row as TT
from imsim_tpu_torch.config.interpreter import ConfigView as TView
from imsim_tpu_torch.config.interpreter import load_config as tload
from imsim_tpu_torch.config.yaml_subset import safe_load

DEG = np.pi / 180


def _single(n=50, seed=0):
    """test_flat_skycat.py:33's catalog."""
    rng = np.random.default_rng(seed)
    return pd.DataFrame(dict(
        id=np.arange(n),
        ra=30.0 + rng.uniform(-0.1, 0.1, n),
        dec=-20.0 + rng.uniform(-0.1, 0.1, n),
        magnorm=rng.uniform(20, 25, n),
        object_type=np.where(rng.uniform(size=n) < 0.4, "star", "galaxy"),
        sed_filepath=["flatSED/sed_flat.txt"] * n,
        redshift=rng.uniform(0, 1, n),
        size_true=rng.uniform(0.1, 1.0, n),
        sersic_index=rng.uniform(0.5, 4.0, n),
        axis_ratio=rng.uniform(0.3, 1.0, n),
        position_angle=rng.uniform(0, 180, n),
        shear_1=rng.normal(0, 0.02, n),
        shear_2=rng.normal(0, 0.02, n),
        convergence=rng.normal(0, 0.01, n),
        MW_av=rng.uniform(0, 0.2, n),
        MW_rv=np.full(n, 3.1)))


def _components():
    """test_flat_skycat.py:85's catalog."""
    return pd.DataFrame(dict(
        id=[1, 2], ra=[30.0, 30.001], dec=[-20.0, -20.001],
        magnorm=[22.0, 21.0], object_type=["galaxy", "star"],
        sed_filepath=["flatSED/sed_flat.txt"] * 2, redshift=[0.5, 0.0],
        size_bulge_true=[0.4, np.nan], size_minor_bulge_true=[0.3, np.nan],
        sersic_bulge=[4.0, np.nan], size_disk_true=[1.2, np.nan],
        size_minor_disk_true=[0.6, np.nan], sersic_disk=[1.0, np.nan],
        bulge_frac=[0.3, np.nan], knots_flux_ratio=[0.2, np.nan],
        n_knots=[25, 0], shear_1=[0.01, 0.0], shear_2=[-0.02, 0.0],
        convergence=[0.0, 0.0]))


def _dropped():
    """test_flat_skycat.py:149's catalog."""
    return pd.DataFrame(dict(
        id=[1, 2], ra=[30.0, 30.001], dec=[-20.0, -20.001],
        magnorm=[22.0, 23.0], object_type=["galaxy", "galaxy"],
        sed_filepath=["flatSED/sed_flat.txt"] * 2, redshift=[0.5, 0.4],
        size_bulge_true=[0.4, 0.0], size_minor_bulge_true=[0.3, 0.0],
        sersic_bulge=[4.0, 4.0], size_disk_true=[1.2, 0.9],
        size_minor_disk_true=[0.6, 0.9], sersic_disk=[1.0, 1.0],
        bulge_frac=[0.3, 0.5], knots_flux_ratio=[0.2, 0.0],
        n_knots=[0, 0], shear_1=[0.0, 0.0], shear_2=[0.0, 0.0],
        convergence=[0.0, 0.0]))


CATALOGS = {"single": _single, "components": _components,
            "dropped": _dropped}


class FakeWCS:
    """test_flat_skycat.py's pixel mapping: 5.5e-5 deg a pixel about
    (30, -20) deg at (2000, 2000)."""

    def radec_to_xy(self, ra, dec):
        return ((ra - 30.0 * DEG) / 5.5e-5 / DEG + 2000,
                (dec + 20.0 * DEG) / 5.5e-5 / DEG + 2000)

    def xy_to_radec(self, x, y):
        x, y = np.asarray(x, float), np.asarray(y, float)
        return ((x - 2000) * 5.5e-5 * DEG + 30.0 * DEG,
                (y - 2000) * 5.5e-5 * DEG - 20.0 * DEG)


def tables_differ(a, b) -> list:
    """The ObjectTable fields whose values or dtypes differ (object
    fields by repr, inline SEDs by their arrays)."""
    bad = []
    for k in a.__dataclass_fields__:
        x, y = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
        if k == "sed_obj":
            same = len(x) == len(y) and all(
                (s is None and t is None) or (
                    s is not None and t is not None
                    and np.array_equal(s.wave, t.wave)
                    and np.array_equal(s.fphot, t.fphot)
                    and s.wave.dtype == t.wave.dtype)
                for s, t in zip(x, y))
        elif x.dtype == object:
            same = [repr(v) for v in x] == [repr(v) for v in y]
        else:
            same = x.dtype == y.dtype and x.tobytes() == y.tobytes()
        if not same:
            bad.append(k)
    return bad


@pytest.mark.parametrize("fmt", ["parquet", "csv"])
@pytest.mark.parametrize("name", sorted(CATALOGS))
@pytest.mark.parametrize("kw", [
    {}, {"obj_types": ("star",)}, {"apply_dc2_dilation": True},
    {"columns": {"hlr": "axis_ratio", "q": "size_true"}}])
def test_mapped_catalogs_match_the_jax_package(tmp_path, fmt, name, kw):
    df = CATALOGS[name]()
    path = str(tmp_path / f"cat.{fmt}")
    if fmt == "parquet":
        df.to_parquet(path)
    else:
        df.to_csv(path, index=False)
    j, t = JS.SkyCatalogInterface(path, **kw), TS.SkyCatalogInterface(
        path, **kw)
    assert t.getNObjects() == j.getNObjects()
    for call in ({}, {"wcs": FakeWCS(), "xsize": 4000, "ysize": 4000,
                      "edge_pix": 50}):
        jt, tt = j.to_object_table(**call), t.to_object_table(**call)
        assert len(tt) == len(jt) > 0 or kw
        assert not tables_differ(jt, tt)
    # idempotent: the interface is left as it was
    assert not tables_differ(jt, t.to_object_table(**call))


def test_several_files_match_the_jax_package(tmp_path):
    """Two parquet files and a CSV of different schemas, concatenated as
    pandas concatenates them."""
    paths = [str(tmp_path / "a.parquet"), str(tmp_path / "b.parquet"),
             str(tmp_path / "c.csv")]
    _single(30, 1).to_parquet(paths[0])
    _components().to_parquet(paths[1])
    _dropped().to_csv(paths[2], index=False)
    j, t = JS.SkyCatalogInterface(paths), TS.SkyCatalogInterface(paths)
    assert t.getNObjects() == j.getNObjects() == 34
    assert not tables_differ(j.to_object_table(), t.to_object_table())


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """A small generated workload's native catalog, its parquet files
    rewritten by pyarrow (snappy, dictionary pages) beside a copy of its
    yaml."""
    d = tmp_path_factory.mktemp("native")
    res = W.write_workload(str(d / "gen"), n_rows=50, window=(512, 512),
                           margin=40.0, n_bright=1, total_photons=1e5,
                           n_gal_native=150, n_star_native=40,
                           native_photons=1e5)
    src = os.path.dirname(res["native"])
    out = d / "pyarrow"
    out.mkdir()
    for name in os.listdir(src):
        if name.endswith(".parquet"):
            pq.write_table(pq.read_table(os.path.join(src, name)),
                           str(out / name), row_group_size=64)
        else:
            shutil.copy(os.path.join(src, name), out / name)
    return dict(res, yaml=str(out / "skycat.yaml"))


def test_native_catalog_matches_the_jax_package(native):
    y = native["yaml"]
    with open(y) as f:
        text = f.read()
    assert safe_load(text) == yaml.safe_load(text)
    j, t = JN.NativeSkyCatalog(y), TN.NativeSkyCatalog(y)
    assert t.nside == j.nside == 32
    assert np.array_equal(t.tophat_bins, j.tophat_bins)
    assert t.sed_dirs_hint() == j.sed_dirs_hint() == [native["sed_dir"]]
    jt = j.get_objects_by_region(None)
    tt = t.get_objects_by_region(None)
    assert len(tt) == len(jt) > 150
    assert not tables_differ(jt, tt)
    assert t.seconds["tophat seds"] > 0
    # through the interface, with the region query and the cull
    wcs = FakeWCS()
    for kw in ({}, {"obj_types": ("star",)}, {"apply_dc2_dilation": True}):
        a = JS.SkyCatalogInterface(y, **kw).to_object_table(
            wcs=wcs, xsize=4000, ysize=4000)
        b = TS.SkyCatalogInterface(y, **kw).to_object_table(
            wcs=wcs, xsize=4000, ysize=4000)
        assert not tables_differ(a, b)
    assert TS.SkyCatalogInterface(y).getNObjects() == len(jt)


def test_healpix_and_region_queries_match_the_jax_package(native):
    rng = np.random.default_rng(7)
    ra = rng.uniform(-30, 400, 100_000)
    dec = np.degrees(np.arcsin(rng.uniform(-1, 1, 100_000)))
    for nside in (1, 8, 32, 128):
        assert np.array_equal(TN.ang2pix_ring(nside, ra, dec),
                              JN.ang2pix_ring(nside, ra, dec))
    assert int(TN.ang2pix_ring(32, 54.3712096, -35.8373231)[0]) == 9683
    for ra0, dec0 in ((30.0, -20.0), (54.37, -35.84), (359.95, 0.1),
                      (10.0, 89.9)):
        v = [(ra0 - 0.12, dec0 - 0.12), (ra0 + 0.12, dec0 - 0.12),
             (ra0 + 0.12, dec0 + 0.12), (ra0 - 0.12, dec0 + 0.12)]
        assert TN.region_healpix_pixels(v, 32) == \
            JN.region_healpix_pixels(v, 32)
    y = native["yaml"]
    j, t = JN.NativeSkyCatalog(y), TN.NativeSkyCatalog(y)
    pix = TN.region_healpix_pixels([(30.0, -20.0), (30.1, -20.0),
                                    (30.1, -19.9), (30.0, -19.9)], 32)
    for kind in ("star", "galaxy"):
        assert t.files_for_region(kind, pix) == j.files_for_region(kind, pix)
        assert t.files_for_region(kind, {0}) == []
    bins = np.asarray(W.TOPHAT_BINS)
    vals = rng.uniform(0.1, 2.0, len(bins))
    a = TN.tophat_sed(bins, vals, 0.7, 0.2, 3.1)
    b = JN.tophat_sed(bins, vals, 0.7, 0.2, 3.1)
    assert np.array_equal(a.wave, b.wave) and np.array_equal(a.fphot,
                                                             b.fphot)


# ---- RowData ---------------------------------------------------------------

@pytest.fixture()
def row_tables(tmp_path):
    csv = tmp_path / "fea_offsets.csv"
    csv.write_text("det_name,dz,angle,comment,n\n"
                   "R22_S11,12.5,30.0,center,3\n"
                   "R01_S00,-3.0,45.0,\"corner, far\",4\n"
                   "R10_S11,0.1,,,5\n")
    ecsv = tmp_path / "t.ecsv"
    ecsv.write_text("# %ECSV 1.0\n# ---\n# delimiter: ','\n"
                    "visit,seeing,airmass\n181000,0.7,1.2\n181001,0.9,1.3\n")
    num = tmp_path / "num.csv"
    num.write_text("visit,seeing\n181000,0.7\n181001,0.9\n")
    pqt = tmp_path / "sensors.parquet"
    pd.DataFrame({"vendor": ["E2V", "ITL"], "strength": [1.0, 0.8],
                  "n": np.array([1, 2], np.int32),
                  "ok": [True, False]}).to_parquet(pqt)
    dup = tmp_path / "dup.csv"
    dup.write_text("k,v\nA,1\nA,2\n")
    return dict(csv=str(csv), ecsv=str(ecsv), num=str(num), pq=str(pqt),
                dup=str(dup))


@pytest.mark.parametrize("table, key, value", [
    ("csv", "det_name", "R22_S11"), ("csv", "det_name", "R10_S11"),
    ("csv", "n", 4), ("ecsv", "visit", 181001), ("num", "visit", 181000),
    ("pq", "vendor", "ITL"), ("pq", "n", 1), ("pq", "ok", False)])
def test_load_row_matches_the_jax_package(row_tables, table, key, value):
    path = row_tables[table]
    want = JT.load_row(path, key, value)
    got = TT.load_row(path, key, value)
    assert list(got) == list(want)
    for k in want:
        assert type(got[k]) is type(want[k]), (k, got[k], want[k])
        assert repr(got[k]) == repr(want[k]), k


def test_load_row_refusals(row_tables):
    for mod in (JT, TT):
        with pytest.raises(KeyError):
            mod.load_row(row_tables["csv"], "det_name", "R99_S99")
        with pytest.raises(KeyError):
            mod.load_row(row_tables["csv"], "dz", "R22_S11")
        with pytest.raises(ValueError):
            mod.load_row(row_tables["dup"], "k", "A")


@pytest.mark.parametrize("field, unit", [
    ("dz", "um"), ("angle", "deg"), ("comment", None), ("n", "mm"),
    ("dz", "arcsec")])
def test_row_data_values_match_the_jax_package(row_tables, field, unit):
    """{type: RowData} through each package's config interpreter."""
    node = {"type": "RowData", "file_name": row_tables["csv"],
            "key_column": "det_name", "key_value": "R01_S00",
            "field": field}
    if unit:
        node["to_unit"] = unit
    base = {"template": "imsim-config-instcat",
            "input.instance_catalog.file_name": "x.txt"}
    want = JView(jload(base)).resolve(node)
    got = TView(tload(base)).resolve(node)
    assert type(got) is type(want) and repr(got) == repr(want)
