"""The port's catalog half against the JAX package, on the CPU: the
instance-catalog parser and cull, the opsim header and database reader,
the SEDs, the bandpasses (analytic and from synthetic throughput files),
the FITS reader and the sky spectra.  Every host module is a copy of the
JAX package's numpy, so every output here is held bit-equal."""
import gzip
import os
import pickle
import sqlite3
import sys
import types

import numpy as np
import pytest

import imsim_tpu.catalog.bandpass as JB
import imsim_tpu.catalog.instcat as JI
import imsim_tpu.catalog.opsim as JO
import imsim_tpu.catalog.sed as JS
import imsim_tpu.image.sky_sed as JK
from imsim_tpu.io import fits as JF
import imsim_tpu_torch.catalog.bandpass as TB
import imsim_tpu_torch.catalog.instcat as TI
import imsim_tpu_torch.catalog.opsim as TO
import imsim_tpu_torch.catalog.sed as TS
import imsim_tpu_torch.image.sky_sed as TK
from imsim_tpu_torch.io import fits as TF


def same(a, b) -> bool:
    """Bit-equal numpy arrays (dtype, shape and bytes), or equal values."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype == object or b.dtype == object:
            return a.shape == b.shape and list(a) == list(b)
        return a.dtype == b.dtype and a.shape == b.shape and \
            np.ascontiguousarray(a).tobytes() == \
            np.ascontiguousarray(b).tobytes()
    return a == b


def tables_equal(a, b):
    fields = list(type(a).__dataclass_fields__)
    assert fields == list(type(b).__dataclass_fields__)
    bad = [k for k in fields if not same(getattr(a, k), getattr(b, k))]
    assert not bad, bad


# ---- instance catalogs --------------------------------------------------

HEADER = """rightascension 30.0
declination -20.0
mjd 60674.2
filter 2
seeing 0.7
vistime 30.0
rottelpos 12.5
obshistid 181000
altitude 60.0
moonalt 25.0
moonphase 40.0
moonra 50.0
moondec -10.0
sunalt -30.0
"""


def _object_lines(rng, n, start=0):
    lines = []
    for i in range(start, start + n):
        ra = 30.0 + rng.uniform(-0.1, 0.1)
        dec = -20.0 + rng.uniform(-0.1, 0.1)
        mag = rng.uniform(15, 25)
        z = rng.uniform(0, 2)
        g1, g2, kappa = rng.normal(0, 0.02, 3)
        kind = i % 6
        if kind == 0:
            shape = "point"
        elif kind == 1:
            a, b = sorted(rng.uniform(0.2, 2, 2))[::-1]
            shape = f"sersic2d {a:.4f} {b:.4f} {rng.uniform(0, 180):.3f} " \
                    f"{rng.uniform(0.5, 4):.3f}"
        elif kind == 2:
            a, b = sorted(rng.uniform(0.2, 2, 2))[::-1]
            shape = f"knots {a:.4f} {b:.4f} {rng.uniform(0, 180):.3f} 25"
        elif kind == 3:
            shape = f"streak {rng.uniform(5, 50):.3f} 0.5 " \
                    f"{rng.uniform(0, 180):.3f}"
        elif kind == 4:
            shape = "stamp_a.fits 0.2 30.0"
        else:
            shape = "point"
        dust = rng.choice(["none none", "none CCM 0.1 3.1",
                           "CCM 0.2 3.0 CCM 0.05 3.1", "CCM 0.3 2.9 none"])
        lines.append(f"object {i} {ra:.6f} {dec:.6f} {mag:.3f} "
                     f"flatSED/sed_flat.txt {z:.3f} {g1:.4f} {g2:.4f} "
                     f"{kappa:.4f} 0 0 {shape} {dust}\n")
    return lines


# rows the skip-invalid rules drop: the magnorm >= 50 sentinel, a sersic2d
# with a < b, knots with no points; and an ` inf ` row, never parsed
INVALID = [
    "object 900 30.0 -20.0 55.0 flatSED/sed_flat.txt 0 0 0 0 0 0 point "
    "none none\n",
    "object 901 30.0 -20.0 20.0 flatSED/sed_flat.txt 0 0 0 0 0 0 sersic2d "
    "0.5 0.9 10.0 1.0 none none\n",
    "object 902 30.0 -20.0 20.0 flatSED/sed_flat.txt 0 0 0 0 0 0 knots "
    "0.9 0.5 10.0 0 none none\n",
    "object 903 30.0 -20.0 inf flatSED/sed_flat.txt 0 0 0 0 0 0 point "
    "none none\n",
]


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    """A header, 60 objects of every type, the invalid rows, and an
    includeobj of a gzipped file with 40 more objects."""
    d = tmp_path_factory.mktemp("instcat")
    rng = np.random.default_rng(3)
    with gzip.open(d / "more.txt.gz", "wt") as f:
        f.writelines(_object_lines(rng, 40, start=100))
    with open(d / "cat.txt", "w") as f:
        f.write(HEADER)
        f.writelines(_object_lines(rng, 60))
        f.writelines(INVALID)
        f.write("includeobj more.txt.gz\n")
    return str(d / "cat.txt")


class LinearWCS:
    """A plain linear sky-to-pixel map, the same object for both
    packages (the cull's logic is under test, not a WCS)."""

    def radec_to_xy(self, ra, dec):
        x = (np.asarray(ra) - np.radians(30.0)) / 2e-6 + 2000.0
        y = (np.asarray(dec) - np.radians(-20.0)) / 2e-6 + 2000.0
        return x, y


@pytest.mark.parametrize("flip_g2", [True, False])
@pytest.mark.parametrize("skip_invalid", [True, False])
def test_parse_instcat(catalog, flip_g2, skip_invalid):
    a = JI._parse_instcat(catalog, flip_g2=flip_g2,
                          skip_invalid=skip_invalid, force_python=True)
    b = TI._parse_instcat(catalog, flip_g2=flip_g2,
                          skip_invalid=skip_invalid, force_python=True)
    assert a[1] == b[1] == 100 + 3
    tables_equal(a[0], b[0])
    assert len(b[0]) == (100 if skip_invalid else 103)
    assert set(b[0].obj_type) == {TI.POINT, TI.SERSIC, TI.KNOTS,
                                  TI.STREAK, TI.FITSIMAGE}


@pytest.mark.parametrize("cull", ["none", "wcs", "narrow"])
@pytest.mark.parametrize("sort_mag", [True, False])
def test_read_instcat_cull_and_sort(catalog, cull, sort_mag):
    kw = dict(sort_mag=sort_mag)
    if cull != "none":
        kw.update(wcs=LinearWCS(), xsize=4000, ysize=4000)
        if cull == "narrow":
            kw.update(xsize=2500, ysize=2300, edge_pix=50)
    a = JI.read_instcat(catalog, **kw)
    b = TI.read_instcat(catalog, **kw)
    tables_equal(a, b)
    assert 0 < len(b) <= 100
    if sort_mag:
        assert np.all(np.diff(b.magnorm) >= 0)


@pytest.mark.parametrize("min_source", [5, 10, 11, 200])
def test_read_instcat_min_source(catalog, min_source):
    a = JI.read_instcat(catalog, min_source=min_source)
    b = TI.read_instcat(catalog, min_source=min_source)
    tables_equal(a, b)
    n_sersic = int(np.sum(TI.read_instcat(catalog).obj_type == TI.SERSIC))
    assert len(b) == (0 if n_sersic < min_source else 100)


def test_object_flux_and_dust_tokens():
    mags = np.linspace(10, 30, 41)
    assert same(JI.object_flux(mags, 3e4, 15.0), TI.object_flux(mags, 3e4,
                                                                15.0))
    assert TI.RUBIN_AREA == JI.RUBIN_AREA
    for toks in (["none", "none"], ["CCM", "0.1", "3.1", "none"],
                 ["none", "CCM", "0.2", "2.9"], [],
                 ["CCM", "0.3", "3.0", "CCM", "0.05", "3.1"]):
        assert JI._parse_dust(toks) == TI._parse_dust(toks)


def test_parse_is_cached_per_mtime(tmp_path):
    """read_instcat's parse is cached per (path, mtime, flags): a rewrite
    of the file is parsed again."""
    path = str(tmp_path / "c.txt")
    with open(path, "w") as f:
        f.write(HEADER + INVALID[0].replace("55.0", "20.0"))
    assert len(TI.read_instcat(path)) == 1
    os.utime(path, (1, 1))
    with open(path, "a") as f:
        f.write(INVALID[1].replace("0.5 0.9", "0.9 0.5"))
    os.utime(path, (2, 2))
    assert len(TI.read_instcat(path)) == 2


# ---- opsim --------------------------------------------------------------

def _meta_equal(a, b):
    assert a.meta.keys() == b.meta.keys()
    bad = {k: (a.meta[k], b.meta[k]) for k in a.meta
           if not same(a.meta[k], b.meta[k])}
    assert not bad, bad


def test_instcat_header(catalog):
    a = JO.read_instcat_header(catalog)
    b = TO.read_instcat_header(catalog)
    _meta_equal(a, b)
    assert b["band"] == "r" and b["seed"] == 181000 and b["moonAlt"] == 25.0
    for kw in ({}, dict(altitude=45.0), dict(rawSeeing=1.1, band="y")):
        assert a.FWHMeff(**kw) == b.FWHMeff(**kw)
        assert a.FWHMgeom(**kw) == b.FWHMgeom(**kw)
    assert a.getAirmass(50.0) == b.getAirmass(50.0)


@pytest.mark.parametrize("visit", [None, 7002, 7003])
def test_opsim_db(tmp_path, visit):
    path = str(tmp_path / "opsim.db")
    con = sqlite3.connect(path)
    con.execute("CREATE TABLE observations (observationId INTEGER, "
                "fieldRA REAL, fieldDec REAL, observationStartMJD REAL, "
                "night INTEGER, band TEXT, seeingFwhm500 REAL, "
                "rotTelPos REAL, moonAlt REAL, moonPhase REAL)")
    for k in range(4):
        con.execute("INSERT INTO observations VALUES (?,?,?,?,?,?,?,?,?,?)",
                    (7000 + k, 10.0 + k, -30.0 + k, 60100.1 + 0.01 * k,
                     900 + k // 2, "ugri"[k], 0.6 + 0.1 * k, 5.0 * k,
                     -10.0 + 20 * k, 30.0 * k))
    con.commit()
    con.close()
    a = JO.read_opsim_db(path, visit, snap=1)
    b = TO.read_opsim_db(path, visit, snap=1)
    _meta_equal(a, b)
    with pytest.raises(ValueError):
        TO.read_opsim_db(path, 1)


def test_opsim_from_dict():
    d = dict(band="z", exptime=15.0, seed=3, fieldRA=150.0, fieldDec=2.0,
             observationStartMJD=60300.3, observationId=77)
    _meta_equal(JO.from_dict(dict(d)), TO.from_dict(dict(d)))
    _meta_equal(JO.from_dict({}), TO.from_dict({}))


# ---- SEDs ---------------------------------------------------------------

@pytest.fixture(scope="module")
def sed_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("seds")
    w = np.arange(200.0, 1400.0, 2.5)
    os.makedirs(d / "sub")
    np.savetxt(d / "sub" / "plain.txt", np.column_stack(
        [w, (w / 500) ** -1.3]), header="two columns")
    with gzip.open(d / "sub" / "bump.txt.gz", "wt") as f:
        np.savetxt(f, np.column_stack(
            [w, 1 + np.exp(-0.5 * ((w - 650) / 30) ** 2)]))
    return str(d)


@pytest.mark.parametrize("name", ["sub/plain.txt", "sub/bump.txt.gz"])
def test_sed_files(sed_dir, name):
    path = os.path.join(sed_dir, name)
    for x, y in zip(JS.load_sed_file(path), TS.load_sed_file(path)):
        assert same(x, y)
    a, b = JS._cached_raw_sed(path), TS._cached_raw_sed(path)
    assert same(a.wave, b.wave) and same(a.fphot, b.fphot)
    for z, mw, iav in ((0.0, 0.0, 0.0), (0.37, 0.1, 0.0),
                       (1.9, 0.25, 0.4)):
        sa = JS.build_object_sed(name, z, mw, 3.1, (sed_dir,), int_av=iav,
                                 int_rv=2.8)
        sb = TS.build_object_sed(name, z, mw, 3.1, (sed_dir,), int_av=iav,
                                 int_rv=2.8)
        assert same(sa.wave, sb.wave) and same(sa.fphot, sb.fphot)
        grid = np.linspace(250, 1200, 333)
        assert same(sa.resample(grid), sb.resample(grid))
    with pytest.raises(OSError):
        TS.build_object_sed("missing.txt", 0.0, 0.0, 3.1, (sed_dir,))


def test_ccm89_extinction():
    """Every region of the curve (IR, optical, UV, far UV past x = 8) on
    random grids, and the rounding of a, b reused per grid."""
    rng = np.random.default_rng(5)
    for _ in range(60):
        w = np.sort(rng.uniform(80.0, 4000.0, rng.integers(5, 2500)))
        av, rv = rng.uniform(0, 1.5), rng.uniform(2.0, 5.5)
        for _ in range(2):   # the second call reads the kept a, b
            assert same(JS.ccm89_extinction(w, av, rv),
                        TS.ccm89_extinction(w, av, rv))
    assert TS.MAGNORM_FLUX_DENSITY == JS.MAGNORM_FLUX_DENSITY


@pytest.mark.parametrize("band", ["u", "r", "y"])
def test_build_scene(sed_dir, tmp_path, band):
    """image/scene.build_scene (the objects of one SED file at once)
    against the JAX package's loop over objects, bit-equal: SEDs that
    cover the band, end inside it or miss it; redshift 0, a bandpass
    wavelength on an SED wavelength, keys that share a rounding (the
    first object's SED serves), internal and Milky Way dust on and off,
    pre-built SED rows and FITS point clouds; the Poisson draw and the
    clouds on one rng."""
    import imsim_tpu.image.scene as JScene
    import imsim_tpu_torch.image.scene as TScene

    w = np.arange(200.0, 1400.0, 2.5)
    for name, lo, hi in (("short.txt", 200.0, 400.0),
                         ("mid.txt", 200.0, 600.0)):
        g = w[(w >= lo) & (w <= hi)]
        np.savetxt(tmp_path / name, np.column_stack([g, 1 + 0 * g]))
    np.savetxt(tmp_path / "dark.txt", np.column_stack(
        [w, np.where(w < 510.0, 1.0, 0.0)]))
    stamp = str(tmp_path / "stamp.fits")
    JF.write_fits(stamp, [JF.HDU(np.random.default_rng(4).uniform(
        0, 1, (12, 9)))])
    rng = np.random.default_rng(11)
    n = 600
    names = np.array(["sub/plain.txt", "sub/bump.txt.gz", "short.txt",
                      "mid.txt", "dark.txt"], object)
    sed_name = names[rng.integers(0, len(names), n)]
    z = np.round(rng.uniform(0.0, 2.0, n), 5)
    z[rng.uniform(size=n) < 0.3] = 0.0
    z[1::50] = z[0::50] + 4e-6      # rounds to its neighbour's key
    sed_name[1::50] = sed_name[0::50]
    int_av = np.where(rng.uniform(size=n) < 0.5, 0.0,
                      np.round(rng.uniform(0, 1, n), 3))
    mw_av = np.where(rng.uniform(size=n) < 0.3, 0.0,
                     np.round(rng.uniform(0, 0.3, n), 3))
    obj_type = np.zeros(n, np.int32)
    obj_type[[7, 300]] = TI.FITSIMAGE
    image_file = np.array(["" if t == 0 else stamp for t in obj_type],
                          object)
    sed_obj = np.array([None] * n, object)
    for i in (5, 250):
        sed_obj[i] = TS.SED(w, (w / 600) ** 0.5 * 1e-3)
    table = TI.ObjectTable(
        id=np.arange(n).astype(object), ra=np.zeros(n), dec=np.zeros(n),
        x=rng.uniform(0, 4000, n), y=rng.uniform(0, 4000, n),
        magnorm=rng.uniform(17, 25, n), obj_type=obj_type,
        p0=np.where(obj_type > 0, 0.2, 0.0), p1=rng.uniform(0, 1, n),
        p2=np.zeros(n), p3=np.zeros(n), g1=np.zeros(n), g2=np.zeros(n),
        mu=rng.uniform(0.9, 1.1, n), sed_name=sed_name, redshift=z,
        int_av=int_av, int_rv=rng.uniform(2.5, 4.0, n), mw_av=mw_av,
        mw_rv=np.full(n, 3.1), image_file=image_file, sed_obj=sed_obj)
    dirs = (sed_dir, str(tmp_path))
    j = JScene.build_scene(table, JB.rubin_bandpass(band), dirs,
                           rng=np.random.default_rng(3))
    t = TScene.build_scene(table, TB.rubin_bandpass(band), dirs,
                           rng=np.random.default_rng(3), device="cpu")
    assert same(j.nominal_flux, t.nominal_flux)
    assert same(j.flux, t.flux)
    for k in ("params", "wl_icdf", "aux_cloud"):
        assert same(np.asarray(getattr(j.scene, k)),
                    getattr(t.scene, k).numpy()), k
    # the bands' edges and the dark SED reach every branch of np.interp
    assert (t.nominal_flux == 0).any() and (t.nominal_flux > 0).any()
    missing = table.select(np.arange(n) < 3)
    missing.sed_name = np.array(["missing.txt"] * 3, object)
    with pytest.raises(OSError, match="missing.txt"):
        TScene.build_scene(missing, TB.rubin_bandpass(band), dirs,
                           device="cpu")


# ---- bandpasses -----------------------------------------------------------

def _bp_equal(a, b):
    assert same(a.wave, b.wave) and same(a.throughput, b.throughput)
    assert a.band == b.band and a.zeropoint == b.zeropoint
    assert a.effective_wavelength == b.effective_wavelength


@pytest.mark.parametrize("band", list("ugrizy"))
def test_analytic_bandpass(band):
    for X in (None, 1.0, 1.147, 2.3):
        _bp_equal(JB.rubin_bandpass(band, X), TB.rubin_bandpass(band, X))
    _bp_equal(JB.hardware_bandpass(band), TB.hardware_bandpass(band))
    bp = TB.rubin_bandpass(band)
    w = np.linspace(300, 1200, 500)
    f = 1e-3 * (w / 600) ** -2
    assert JB.rubin_bandpass(band).photon_rate(w, f, 3e4, 30.0) == \
        bp.photon_rate(w, f, 3e4, 30.0)
    assert same(JB.rubin_bandpass(band)(w), bp(w))
    _bp_equal(JB.rubin_bandpass(band).truncate(0.05), bp.truncate(0.05))
    _bp_equal(JB.rubin_bandpass(band) * 0.5, bp * 0.5)


@pytest.fixture()
def throughputs_dir(tmp_path):
    """rubin_sim-shaped throughput files (as tests/test_data_loaders.py
    writes them), synthetic."""
    base = tmp_path / "throughputs" / "baseline"
    os.makedirs(base)
    w = np.linspace(300, 1100, 801)
    filt = np.where((w > 550) & (w < 690), 0.95, 0.0)
    np.savetxt(base / "filter_r.dat", np.column_stack([w, filt]))
    for part in ("m1", "m2", "m3", "lens1", "lens2", "lens3"):
        np.savetxt(base / f"{part}.dat",
                   np.column_stack([w, np.full_like(w, 0.98)]))
    np.savetxt(base / "hardware_r.dat",
               np.column_stack([w, filt * 0.98**6 * 0.9]))
    np.savetxt(base / "total_r.dat",
               np.column_stack([w, filt * 0.98**6 * 0.9 * 0.8]))
    atm = tmp_path / "throughputs" / "atmos"
    os.makedirs(atm)
    for X in (10, 12, 15, 20):
        t = np.exp(-0.1 * X / 10.0 * (w / 600) ** -1) * np.ones_like(w)
        np.savetxt(atm / f"atmos_{X}_aerosol.dat", np.column_stack([w, t]))
    det = tmp_path / "throughputs" / "lsstCam" / "transmission_sensor" \
        / "r22_s11"
    os.makedirs(det)
    with open(det / "qe.ecsv", "w") as f:
        f.write("# %ECSV 1.0\n# ---\n# delimiter: ','\n")
        f.write("amp_name,wavelength,efficiency\n")
        for amp, qe in (("C00", 80.0), ("C01", 90.0)):
            for wv in (300.0, 700.0, 1100.0):
                f.write(f"{amp},{wv},{qe}\n")
    return str(tmp_path / "throughputs")


@pytest.mark.parametrize("kw", [{}, dict(airmass=1.0), dict(airmass=1.3),
                                dict(airmass=2.5),
                                dict(airmass=1.1, camera="LsstCamSim",
                                     det_name="R22_S11")])
def test_bandpass_from_files(throughputs_dir, kw):
    _bp_equal(JB.rubin_bandpass_from_files("r", throughputs_dir, **kw),
              TB.rubin_bandpass_from_files("r", throughputs_dir, **kw))


def test_ecsv_and_atm_interpolator(throughputs_dir):
    path = os.path.join(throughputs_dir, "lsstCam", "transmission_sensor",
                        "r22_s11", "qe.ecsv")
    for x, y in zip(JB.read_ecsv_qe(path), TB.read_ecsv_qe(path)):
        assert same(x, y)
    Xs = np.array([1.0, 1.2, 1.5, 2.0])
    arr = np.exp(-np.outer(Xs, np.linspace(0.05, 0.4, 30)))
    arr[:, 3] = 0.0      # a zero column: log -inf, out 0
    ja, ta = JB.AtmInterpolator(Xs, arr), TB.AtmInterpolator(Xs, arr)
    for X in (1.0, 1.1, 1.5, 1.99, 2.0, 2.7):
        assert same(ja(X), ta(X))


def test_bandpass_dict_pickle(tmp_path):
    """A pickled BandpassDict whose classes live under `lsst`: both
    packages read the tabulated arrays through their shim."""
    mods = {}
    for name in ("lsst", "lsst.sims", "lsst.sims.photUtils"):
        mods[name] = sys.modules.setdefault(name, types.ModuleType(name))

    class Bandpass:
        pass

    class BandpassDict:
        pass

    for cls in (Bandpass, BandpassDict):
        cls.__module__ = "lsst.sims.photUtils"
        cls.__qualname__ = cls.__name__
        setattr(mods["lsst.sims.photUtils"], cls.__name__, cls)
    bd = BandpassDict()
    bd._bandpassDict = {}
    w = np.linspace(300, 1100, 401)
    for band, (lo, hi) in (("g", (400, 550)), ("r", (550, 690))):
        bp = Bandpass()
        bp.wavelen = w
        bp.sb = np.where((w > lo) & (w < hi), 0.6, 0.0) + 1e-6
        bd._bandpassDict[band] = bp
    path = str(tmp_path / "bp.pkl")
    with open(path, "wb") as f:
        pickle.dump(bd, f)
    for name in mods:
        del sys.modules[name]
    a, b = JB.load_bandpass_dict_pickle(path), TB.load_bandpass_dict_pickle(
        path)
    assert a.keys() == b.keys() == {"g", "r"}
    for band in a:
        _bp_equal(a[band], b[band])


# ---- FITS reader ------------------------------------------------------------

def test_fits_reader(tmp_path):
    rng = np.random.default_rng(9)
    imgs = [rng.normal(0, 1, (7, 5)).astype(np.float32),
            rng.integers(0, 60000, (4, 6)).astype(np.uint16),
            rng.integers(-5, 5, (3, 3, 2)).astype(np.int32),
            rng.normal(0, 1, (2, 9))]
    hdus = [JF.HDU(imgs[0], header={"EXPTIME": 30.0, "FILTER": "r",
                                    "FLAG": True})]
    hdus += [JF.HDU(a, name=f"X{i}") for i, a in enumerate(imgs[1:])]
    hdus.append(JF.BinTableHDU(dict(
        idx=np.arange(4, dtype=np.int32), val=np.linspace(0, 1, 4),
        spans=[np.arange(k + 1, dtype=np.int16) for k in range(4)]),
        name="TAB"))
    for suffix in ("a.fits", "b.fits.gz"):
        path = str(tmp_path / suffix)
        JF.write_fits(path, hdus)
        ja, ta = JF.read_fits(path), TF.read_fits(path)
        assert len(ja) == len(ta) == 5
        for (jh, jd), (th, td) in zip(ja, ta):
            assert jh == th
            assert (jd is None and td is None) or same(
                jd if isinstance(jd, np.ndarray) else np.frombuffer(jd, np.uint8),
                td if isinstance(td, np.ndarray) else np.frombuffer(td, np.uint8))
        for got, want in zip(imgs, [d for _, d in ta[:4]]):
            assert np.array_equal(got, want)
        jt = JF.read_bintable(*ja[-1])
        tt = TF.read_bintable(*ta[-1])
        assert jt.keys() == tt.keys()
        for k in jt:
            if isinstance(jt[k], list):
                assert all(same(x, y) for x, y in zip(jt[k], tt[k]))
            else:
                assert same(jt[k], tt[k])


def test_fits_reader_refuses_rice(tmp_path):
    """The reader once refused a RICE HDU; with the codec ported it
    decodes the JAX package's RICE file to the same int32 image."""
    path = str(tmp_path / "rice.fits")
    img = np.arange(64 * 64, dtype=np.int32).reshape(64, 64)
    JF.write_fits(path, [JF.HDU(None), JF.HDU(img, compress="rice")])
    assert np.array_equal(JF.read_fits(path)[1][1], img)
    (th, _), (th1, td1) = TF.read_fits(path)
    (jh, _), (jh1, _) = JF.read_fits(path)
    assert th == jh and th1 == jh1
    assert td1.dtype == np.int32 and np.array_equal(td1, img)


# ---- sky spectra ------------------------------------------------------------

def test_sky_sed_library():
    with open(JK.default_library_path(), "rb") as f, \
            open(TK.default_library_path(), "rb") as g:
        assert f.read() == g.read()
    a = JK.load_sky_sed("default")
    b = TK.load_sky_sed("default")
    assert same(a.wave_nm, b.wave_nm) and a.components.keys() == \
        b.components.keys()
    assert all(same(a.components[k], b.components[k]) for k in a.components)
    assert same(a.merged, b.merged)
    for band in "ugrizy":
        bp_j, bp_t = JB.hardware_bandpass(band), TB.hardware_bandpass(band)
        for k in a.components:
            assert JK.photon_rate(a.wave_nm, a.components[k], bp_j) == \
                TK.photon_rate(b.wave_nm, b.components[k], bp_t)
    y_j, y_t = JB.rubin_bandpass("y"), TB.rubin_bandpass("y")
    for x, y in zip(JK.synthetic_y_sky(), TK.synthetic_y_sky()):
        assert same(x, y)
    assert JK.etalon_visibility(a.wave_nm, a.merged, y_j) == \
        TK.etalon_visibility(b.wave_nm, b.merged, y_t)
    assert JK.fringing_amplitude(a, y_j) == TK.fringing_amplitude(b, y_t)
    assert JK.fringing_amplitude(None, y_j) == TK.fringing_amplitude(
        None, y_t) == 0.002


def test_sky_sed_text_file(tmp_path):
    path = str(tmp_path / "sky.txt")
    w = np.linspace(300, 1100, 1601)
    np.savetxt(path, np.column_stack([w, 1e-17 * (1 + np.sin(w / 3) ** 8)]))
    a, b = JK.load_sky_sed(path), TK.load_sky_sed(path)
    assert same(a.wave_nm, b.wave_nm) and same(a.merged, b.merged)
