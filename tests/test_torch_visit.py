"""The port's visit driver (imsim_tpu_torch.config.runner.run_visit and
`python -m imsim_tpu_torch`) against the JAX package's run_visit, on
the CPU, on tests/test_config_pipeline.py's tiny catalog over the full
R22_S11 frame (image.batch_size 200000, nbatch 2; the silicon's BF
stencil is left out of the JAX comparison, whose plain CPU twin takes
13 s a pass on the full frame: image.sensor.type none):

  * the resolved config tree, the eimage and raw headers, the truth
    columns id, ra, dec, x, y and nominal equal the JAX package's, and
    the eimage passes test_config_pipeline's photometry bar;
  * a checkpointed visit resumes bit-equal without rendering a batch;
  * LSST_Flat configs (BF and SED photons) at a small image.xsize/ysize;
  * the CLI with --visits over an opsim .db, with -n / -j, and
    output.io_workers: 1 writing the serial path's files;
  * the keys the port once refused (sensor_model, atm_psf.save_file,
    sky_catalog) run a YAML visit (output.mesh: test_torch_mesh_visit.py)."""
import os
import sqlite3

import numpy as np
import pytest
import torch

from imsim_tpu.config import interpreter as JI
from imsim_tpu.config import runner as JR
from imsim_tpu_torch import __main__ as CLI
from imsim_tpu_torch.config import interpreter as TI
from imsim_tpu_torch.config import runner as TR
from imsim_tpu_torch.image import photon_pooling as TPP
from imsim_tpu_torch.io.fits import read_fits

from test_config_pipeline import instcat, sed_dir  # noqa: F401
from test_torch_config import same

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = ["psf.type=DoubleGaussianPSF", "image.sensor.type=none",
        "image.batch_size=50000", "image.nbatch=2"]


def _over(instcat, sed_dir, out, *extra):
    return [f"input.instance_catalog.file_name={instcat}",
            f"input.instance_catalog.sed_dir={sed_dir}",
            "input.atm_psf.screen_size=102.4",
            "input.atm_psf.screen_scale=0.8",
            f"output.dir={out}", "output.det_num=[94]",
            "output.file_name=eimage_{det_name}.fits",
            "output.readout.file_name=amp_{det_name}.fits",
            "output.truth.file_name=centroid_{det_name}.txt",
            *extra]


@pytest.fixture(scope="module")
def pair(tmp_path_factory, instcat, sed_dir):  # noqa: F811
    """Both packages' run_visit of the tiny catalog on the full frame."""
    d = tmp_path_factory.mktemp("visit")
    over = ["image.batch_size=200000", "image.nbatch=2",
            "image.sensor.type=none", "output.cosmic_ray_rate=0.05"]
    jres = JR.run_visit({"template": "imsim-config-instcat"},
                        _over(instcat, sed_dir, d / "jax", *over))
    tres = TR.run_visit({"template": "imsim-config-instcat"},
                        _over(instcat, sed_dir, d / "port", *over),
                        device="cpu")
    return dict(jax=(jres, d / "jax"), port=(tres, d / "port"),
                over=_over(instcat, sed_dir, d / "x", *over))


def test_config_tree_is_the_jax_tree(pair):
    jcfg = JI.load_config({"template": "imsim-config-instcat"},
                          pair["over"])
    tcfg = TI.load_config({"template": "imsim-config-instcat"},
                          pair["over"])
    assert same(tcfg, jcfg)
    jctx = JR.build_visit_context(jcfg)
    tctx = TR.build_visit_context(tcfg)
    assert same(tctx.cfg, jctx.cfg)
    assert tctx.seed == jctx.seed and dict(tctx.opsim.meta) == dict(
        jctx.opsim.meta)
    assert TR._det_list(tctx) == JR._det_list(jctx) == [94]


def _cards_equal(th, jh, skip=()):
    """Header cards equal: strings, ints and bools exactly, floats within
    1e-12 relative (each package's own WCS fit and astrometry)."""
    assert list(th) == list(jh)
    for k in th:
        if k in skip:
            continue
        a, b = th[k], jh[k]
        if isinstance(a, float):
            assert abs(a - b) <= 1e-12 * max(abs(b), 1e-300), (k, a, b)
        else:
            assert a == b and type(a) is type(b), (k, a, b)


def test_files_and_headers_match_the_jax_visit(pair):
    (jres,), jdir = pair["jax"]
    (tres,), tdir = pair["port"]
    assert tres["det_name"] == "R22_S11" == jres["det_name"]
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == [
        "amp_R22_S11.fits", "centroid_R22_S11.txt", "eimage_R22_S11.fits"]
    (jh, jd), = read_fits(os.path.join(jdir, "eimage_R22_S11.fits"))
    (th, td), = read_fits(os.path.join(tdir, "eimage_R22_S11.fits"))
    _cards_equal(th, jh)
    assert td.dtype == np.dtype(">f4") and td.shape == (4004, 4096)
    np.testing.assert_array_equal(td, tres["eimage"])
    jamp = read_fits(os.path.join(jdir, "amp_R22_S11.fits"))
    tamp = read_fits(os.path.join(tdir, "amp_R22_S11.fits"))
    assert len(tamp) == len(jamp) == 17
    _cards_equal(tamp[0][0], jamp[0][0], skip=("IMSIMVER",))
    for (h1, d1), (h2, d2) in zip(tamp[1:], jamp[1:]):
        _cards_equal(h1, h2, skip=("PCOUNT", "TFORM1"))  # the data's size
        assert d1.dtype == np.int32 and d1.shape == d2.shape
        assert np.median(d1) > 500          # the bias level


def test_truth_matches_the_jax_visit(pair):
    (jres,), jdir = pair["jax"]
    (tres,), tdir = pair["port"]
    tj = np.loadtxt(os.path.join(jdir, "centroid_R22_S11.txt"))
    tt = np.loadtxt(os.path.join(tdir, "centroid_R22_S11.txt"))
    assert tt.shape == tj.shape and tt.shape[0] >= 6
    # id, ra, dec, x, y, nominal
    np.testing.assert_array_equal(tt[:, :6], tj[:, :6])
    assert np.array_equal(tt[:, 9], tj[:, 9])          # the modes
    assert tres["host"].n_objects == jres["host"].n_objects


def test_photometry_passes_the_jax_bar(pair):
    """tests/test_config_pipeline.py's aperture photometry on the port's
    eimage: each object within 5 sigma + 20% of its drawn flux."""
    (tres,), tdir = pair["port"]
    eimage, host = tres["eimage"], tres["host"]
    sky = np.mean(eimage[:100, :100])
    assert sky > 10.0
    truth_xy = np.loadtxt(os.path.join(tdir, "centroid_R22_S11.txt"),
                          usecols=(3, 4))
    R = 25
    ny, nx = eimage.shape
    n_ok = 0
    for i in range(host.n_objects):
        x, y = truth_xy[i]
        if not (R < x < nx - R and R < y < ny - R):
            continue
        box = eimage[int(y) - R:int(y) + R, int(x) - R:int(x) + R]
        sig = box.sum() - sky * box.size
        expect_i = host.flux[i]
        noise = np.sqrt(box.size * sky + expect_i)
        assert abs(sig - expect_i) < 5 * noise + 0.2 * expect_i, \
            (i, sig, expect_i, noise)
        if expect_i > 5 * noise:
            n_ok += 1
    assert n_ok >= 2


def test_checkpoint_resume_is_bit_equal(tmp_path, instcat, sed_dir,  # noqa: F811
                                        monkeypatch):
    over = _over(instcat, sed_dir, tmp_path / "o1", *FAST,
                 f"input.checkpoint.dir={tmp_path}/ck",
                 "output.readout.enabled=false")
    r1 = TR.run_visit({"template": "imsim-config-instcat"}, over,
                      device="cpu")
    (ck_file,) = (tmp_path / "ck").glob("checkpoint_*-r-R22_S11.npz")
    from imsim_tpu_torch.io.checkpoint import Checkpointer

    saved = Checkpointer(str(ck_file)).load("pooled")
    assert saved["next_batch"] >= 2 and saved["image"].sum() > 0

    def no_batch(*a, **k):
        raise AssertionError("a restored batch was rendered again")

    monkeypatch.setattr(TPP, "_pooled_batch_step", no_batch)
    r2 = TR.run_visit({"template": "imsim-config-instcat"},
                      over[:-1] + ["output.readout.enabled=false",
                                   f"output.dir={tmp_path}/o2"],
                      device="cpu")
    np.testing.assert_array_equal(r2[0]["eimage"], r1[0]["eimage"])
    np.testing.assert_array_equal(r2[0]["realized"], r1[0]["realized"])


@pytest.mark.parametrize("example, want", [
    ("flat.yaml", 1950.0), ("flat_with_sed.yaml", 300.0)])
def test_lsst_flat_configs(tmp_path, example, want):
    """The LSST_Flat branch at 64 x 48: the flat's file, its level (the
    SED flat loses the photons that convert below the silicon), and the
    JAX package's flat at the same size within 3% of the mean."""
    over = [f"output.dir={tmp_path}", "image.xsize=64", "image.ysize=48",
            "image.counts_per_pixel=2000", "image.counts_per_iter=500",
            "output.readout.enabled=false",
            "input.instance_catalog.sed_dir=" + os.path.join(REPO, "examples",
                                                              "seds")]
    path = os.path.join(REPO, "examples", example)
    (res,) = TR.run_visit(path, over, device="cpu")
    name = "flat_R22_S11.fits" if example == "flat.yaml" \
        else "flat_sed_R22_S11.fits"
    assert sorted(os.listdir(tmp_path)) == [name]
    (hdr, data), = read_fits(os.path.join(tmp_path, name))
    assert data.shape == (48, 64) and hdr["DET_NAME"] == "R22_S11"
    np.testing.assert_array_equal(data, res["eimage"])
    assert data.mean() > want
    (jres,) = JR.run_visit(path, over[1:] + [f"output.dir={tmp_path}/j"])
    jm = float(np.asarray(jres["eimage"]).mean())
    assert abs(data.mean() / jm - 1) < 0.03, (data.mean(), jm)


def _opsim_db(path):
    con = sqlite3.connect(path)
    con.execute(
        "CREATE TABLE observations (observationId INT, fieldRA REAL, "
        "fieldDec REAL, filter TEXT, observationStartMJD REAL, "
        "night INT, seeingFwhm500 REAL, rotTelPos REAL)")
    for vid, mjd in [(101, 60674.20), (102, 60674.21), (103, 60675.20)]:
        con.execute("INSERT INTO observations VALUES (?,?,?,?,?,?,?,?)",
                    (vid, 30.0, -20.0, "r", mjd, 0 if vid < 103 else 1, 0.7,
                     0.0))
    con.commit()
    con.close()


def _user_yaml(path, lines):
    path.write_text("template: imsim-config-instcat\n"
                    + "".join(f"{k}: {v}\n" for k, v in lines.items()))
    return str(path)


def test_cli_visits_over_an_opsim_db_and_jobs(tmp_path, instcat,  # noqa: F811
                                              sed_dir):
    db = str(tmp_path / "opsim.db")
    _opsim_db(db)
    user = _user_yaml(tmp_path / "user.yaml", {
        "input.opsim_data.file_name": db,
        "input.instance_catalog.file_name": instcat,
        "input.instance_catalog.sed_dir": sed_dir,
        "psf.type": "DoubleGaussianPSF", "image.sensor.type": "none",
        "image.sky_level": 0, "image.nobjects": 2,
        "image.batch_size": 50000, "image.nbatch": 2,
        "output.readout.enabled": "false", "output.cosmic_ray_rate": 0.0})
    out = str(tmp_path / "out")
    seen = []
    assert CLI.main([user, f"output.dir={out}", "output.det_num=[94]",
                     "--visits", "101,102", "-q", "--device", "cpu"],
                    on_result=lambda r: seen.append(r["det_name"])) == 0
    assert seen == ["R22_S11", "R22_S11"]
    for vid in (101, 102):
        assert os.path.exists(os.path.join(
            out, f"eimage_{vid}-r-R22_S11.fits")), vid
    # job 2 of 2 renders every second detector
    out2 = str(tmp_path / "out2")
    assert CLI.main([user, f"output.dir={out2}", "output.det_num=[93, 94]",
                     "--visits", "103:104", "-n", "2", "-j", "2", "-q",
                     "--device", "cpu"]) == 0
    assert sorted(os.listdir(out2)) == ["centroid_103_R22_S11.txt",
                                        "eimage_103-r-R22_S11.fits"]


def test_io_workers_write_the_serial_path_s_files(tmp_path, instcat,  # noqa: F811
                                                  sed_dir):
    """Two CCDs with the readout on: the IO pool (and the prefetch
    thread) write the files the serial path writes, byte for byte."""
    base = _over(instcat, sed_dir, tmp_path / "x", *FAST,
                 "output.det_num=[93, 94]", "image.nobjects=3",
                 "image.sky_level=0",
                 "output.process_info={file_name: info.txt}")
    runs = {}
    for name, extra in (("serial", ["output.prefetch=false"]),
                        ("io", ["output.io_workers=1"])):
        out = tmp_path / name
        res = TR.run_visit({"template": "imsim-config-instcat"},
                           base + extra + [f"output.dir={out}"],
                           device="cpu")
        assert [r["det_name"] for r in res] == ["R22_S10", "R22_S11"]
        runs[name] = out
    files = sorted(os.listdir(runs["serial"]))
    assert sorted(os.listdir(runs["io"])) == files and len(files) == 7
    for f in files:
        if f == "info.txt":
            continue
        assert (runs["io"] / f).read_bytes() == \
            (runs["serial"] / f).read_bytes(), f
    assert TR.HOST_TIMERS["io_s"] > 0 and TR.HOST_TIMERS["readout_s"] > 0


def _yaml(path, template, over: dict):
    """A user config: the template and one dotted key a line (flow-form
    JSON values)."""
    import json

    path.write_text("".join([f"template: {template}\n"] + [
        f"{k}: {json.dumps(v)}\n" for k, v in over.items()]))
    return str(path)


def _dotted(over: list) -> dict:
    """['a.b=v', ...] as {a.b: v} with the values read as YAML."""
    from imsim_tpu_torch.config.yaml_subset import safe_load

    return {k: safe_load(v) for k, v in (o.split("=", 1) for o in over)}


@pytest.mark.parametrize("key", ["sensor_model", "save_file",
                                 "sky_catalog"])
def test_ported_keys_run_a_yaml_visit(tmp_path, monkeypatch, instcat,
                                      sed_dir, key):  # noqa: F811
    """The keys the port once refused, each in a YAML visit on the CPU:
    image.sensor.sensor_model (a '{vendor}' vertex file; one batch with
    one BF stencil pass on the full frame), input.atm_psf.save_file (the
    second visit loads the first's screens and makes none: the same
    eimage; a name without .npz is never found, as in the JAX package),
    and input.sky_catalog (a parquet catalog on the skycat template, one
    opsim_meta value through RowData)."""
    from imsim_tpu_torch.benchmarks import skycat_workload as W

    over = _dotted(_over(instcat, sed_dir, tmp_path / "out", *FAST))
    template = "imsim-config-instcat"
    if key == "sensor_model":
        amp, core = W.SENSOR_MODELS["e2v"]
        W.synth_vertex_file(str(tmp_path / "lsst_e2v_synth.dat"), amp=amp,
                            core=core)
        over.update({"image.sensor.type": "Silicon",
                     "image.sensor.sensor_model": W.SENSOR_MODEL_NAME,
                     "image.sensor.sensor_model_dir": str(tmp_path),
                     "image.nbatch": 1, "image.nsubbatch": 1,
                     "image.batch_size": 10_000_000})
    elif key == "save_file":
        over.update({"psf.type": "AtmosphericPSF", "image.nobjects": 3})
    else:
        wl = W.write_workload(str(tmp_path / "wl"), n_rows=200,
                              window=(256, 256), margin=20.0, n_bright=0,
                              total_photons=5e4, n_gal_native=10,
                              n_star_native=5, native_photons=1e3)
        template = "imsim-config-skycat"
        over = {k: v for k, v in over.items()
                if not k.startswith("input.instance_catalog")}
        over.update({"input.sky_catalog.file_name": wl["catalog"],
                     "input.sky_catalog.sed_dir": wl["sed_dir"],
                     "opsim_meta": dict(W.OPSIM_META, rawSeeing={
                         "type": "RowData",
                         "file_name": wl["tables"]["csv"],
                         "key_column": "observationId",
                         "key_value": 181001, "field": "seeing"})})
    if key != "save_file":
        user = _yaml(tmp_path / "user.yaml", template, over)
        (res,) = TR.run_visit(user, device="cpu")
        assert np.isfinite(res["eimage"]).all() and res["eimage"].sum() > 0
        assert os.path.exists(tmp_path / "out" / "eimage_R22_S11.fits")
        if key == "sky_catalog":
            assert res["host"].n_objects > 200     # galaxies' components
            ctx = TR.build_visit_context(TI.load_config(user))
            assert ctx.opsim["rawSeeing"] == 0.85
        return
    made = []
    real = TR.make_screens
    monkeypatch.setattr(TR, "make_screens",
                        lambda *a, **k: made.append(1) or real(*a, **k))
    for name, n_made in (("atm.npz", [1, 1]), ("atm_saved", [1, 2])):
        eims = []
        for run in range(2):
            over["input.atm_psf.save_file"] = str(tmp_path / name)
            over["output.dir"] = str(tmp_path / f"out_{name}_{run}")
            (res,) = TR.run_visit(_yaml(tmp_path / "user.yaml", template,
                                        over), device="cpu")
            eims.append(res["eimage"])
            assert len(made) == n_made[run]
        assert np.array_equal(eims[0], eims[1])
        made.clear()
    assert os.path.exists(tmp_path / "atm_saved.npz")
    assert not os.path.exists(tmp_path / "atm_saved")
