"""The skyCatalogs CCD in the port (imsim_tpu_torch.config.runner with
the imsim-config-skycat template) against the JAX package's runner, on
the CPU:

  * prepare_ccd and the sky-noise pieces leaf by leaf on a generated
    ~300-row mapped-schema parquet catalog over R22_S11's central window
    (benchmarks/skycat_workload.py; the JAX package reads it through
    pandas, the port through io/parquet), with the bars of
    test_torch_instcat_ccd (host steps bit-equal; pixel positions 1e-9
    px, field angles 1 float32 ulp, the sky level 1e-12); also the
    native catalog with a sensor model, skip_missing_sed, approx_nobjects
    and max_flux;
  * both runners' renders of the central 512 x 512 window, statistically;
  * the committed digest (imsim_tpu_torch/data/skycat_r22_s11_digest.npz,
    chip_smoke gate (w)) belongs to the files the generator writes.

Where JAX, pandas and pyarrow are installed,

    python tests/test_torch_skycat_ccd.py

rewrites the digest from the JAX package's own prepare_ccd on the
full-size workload, its native catalog's ObjectTable and its sensor
models' BF kernels (a few minutes)."""
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from imsim_tpu.catalog.skycat import SkyCatalogInterface as JSky  # noqa: E402
from imsim_tpu.config import runner as JR  # noqa: E402
from imsim_tpu.config.interpreter import load_config as jload  # noqa: E402
from imsim_tpu.image import photon_pooling as JPP  # noqa: E402
from imsim_tpu.sensor import sensor_model as JSM  # noqa: E402
from imsim_tpu_torch import convert as CV  # noqa: E402
from imsim_tpu_torch.benchmarks import instcat_workload as IW  # noqa: E402
from imsim_tpu_torch.benchmarks import skycat_workload as W  # noqa: E402
from imsim_tpu_torch.config import runner as TR  # noqa: E402
from imsim_tpu_torch.image import photon_pooling as TPP  # noqa: E402

from test_torch_instcat_ccd import DET, WINDOW, leaf_gaps  # noqa: E402
from test_torch_instcat_render import _centroids, _jax_window  # noqa: E402

torch.set_num_threads(1)

# ~300 mapped rows over R22_S11's central window (+50 px), two bright
# stars; a 60-galaxy, 20-star native catalog there
SMALL = dict(n_rows=300, window=WINDOW, margin=50.0, n_bright=2,
             total_photons=2e5, n_gal_native=60, n_star_native=20,
             native_photons=5e4)
SMALL_OVER = {"input.atm_psf.screen_size": 102.4}


def jax_context(catalog, sed_dir, **over):
    """The JAX runner's visit on its skycat template at the workload's
    visit."""
    return JR.build_visit_context(jload(W.visit_config(
        catalog, sed_dir, {"output.readout.enabled": False, **over})))


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return W.write_workload(str(tmp_path_factory.mktemp("skycat")), **SMALL)


def _both(small, catalog, over):
    """Both runners' prep and sky pieces of R22_S11."""
    jctx = jax_context(catalog, small["sed_dir"], **SMALL_OVER, **over)
    jprep = JR.prepare_ccd(jctx, 94)
    tctx = W.visit_context(catalog, small["sed_dir"], {**SMALL_OVER, **over})
    tprep = TR.prepare_ccd(tctx, DET, device="cpu")
    return (jctx, jprep, JR._sky_noise_pieces(jctx, jprep), tctx, tprep,
            TR.sky_noise_pieces(tctx, tprep))


def prep_gaps(jctx, jprep, jpieces, tctx, tprep, tpieces):
    """leaf_gaps, with the inline SEDs held by their wave and fphot
    arrays (bit-equal) instead of by identity."""
    bad = leaf_gaps(jctx, jprep, jpieces, tctx, tprep, tpieces)
    bad.pop("table.sed_obj", None)
    js, ts = jprep.table.sed_obj, tprep.table.sed_obj
    if len(js) != len(ts) or any(
            (a is None) != (b is None) or (a is not None and not (
                np.array_equal(a.wave, b.wave)
                and np.array_equal(a.fphot, b.fphot)))
            for a, b in zip(js, ts)):
        bad["table.sed_obj"] = "inline SEDs differ"
    return bad


def test_mapped_prep_matches_the_jax_runner(small):
    both = _both(small, small["catalog"], {})
    jctx, jprep, jpieces, tctx, tprep, tpieces = both
    # 300 rows: the stars and each galaxy's components
    assert 300 < tprep.host.n_objects < 900
    bad = prep_gaps(*both)
    assert not bad, bad
    want = IW.prep_digest(jctx, jprep, jpieces, JPP.classify_objects(
        jprep.host, jprep.pcfg, JPP.make_psf_mtf(jprep.pcfg)), "r")
    got = IW.prep_digest(tctx, tprep, tpieces, TPP.classify_objects(
        tprep.host, tprep.pcfg, TPP.make_psf_mtf(tprep.pcfg)), "r")
    bad, gaps = IW.digest_mismatches(got, want, "r")
    assert not bad, (bad, gaps)


@pytest.mark.parametrize("over", [
    {"input.sky_catalog.skip_missing_sed": True,
     "input.sky_catalog.approx_nobjects": 2000,
     "input.sky_catalog.max_flux": 3e4},
    {"input.sky_catalog.obj_types": ["galaxy"],
     "input.sky_catalog.apply_dc2_dilation": True}])
def test_mapped_options_match_the_jax_runner(small, over):
    """skip_missing_sed, approx_nobjects (the scene padded to 2048 rows)
    and max_flux; obj_types and the DC2 dilation: leaf by leaf."""
    both = _both(small, small["catalog"], over)
    bad = prep_gaps(*both)
    assert not bad, bad
    tprep = both[4]
    if "input.sky_catalog.approx_nobjects" in over:
        assert tprep.host.scene.n == 2048
        assert (tprep.host.nominal_flux == 0).any()
    else:
        assert (tprep.table.obj_type != 0).all()


def test_native_prep_with_a_sensor_model_matches_the_jax_runner(small):
    """The native catalog (healpix files, inline tophat SEDs) with the
    generated sensor model named '{vendor}'-style: leaf by leaf, the
    silicon's BF kernel included; the native catalog's SED seconds are a
    step of their own."""
    over = {"image.sensor.sensor_model": W.SENSOR_MODEL_NAME,
            "image.sensor.sensor_model_dir": small["sensor_model_dir"]}
    both = _both(small, small["native"], over)
    bad = prep_gaps(*both)
    assert not bad, bad
    tprep = both[4]
    assert "tophat seds" in tprep.seconds
    assert (tprep.table.sed_name == "tophat:disk").any()
    want = JSM.bf_kernel_from_model(os.path.join(
        small["sensor_model_dir"], "lsst_e2v_synth.dat"))
    assert np.array_equal(tprep.silicon.bf_kernel, want)


def test_render_matches_the_jax_render(small):
    """Both runners render the central window with the sky off, through
    the same atmosphere screens: the charge within 5 sqrt of it, the
    bright isolated stars' centroids within 5 sigma of each other (each
    sigma: the star's rms radius in its box over sqrt(photons))."""
    cat, seds = small["catalog"], small["sed_dir"]
    jctx = jax_context(cat, seds, **SMALL_OVER, **{"image.sky_level": 0})
    jprep = _jax_window(jctx, JR.prepare_ccd(jctx, 94), *WINDOW)
    jimg = np.asarray(JR.render_one_ccd(jctx, 94, write=False,
                                        prep=jprep)["eimage"])
    tctx = W.visit_context(cat, seds, {**SMALL_OVER, "image.sky_level": 0})
    # the JAX package's screens: each star's centroid moves with the
    # atmosphere's tip-tilt over the exposure, which two independent
    # atmospheres would not share
    tctx._screens["cpu"] = CV.screens_from_numpy(jctx.screens, "cpu")
    res = TR.render_one_ccd(tctx, DET, "cpu", window=WINDOW)
    timg = res["eimage"].numpy()
    assert timg.shape == jimg.shape == WINDOW
    sj, st = jimg.sum(dtype=np.float64), timg.sum(dtype=np.float64)
    assert abs(sj - st) <= 5 * np.sqrt(sj), (sj, st)
    prep = res["prep"]
    host, tab = prep.host, prep.table
    n = host.n_objects
    x, y, f = host.pix_x, host.pix_y, host.nominal_flux[:n]
    pick = []
    # stars of >= 1e3 photons with no object of 1% of their flux within
    # 20 px (galaxies' wings reach past 12)
    for i in np.nonzero((tab.obj_type == 0) & (f > 1e3))[0]:
        near = (np.hypot(x - x[i], y - y[i]) < 20) & (f > 0.01 * f[i])
        if near.sum() == 1 and 8 < x[i] < WINDOW[1] - 9 and \
                8 < y[i] < WINDOW[0] - 9:
            pick.append(i)
    assert len(pick) >= 3
    cj, ct = (_centroids(img, x[pick], y[pick]) for img in (jimg, timg))
    # each centroid's sigma: the box's own rms radius over sqrt(photons)
    sig2 = sum(_box_rms(img, x[pick], y[pick]) ** 2 / c[:, 2]
               for img, c in ((jimg, cj), (timg, ct)))
    gap = np.abs(cj[:, :2] - ct[:, :2]).max(axis=1)
    assert (gap < 5 * np.sqrt(sig2)).all(), (cj, ct, np.sqrt(sig2))


def _box_rms(img, xs, ys, r=5):
    """Per star, the rms offset along one axis of the charge in the
    (2r + 1)^2 box about its centroid."""
    out = []
    for x, y in zip(xs, ys):
        ix, iy = int(round(x)), int(round(y))
        box = np.asarray(img[iy - r:iy + r + 1, ix - r:ix + r + 1],
                         np.float64)
        yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
        s = box.sum()
        mx, my = (box * xx).sum() / s, (box * yy).sum() / s
        out.append(np.sqrt(max((box * (xx - mx) ** 2).sum(),
                               (box * (yy - my) ** 2).sum()) / s))
    return np.array(out)


def test_digest_belongs_to_the_generated_workload(tmp_path):
    """The committed digest's file hashes are the generator's: the
    full-size workload written here hashes to them."""
    with np.load(W.DIGEST) as z:
        want = json.loads(str(z["sha256"]))
        n_kept = int(z["r.n_kept"])
        n_native = int(z["native.n"])
    res = W.write_workload(str(tmp_path))
    assert res["sha256"] == want
    assert 1.5e5 < n_kept < 3e5 and 1.5e4 < n_native < 3e4


def export_digest(path: str = W.DIGEST) -> dict:
    """The JAX package on the full-size workload: prepare_ccd and the sky
    pieces of R22_S11 from the mapped catalog (W.visit_config; pandas
    reads the generator's bytes) as prep_digest leaves `r.*`, the native
    catalog's whole ObjectTable as table_digest leaves `native.*`, the
    sensor models' BF kernels `bf_kernel.<vendor>` and every parquet
    file's sha256; written to `path`."""
    out = {}
    with tempfile.TemporaryDirectory() as d:
        res = W.write_workload(d)
        ctx = JR.build_visit_context(jload(W.visit_config(
            res["catalog"], res["sed_dir"])))
        prep = JR.prepare_ccd(ctx, 94)
        pieces = JR._sky_noise_pieces(ctx, prep)
        modes = JPP.classify_objects(prep.host, prep.pcfg,
                                     JPP.make_psf_mtf(prep.pcfg))
        out.update(IW.prep_digest(ctx, prep, pieces, modes, "r"))
        tab = JSky(res["native"]).to_object_table()
        out.update({f"native.{k}": v for k, v in
                    W.table_digest(tab).items()})
        for vendor in W.SENSOR_MODELS:
            out[f"bf_kernel.{vendor}"] = JSM.bf_kernel_from_model(
                os.path.join(res["sensor_model_dir"],
                             W.SENSOR_MODEL_NAME.format(vendor=vendor)
                             + ".dat"))
        out["sha256"] = json.dumps(res["sha256"], sort_keys=True)
        print({k: out[k] for k in out if np.size(out[k]) < 4}, flush=True)
    np.savez_compressed(path, **out)
    return out


if __name__ == "__main__":
    export_digest()
    print(W.DIGEST, os.path.getsize(W.DIGEST), "bytes")
