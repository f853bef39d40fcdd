"""The instance-catalog CCD in the port (imsim_tpu_torch.config.runner)
against the JAX package's runner, on the CPU:

  * prepare_ccd and the sky-noise pieces, leaf by leaf, on a generated
    ~300-object catalog of R22_S11 (benchmarks/instcat_workload.py) in r
    and in y (fringing): the host steps bit-equal, except what follows
    from each package's own WCS (pixel positions 1e-9 px, field angles 1
    float32 ulp, the sky level and gradient 1e-12 relative; ROADMAP C);
  * (tests/test_torch_instcat_render.py: both packages' renders of that
    catalog's central 512 x 512 window);
  * the committed digest (imsim_tpu_torch/data/instcat_r22_s11_digest.npz,
    chip_smoke gate (o)) belongs to the catalog the generator writes.

The digest's exporter lives here, beside the JAX package it needs.
Where JAX is installed,

    python tests/test_torch_instcat_ccd.py

rewrites the digest from the JAX package's own prepare_ccd and
_sky_noise_pieces on the full-size generated workload (a few minutes)."""
import dataclasses
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from imsim_tpu.config import runner as JR  # noqa: E402
from imsim_tpu.config.interpreter import load_config  # noqa: E402
from imsim_tpu.image import photon_pooling as JPP  # noqa: E402
from imsim_tpu_torch import convert as CV  # noqa: E402
from imsim_tpu_torch.benchmarks import instcat_workload as W  # noqa: E402
from imsim_tpu_torch.config import runner as TR  # noqa: E402
from imsim_tpu_torch.image import photon_pooling as TPP  # noqa: E402

torch.set_num_threads(1)

DET = "R22_S11"
WINDOW = (512, 512)
# the ~300-object catalog over R22_S11's central window (+50 px), with
# two bright stars for the FFT pass
SMALL = dict(n_lines=300, window=WINDOW, margin=50.0, n_bright=2,
             total_photons=2e5)


def jax_context(catalog, sed_dir, **over):
    """The JAX runner's visit from its instance-catalog template (small
    atmosphere screens: they enter neither the prep nor the pieces)."""
    cfg = {"template": "imsim-config-instcat",
           "input.instance_catalog.file_name": catalog,
           "input.instance_catalog.sed_dir": sed_dir,
           "input.atm_psf.screen_size": 102.4,
           "output.readout.enabled": False}
    cfg.update(over)
    return JR.build_visit_context(load_config(cfg))


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return W.write_workload(str(tmp_path_factory.mktemp("instcat")), **SMALL)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.ascontiguousarray(a).tobytes() == np.ascontiguousarray(b).tobytes()


def _ulps(a, b):
    return W._ulps(a, b)


def leaf_gaps(jctx, jprep, jpieces, tctx, tprep, tpieces):
    """{leaf: reason} of every leaf past its bar."""
    bad = {}

    def check(name, ok, why=""):
        if not ok:
            bad[name] = why

    check("det", (jprep.det_num, jprep.det_name) == (tprep.det_num,
                                                     tprep.det_name))
    check("exptime", jprep.exptime == tprep.exptime)
    check("use_optics", jprep.use_optics == tprep.use_optics)
    # the optics: the telescope matrix and the optics context (the
    # context's float32 scalars and the surface matrix bit-equal)
    check("tel32", _same(CV.telescope_from_numpy(jprep.tel32).surf,
                         tprep.tel32.surf))
    check("octx", CV.optics_context_from_numpy(jprep.octx) == tprep.octx,
          f"{CV.optics_context_from_numpy(jprep.octx)} vs {tprep.octx}")
    # the WCS: each package's own fit (~1e-16 rad apart)
    x, y = np.meshgrid(np.linspace(0, 4095, 9), np.linspace(0, 4003, 9))
    ra_j, dec_j = jprep.wcs.xy_to_radec(x, y)
    ra_t, dec_t = tprep.wcs.xy_to_radec(x, y)
    check("wcs", max(np.abs(ra_j - ra_t).max(),
                     np.abs(dec_j - dec_t).max()) < 1e-12)
    jb, tb = jprep.bandpass, tprep.bandpass
    check("bandpass", _same(jb.wave, tb.wave) and _same(jb.throughput,
                                                        tb.throughput)
          and jb.zeropoint == tb.zeropoint)
    # the table: bit-equal but the pixel positions from each WCS
    for k in jprep.table.__dataclass_fields__:
        a, b = getattr(jprep.table, k), getattr(tprep.table, k)
        if k in ("x", "y"):
            check(f"table.{k}", np.abs(a - b).max() < 1e-9)
        elif np.asarray(a).dtype == object:
            check(f"table.{k}", list(a) == list(b))
        else:
            check(f"table.{k}", _same(a, b))
    # the scene
    jh, th = jprep.host, tprep.host
    n = th.n_objects
    check("host.n", jh.n_objects == n and jh.scene.n == th.scene.n)
    check("host.flux", _same(jh.flux, th.flux))
    check("host.nominal", _same(jh.nominal_flux, th.nominal_flux))
    jp, tp = np.asarray(jh.scene.params), th.scene.params.numpy()
    check("params", _same(jp[:, 2:], tp[:, 2:]) and _same(jp[n:], tp[n:]))
    for c in (0, 1):
        check(f"params.{c}", _ulps(jp[:n, c], tp[:n, c]) <= 1,
              f"{_ulps(jp[:n, c], tp[:n, c])} ulps")
    for k in ("wl_icdf", "labs_icdf", "wl_cheb", "aux_cloud"):
        check(f"scene.{k}", _same(np.asarray(getattr(jh.scene, k)),
                                  getattr(th.scene, k).numpy()))
    for k in ("pix_x", "pix_y"):
        check(f"host.{k}", np.abs(getattr(jh, k) - getattr(th, k)).max()
              < 1e-9)
    # silicon, pooling configuration, second kick, spikes, vignetting
    js = CV.silicon_from_numpy(jprep.silicon)
    for f in dataclasses.fields(js):
        a, b = getattr(js, f.name), getattr(tprep.silicon, f.name)
        check(f"silicon.{f.name}", _same(a, b) if isinstance(
            a, np.ndarray) else a == b)
    for f in dataclasses.fields(tprep.pcfg):
        a, b = getattr(jprep.pcfg, f.name), getattr(tprep.pcfg, f.name)
        if f.name == "psf_table" and a is not None and b is not None:
            check("pcfg.psf_table", (a.x0, a.dx) == (b.x0, b.dx)
                  and _same(np.asarray(a.y), b.y))
        elif f.name != "noise_var":
            check(f"pcfg.{f.name}", a == b, f"{a} vs {b}")
    rel = abs(tprep.sky_level / jprep.sky_level - 1)
    check("sky_level", rel <= 1e-12, f"{rel:.3g}")
    check("noise_var", tprep.pcfg.noise_var == tprep.sky_level)
    check("centre", abs(jprep.ra_c - tprep.ra_c) < 1e-12
          and abs(jprep.dec_c - tprep.dec_c) < 1e-12)
    if jprep.sk_table is None or tprep.sk_table is None:
        check("sk_table", jprep.sk_table is tprep.sk_table is None)
    else:
        ja, ta = CV.polycdf_from_numpy(jprep.sk_table), tprep.sk_table
        check("sk_table", _same(ja.c_core, ta.c_core) and _same(
            ja.c_tail, ta.c_tail) and (ja.u_split, ja.s_lo, ja.s_hi) ==
              (ta.u_split, ta.s_lo, ta.s_hi))
    # the spike kernel: the same saturation and shape; its calibrated
    # fraction is drawn on each device's stream (ROADMAP C, PR 6)
    jk, tk = np.asarray(jprep.spikes["kernel"]), tprep.spikes["kernel"]
    check("spikes", jprep.spikes["sat"] == tprep.spikes["sat"]
          and jk.shape == tk.shape
          and abs((1 - jk[256, 256]) - (1 - tk[256, 256])) < 0.003)
    check("fft_vign", np.abs(np.asarray(jprep.fft_vign) - tprep.fft_vign)
          .max() < 1e-12)
    # the sky pieces
    jl, jg, jv, js_, jf = jpieces
    tl, tg, tv, ts, tf = tpieces
    check("pieces.level", abs(tl / jl - 1) <= 1e-12)
    check("pieces.gradient", max(_ulps(np.float32(a), np.float32(b))
                                 for a, b in zip(jg, tg)) <= 1,
          f"{jg} vs {tg}")
    check("pieces.vignetting", _same(np.asarray(jv, np.float32), tv)
          and js_ == ts)
    check("pieces.fringe", (jf is None and tf is None)
          or (tf is not None and _same(np.asarray(jf), tf)))
    return bad


@pytest.mark.parametrize("band", ["r", "y"])
def test_prep_and_pieces_match_the_jax_runner(small, band):
    cat, seds = small["catalog"][band], small["sed_dir"]
    jctx = jax_context(cat, seds)
    jprep = JR.prepare_ccd(jctx, 94)
    jpieces = JR._sky_noise_pieces(jctx, jprep)
    tctx = W.visit_context(cat, seds)
    tprep = TR.prepare_ccd(tctx, DET, device="cpu")
    tpieces = TR.sky_noise_pieces(tctx, tprep)
    assert tprep.host.n_objects == 300
    assert (tpieces[4] is not None) == (band == "y")
    bad = leaf_gaps(jctx, jprep, jpieces, tctx, tprep, tpieces)
    assert not bad, bad
    # the digest's own comparison agrees
    want = W.prep_digest(jctx, jprep, jpieces, JPP.classify_objects(
        jprep.host, jprep.pcfg, JPP.make_psf_mtf(jprep.pcfg)), band)
    got = W.prep_digest(tctx, tprep, tpieces, TPP.classify_objects(
        tprep.host, tprep.pcfg, TPP.make_psf_mtf(tprep.pcfg)), band)
    bad, gaps = W.digest_mismatches(got, want, band)
    assert not bad, (bad, gaps)


@pytest.mark.parametrize("over", [
    {"psf.type": "DoubleGaussianPSF"},
    {"psf.type": "DoubleGaussianPSF", "psf.fwhm": 0.9},
    {"psf.type": "KolmogorovPSF"}])
def test_analytic_psf_prep_matches_the_jax_runner(small, over):
    """A PSF other than AtmosphericPSF: no atmosphere, pixel positions in
    COL_X / COL_Y; DoubleGaussianPSF's radial table from the opsim
    FWHMgeom (or the reference's psf.fwhm shape); bit-equal to the JAX
    runner's."""
    cat, seds = small["catalog"]["r"], small["sed_dir"]
    jctx = jax_context(cat, seds, **over)
    jprep = JR.prepare_ccd(jctx, 94)
    tctx = W.visit_context(cat, seds, over)
    tprep = TR.prepare_ccd(tctx, DET, device="cpu")
    assert not tprep.use_optics and tctx.atm_cfg is None
    assert (tprep.pcfg.psf_table is not None) == (
        over["psf.type"] == "DoubleGaussianPSF")
    assert tprep.pcfg.chromatic_exponent == 0.0
    bad = leaf_gaps(jctx, jprep, JR._sky_noise_pieces(jctx, jprep), tctx,
                    tprep, TR.sky_noise_pieces(tctx, tprep))
    assert not bad, bad


def test_unknown_settings_are_refused(small):
    """A config value of an unregistered type, and a window off the
    frame's centre, are refused."""
    with pytest.raises(KeyError, match="unknown config type"):
        W.visit_context(small["catalog"]["r"], small["sed_dir"],
                        {"eval_variables": {"fbad": {"type": "NoSuchType"}}})
    ctx = W.visit_context(small["catalog"]["r"], small["sed_dir"])
    with pytest.raises(ValueError, match="window"):
        TR.prepare_ccd(ctx, DET, window=(511, 512), device="cpu")


def test_fringe_on_a_device_follows_the_host_map(small):
    """sky_noise_pieces with a device uploads the host numpy map there,
    unchanged."""
    tctx = W.visit_context(small["catalog"]["y"], small["sed_dir"])
    tprep = TR.prepare_ccd(tctx, DET, window=WINDOW, device="cpu")
    host = TR.sky_noise_pieces(tctx, tprep)[4]
    dev = TR.sky_noise_pieces(tctx, tprep, device="cpu")[4]
    assert host.shape == WINDOW and isinstance(dev, torch.Tensor)
    assert np.array_equal(dev.numpy(), host)


def _throughputs(root):
    """rubin_sim-shaped r-band throughput files, synthetic (as
    tests/test_torch_catalog.py writes them)."""
    base = os.path.join(root, "baseline")
    os.makedirs(base)
    w = np.linspace(300, 1100, 801)
    filt = np.where((w > 550) & (w < 690), 0.95, 0.0)
    np.savetxt(os.path.join(base, "filter_r.dat"), np.column_stack([w, filt]))
    for part in ("m1", "m2", "m3", "lens1", "lens2", "lens3"):
        np.savetxt(os.path.join(base, f"{part}.dat"),
                   np.column_stack([w, np.full_like(w, 0.98)]))
    np.savetxt(os.path.join(base, "hardware_r.dat"),
               np.column_stack([w, filt * 0.98**6 * 0.9]))
    np.savetxt(os.path.join(base, "total_r.dat"),
               np.column_stack([w, filt * 0.98**6 * 0.9 * 0.8]))
    atm = os.path.join(root, "atmos")
    os.makedirs(atm)
    for X in (10, 12, 15, 20):
        t = np.exp(-0.1 * X / 10.0 * (w / 600) ** -1) * np.ones_like(w)
        np.savetxt(os.path.join(atm, f"atmos_{X}_aerosol.dat"),
                   np.column_stack([w, t]))
    return root


@pytest.mark.parametrize("band, keys", [
    ("y", ("image.sky_sed_file", "image.fringing_skyline_file")),
    ("r", ("image.bandpass.throughputs_dir",))])
def test_loaded_inputs_match_the_jax_runner(small, tmp_path, band, keys):
    """The runner's file inputs: a loaded sky spectrum (the sky level and
    the fringe amplitude), a measured skyline surface (the fringe map)
    and measured throughput files (the bandpass and every flux), each
    package reading its own copy of the same file; leaf by leaf as in
    test_prep_and_pieces_match_the_jax_runner."""
    from imsim_tpu.image.sky_sed import default_library_path as jlib
    from imsim_tpu.io.fits import HDU, write_fits
    from imsim_tpu_torch.image.sky_sed import default_library_path as tlib

    skyline = str(tmp_path / "skyline.fits")
    write_fits(skyline, [HDU(1 + 0.05 * np.random.default_rng(3).normal(
        size=(9, 11)))])
    paths = {"image.sky_sed_file": (jlib(), tlib()),
             "image.fringing_skyline_file": (skyline, skyline),
             "image.bandpass.throughputs_dir": (
                 (d := _throughputs(str(tmp_path / "throughputs"))), d)}
    jover = {k: paths[k][0] for k in keys}
    tover = {k: paths[k][1] for k in keys}
    cat, seds = small["catalog"][band], small["sed_dir"]
    jctx = jax_context(cat, seds, **jover)
    jprep = JR.prepare_ccd(jctx, 94)
    tctx = W.visit_context(cat, seds, tover)
    tprep = TR.prepare_ccd(tctx, DET, device="cpu")
    tpieces = TR.sky_noise_pieces(tctx, tprep)
    assert (tctx.sky_model.sky_sed is not None) == (band == "y")
    bad = leaf_gaps(jctx, jprep, JR._sky_noise_pieces(jctx, jprep), tctx,
                    tprep, tpieces)
    assert not bad, bad
    base = W.visit_context(cat, seds)
    if band == "y":
        # the loaded inputs change the fringe map
        plain = TR.sky_noise_pieces(base, TR.prepare_ccd(base, DET,
                                                         device="cpu"))
        assert not np.array_equal(plain[4], tpieces[4])
    else:
        assert not np.array_equal(base.bandpass.throughput,
                                  tctx.bandpass.throughput)


def test_digest_belongs_to_the_generated_catalog(tmp_path):
    """The committed digest's catalog hashes are the generator's: the
    full-size workload written here hashes to them."""
    with np.load(W.DIGEST) as z:
        want = {b: str(z[f"{b}.catalog_sha256"]) for b in "ry"}
        n_kept = int(z["r.n_kept"])
    res = W.write_workload(str(tmp_path))
    assert res["sha256"] == want
    assert 9e4 < n_kept < 1.1e5


def export_digest(path: str = W.DIGEST) -> dict:
    """The JAX package's prepare_ccd and _sky_noise_pieces on R22_S11 of
    the full-size generated workload, r and y, as W.prep_digest leaves,
    with each catalog's sha256; written to `path`."""
    out = {}
    with tempfile.TemporaryDirectory() as d:
        res = W.write_workload(d)
        for band in "ry":
            ctx = jax_context(res["catalog"][band], res["sed_dir"])
            prep = JR.prepare_ccd(ctx, 94)
            pieces = JR._sky_noise_pieces(ctx, prep)
            modes = JPP.classify_objects(prep.host, prep.pcfg,
                                         JPP.make_psf_mtf(prep.pcfg))
            out.update(W.prep_digest(ctx, prep, pieces, modes, band))
            out[f"{band}.catalog_sha256"] = res["sha256"][band]
            print(band, {k: out[k] for k in out if k.startswith(band) and
                         np.size(out[k]) < 4}, flush=True)
    np.savez_compressed(path, **out)
    return out


if __name__ == "__main__":
    export_digest()
    print(W.DIGEST, os.path.getsize(W.DIGEST), "bytes")
