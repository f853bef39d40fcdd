"""The port's multi-device visit (imsim_tpu_torch.parallel.mesh / visit)
on the CPU, with gloo ranks started by tests/torch_ranks.py, against the
port's serial visit and the JAX package's mesh path:

  * _parse_mesh_cfg equals the JAX function; each CCD's pooled geometry
    (nb, batch_size, the scene's rows, cums, totals) equals what the JAX
    run_visit_mesh feeds its sharded step (captured by monkeypatching
    imsim_tpu.parallel.visit.mesh_pooled_step and its block stages);
  * phot rank p of outer step k runs batch b = k*M + p with the serial
    streams ("photons", b) and ("si", b);
  * run_visit_sharded on 4 ranks ({ccd: 2, phot: 2}) keeps
    __graft_entry__'s flux accounting: expected = landed + edge-clipped
    + lost, |lost| / expected < 3e-3;
  * {phot: 2} on 2 ranks with the silicon on (a 256 x 256 window):
    the charge of the one-rank pass within 2% (the visit-level gates are
    in tests/test_torch_mesh_visit.py);
  * the JAX mesh visit {ccd: 2, phot: 2} on the 8 virtual devices of
    tests/conftest.py and the port's {ccd: 2, phot: 2} on 4 ranks carry
    the same charge per CCD within the JAX package's 2%.

The visits render tests/test_config_pipeline.py's kind of catalog (a
flat SED, points and Sersic discs) with six objects on each of R22_S10
and R22_S11, the DoubleGaussianPSF and no sensor (full frames)."""
import os

import numpy as np
import pytest
import torch

from imsim_tpu.config import runner as JR
from imsim_tpu.parallel import visit as JV
from imsim_tpu_torch.config import runner as TR
from imsim_tpu_torch.image import photon_pooling as TPP
from imsim_tpu_torch.parallel import visit as TV
from imsim_tpu_torch.parallel.mesh import make_mesh
from imsim_tpu_torch.utils.rng import stream_seed

import torch_ranks

torch.set_num_threads(1)

DEG = np.pi / 180
DETS = ("R22_S10", "R22_S11")
FAST = ["psf.type=DoubleGaussianPSF", "image.sensor.type=none",
        "image.batch_size=50000", "image.nbatch=3",
        "output.cosmic_ray_rate=0.05"]


@pytest.fixture(scope="module")
def two_ccds(tmp_path_factory):
    return torch_ranks.two_ccd_catalog(tmp_path_factory.mktemp("two_ccds"))


def overrides(cat, out, *extra, dets=(93, 94)):
    return [f"input.instance_catalog.file_name={cat[0]}",
            f"input.instance_catalog.sed_dir={cat[1]}",
            f"output.dir={out}", f"output.det_num={list(dets)}",
            "output.file_name=eimage_{det_name}.fits",
            "output.readout.file_name=amp_{det_name}.fits",
            "output.truth.file_name=centroid_{det_name}.txt", *FAST, *extra]


TEMPLATE = {"template": "imsim-config-instcat"}


@pytest.mark.parametrize("mesh_cfg", [
    True, "auto", 1, 3, 2.0, "2", {"ccd": 2}, {"phot": 2},
    {"ccd": 1, "phot": 4}, {}])
def test_parse_mesh_cfg_is_the_jax_function(mesh_cfg):
    assert TV._parse_mesh_cfg(mesh_cfg, 4) == JV._parse_mesh_cfg(mesh_cfg, 4)


def test_each_ccd_s_geometry_is_the_jax_mesh_s(two_ccds, tmp_path,
                                               monkeypatch):
    """output.mesh={ccd: 1} in both packages, R22_S10 and R22_S11 in
    blocks of one: nb, batch_size, n_pad, m_pad, cums and totals of each
    block of the JAX path equal the port's pooled pass of that CCD.  (The
    port renders every CCD with its own plan; a JAX block of several
    CCDs takes the largest nb and batch_size of the block.)"""
    jax_blocks = []

    def fake_step(mesh, nb, batch_size, pair, M, nsub, exptime, ce, wl,
                  use_silicon, use_optics, share=1):
        geo = dict(nb=nb, batch_size=batch_size, pair=pair, share=share,
                   M=M)
        jax_blocks.append(geo)

        def step(keys, si_keys, scenes, obj_maps, cums, totals, *rest):
            geo.update(cums=np.asarray(cums), totals=np.asarray(totals),
                       n_pad=scenes.params.shape[1],
                       m_pad=scenes.aux_cloud.shape[1])
            return rest[-3], rest[-2]                  # images, realized
        return step

    monkeypatch.setattr(JV, "mesh_pooled_step", fake_step)
    monkeypatch.setattr(JV, "_readout_sharded", lambda *a, **k: {})
    monkeypatch.setattr(JR, "write_outputs", lambda *a, **k: None)
    over = overrides(two_ccds, tmp_path / "j", "output.mesh={ccd: 1}",
                     "image.sky_level=0", "output.cosmic_ray_rate=0",
                     "output.readout.enabled=false")
    JR.run_visit(TEMPLATE, over)

    port = []
    real = TV.pooled_pass

    def spy(*a, **k):
        ps = real(*a, **k)
        port.append(ps)
        return ps

    monkeypatch.setattr(TV, "pooled_pass", spy)
    TR.run_visit(TEMPLATE, over, device="cpu")
    assert len(jax_blocks) == len(port) == 2
    for geo, ps in zip(jax_blocks, port):
        assert geo["M"] == 1 and geo["cums"].shape[0] == 1
        assert (geo["nb"], geo["batch_size"], geo["pair"], geo["share"]) \
            == (ps.nb, ps.batch_size, ps.pair, ps.share)
        assert geo["n_pad"] == ps.host.scene.n
        assert geo["m_pad"] == ps.host.scene.aux_cloud.shape[0]
        np.testing.assert_array_equal(geo["cums"][0], ps.cum.numpy())
        assert int(geo["totals"][0]) == ps.total > 0


class _Mesh:
    """A phot rank's view of a (1, M) mesh, for the step alone."""

    def __init__(self, p, M):
        self.coordinate, self.M = (0, p), M

    def size(self, axis):
        return self.M if axis == "phot" else 1


@pytest.mark.parametrize("M, nb", [(1, 3), (2, 5), (3, 7)])
def test_phot_rank_p_runs_batch_k_m_plus_p(monkeypatch, M, nb):
    """Each outer step k runs batch k*M + p on rank p, every batch once
    over the group, and a rank past the last batch adds a zero delta."""
    monkeypatch.setattr(TV, "all_reduce", lambda t, mesh, axis="phot": t)
    seen = []

    class PS:
        def batch(self, b, image, tally=None, realized=None):
            seen.append((p, b))
            return image + 1.0

    PS.nb = nb
    for p in range(M):
        step = TV.mesh_pooled_step(_Mesh(p, M), PS())
        for k in range(-(-nb // M)):
            img = step(k, torch.zeros(2))
            assert float(img[0]) == (1.0 if k * M + p < nb else 0.0)
    assert sorted(b for _, b in seen) == list(range(nb))
    assert all(b % M == p for p, b in seen)


def test_a_batch_draws_the_serial_streams(monkeypatch):
    """PooledPass.batch(b) seeds its generators with ("photons", b) and
    ("si", b) of the CCD's seed, the serial loop's streams."""
    seeds = []
    monkeypatch.setattr(TPP, "_pooled_batch_step", lambda gen, si, *a: (
        seeds.append((gen.initial_seed(), si.initial_seed())), a[14])[1])
    ps = TPP.PooledPass(*([None] * 20))
    ps.seed = 4242 + 94
    ps.host = TPP.SceneHost(scene=None, flux=None, nominal_flux=None,
                            n_objects=0)
    img = torch.zeros(1)
    for b in (0, 3):
        assert ps.batch(b, img) is img
    assert seeds == [(stream_seed(4336, "photons", b),
                      stream_seed(4336, "si", b)) for b in (0, 3)]


def test_run_visit_sharded_keeps_the_flux_accounting(tmp_path):
    """__graft_entry__'s dryrun on 4 gloo ranks, {ccd: 2, phot: 2}: the
    ranks return the same (2, 64, 64) images; each CCD keeps 85-100% of
    its photons; what misses the 64 px window lands in a 256 px one."""
    res = torch_ranks.spawn("sharded", 4, tmp_path, n_phot_axis=2)
    small, big, n = res[0]
    for r in res[1:]:
        np.testing.assert_array_equal(r[0], small)
    assert small.shape == (2, 64, 64) and np.all(np.isfinite(small))
    expect = n * small.shape[0]
    total, landed_big = float(small.sum()), float(big.sum())
    ratios = small.reshape(2, -1).sum(axis=1) / n
    assert np.all((ratios > 0.85) & (ratios <= 1.0001)), ratios
    assert 0.9 * expect < total <= 1.0001 * expect
    clipped, lost = landed_big - total, expect - landed_big
    assert clipped >= 0
    assert abs(lost) / expect < 3e-3, (lost, expect)


def test_two_photon_ranks_with_the_silicon(two_ccds, tmp_path):
    """The silicon on (brighter-fatter sees the image of the previous
    outer step on each rank): R22_S11's central 256 x 256 window over 2
    phot ranks carries the charge of the one-rank pass within 2%."""
    over = overrides(two_ccds, tmp_path, "image.sensor.type=Silicon",
                     "image.nbatch=4", "image.nsubbatch=2")
    over = [o for o in over if o != "image.sensor.type=none"]
    res = torch_ranks.spawn("window_pass", 2, tmp_path, cfg=TEMPLATE,
                            overrides=over, det="R22_S11",
                            window=(256, 256), mesh_cfg={"phot": 2,
                                                         "ccd": 1})
    np.testing.assert_array_equal(res[0][0], res[1][0])
    from imsim_tpu_torch.config.interpreter import load_config

    ctx = TR.build_visit_context(load_config(TEMPLATE, over))
    prep = TR.prepare_ccd(ctx, "R22_S11", window=(256, 256), device="cpu")
    mesh = make_mesh(1, 1, "cpu")
    try:
        one, _, _ = TV.render_mesh_pass(ctx, prep, mesh, 0, {})
    finally:
        mesh.close()
    assert one.sum() > 1e4
    assert abs(res[0][0].sum() / float(one.sum()) - 1) < 0.02


def test_jax_mesh_visit_carries_the_same_charge(two_ccds, tmp_path):
    """{ccd: 2, phot: 2}: the JAX mesh on the 8 virtual CPU devices, the
    port on 4 gloo ranks; each CCD's render before the sky within 2%."""
    extra = ("output.mesh={ccd: 2, phot: 2}", "image.sky_level=0",
             "output.cosmic_ray_rate=0", "output.readout.enabled=false")
    jres = {r["det_name"]: float(np.asarray(r["eimage"]).sum())
            for r in JR.run_visit(TEMPLATE, overrides(
                two_ccds, tmp_path / "j", *extra))}
    res = torch_ranks.spawn("visit", 4, tmp_path, cfg=TEMPLATE,
                            overrides=overrides(two_ccds, tmp_path / "t",
                                                *extra))
    port = {det: float(v["image"].sum()) for r in res for det, v in r}
    assert sorted(port) == sorted(jres) == sorted(DETS)
    for det in DETS:
        assert jres[det] > 1e4
        assert abs(port[det] / jres[det] - 1) < 0.02, (det, port, jres)
