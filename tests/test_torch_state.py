"""State carried across from the JAX package (imsim_tpu_torch.convert):
the committed bench state equals a fresh export, loading it equals
converting the JAX containers directly, and synthetic_scene reproduces
bench.build_synthetic_host."""
import ast
import os

import numpy as np
import pytest
import torch

from imsim_tpu.electronics.camera import get_camera
from imsim_tpu.optics.wcs_factory import make_wcs_factory
from imsim_tpu.photons.optics_ops import make_optics_context
from imsim_tpu.psf.atmosphere import AtmConfig, second_kick_table
from imsim_tpu.sensor.silicon import SiliconParams as JSilicon
from imsim_tpu.sensor.treerings import TreeRings
from imsim_tpu.utils.lookup import PolyCDF as JPoly
from imsim_tpu_torch import convert as CV

torch.set_num_threads(1)

DEG = np.pi / 180
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def visit():
    fac = make_wcs_factory(30 * DEG, -20 * DEG, mjd=60674.2, band="r")
    ccd = get_camera("LsstCamSim")["R22_S11"]
    return fac, ccd


def _bench_build_synthetic_host():
    """bench.build_synthetic_host without importing bench.py (whose
    import reconfigures JAX's compilation cache)."""
    path = os.path.join(REPO, "bench.py")
    tree = ast.parse(open(path).read(), path)
    fn = [n for n in tree.body if isinstance(n, ast.FunctionDef)
          and n.name == "build_synthetic_host"]
    mod = ast.Module(body=fn, type_ignores=[])
    ns = {"np": np}
    exec(compile(mod, path, "exec"), ns)
    return ns["build_synthetic_host"]


def test_committed_state_equals_fresh_export(tmp_path):
    fresh = CV.export_ccd_state(str(tmp_path / "state.npz"))
    with np.load(CV.BENCH_STATE) as z:
        assert sorted(z.files) == sorted(fresh)
        for k in z.files:
            np.testing.assert_array_equal(z[k], fresh[k], err_msg=k)
    assert os.path.getsize(CV.BENCH_STATE) < 2 * 2**20


def test_load_equals_direct_conversion(visit):
    fac, ccd = visit
    st = CV.load_ccd_state(device="cpu")
    tel = CV.telescope_from_numpy(fac.telescope.for_detector("R22_S11"))
    assert (st.tel.surf == tel.surf).all() and st.tel.kinds == tel.kinds
    assert st.ctx == CV.optics_context_from_numpy(
        make_optics_context(fac, ccd))
    sil = CV.silicon_from_numpy(
        JSilicon.make(treering_model=TreeRings().get("R22_S11")), "cpu")
    assert torch.equal(st.silicon.bf_kernel, sil.bf_kernel)
    assert (st.silicon.tr_waves == sil.tr_waves).all()
    assert (st.silicon.tr_env == sil.tr_env).all()
    assert (st.silicon.treering_center, st.silicon.tr_active,
            st.silicon.thickness_um) == (sil.treering_center, sil.tr_active,
                                         sil.thickness_um)
    sk, _ = JPoly.fit(second_kick_table(AtmConfig(fwhm=0.7), 622.0))
    u = torch.linspace(0, 1, 1001)
    assert torch.equal(st.sk_table(u), CV.polycdf_from_numpy(sk)(u))
    assert (st.nx, st.ny) == (ccd.bounds.width, ccd.bounds.height)
    assert len(st.thx) == 100_000 and st.modes.dtype == np.int8
    assert st.screen_spec.n == 1024 and len(st.screen_spec.weights) == 6


def test_synthetic_scene_equals_build_synthetic_host(visit):
    fac, ccd = visit
    build = _bench_build_synthetic_host()
    n = 700
    jhost = build(fac, ccd, n_obj=n, total_photons=2e6, seed=3, n_bright=5)
    wcs = fac.get_wcs(ccd)
    st = CV.load_ccd_state(device="cpu")
    host = CV.synthetic_scene(
        st, "cpu", seed=3, n_obj=n, total_photons=2e6, n_bright=5,
        field_angles=lambda x, y: fac.icrf_to_field(*wcs.xy_to_radec(x, y)),
        modes=None)
    np.testing.assert_array_equal(host.scene.params.numpy(),
                                  np.asarray(jhost.scene.params))
    np.testing.assert_array_equal(host.scene.wl_cheb.numpy(),
                                  np.asarray(jhost.scene.wl_cheb))
    np.testing.assert_array_equal(host.flux, jhost.flux)
    assert host.n_objects == jhost.n_objects


def test_synthetic_scene_drops_fft_objects_from_the_pool():
    st = CV.load_ccd_state(device="cpu")
    host = CV.synthetic_scene(st, "cpu")
    fft = st.modes == 0
    assert fft.sum() > 0 and (host.flux[fft] == 0).all()
    assert (host.nominal_flux[fft] > 1e6).all()
    assert host.scene.params.shape == (131072, 10)
    # the bench: ~1e8 photons pooled (the FFT-mode bright stars excluded)
    assert 1.0e8 < host.flux.sum() < 1.4e8
    np.testing.assert_array_equal(host.scene.params[:100_000, 0].numpy(),
                                  st.thx)
    with pytest.raises(ValueError):
        CV.synthetic_scene(st, "cpu", n_obj=10)
