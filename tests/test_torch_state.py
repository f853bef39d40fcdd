"""State carried across from the JAX package (imsim_tpu_torch.convert):
the committed bench state equals a fresh export, loading it equals
converting the JAX containers directly, and synthetic_scene reproduces
bench.build_synthetic_host.

The exporter lives here, beside the JAX package it needs; the port only
reads its output.  Where JAX is installed,

    python tests/test_torch_state.py

rewrites imsim_tpu_torch/data/bench_r22_s11.npz."""
import ast
import os
import sys
from types import SimpleNamespace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from imsim_tpu.electronics.camera import PIXEL_SIZE_MM  # noqa: E402
from imsim_tpu.electronics.camera import get_camera  # noqa: E402
from imsim_tpu.electronics.readout import CcdReadout as JReadout  # noqa: E402
from imsim_tpu.image.photon_pooling import (PoolingConfig,  # noqa: E402
                                            classify_objects, make_psf_mtf)
from imsim_tpu.image.scene import DeviceScene as JScene  # noqa: E402
from imsim_tpu.image.scene import SceneHost as JHost  # noqa: E402
from imsim_tpu.image.vignetting import Vignetting  # noqa: E402
from imsim_tpu.optics.wcs_factory import make_wcs_factory  # noqa: E402
from imsim_tpu.photons import profiles as JP  # noqa: E402
from imsim_tpu.photons.optics_ops import make_optics_context  # noqa: E402
from imsim_tpu.psf.atmosphere import (AtmConfig, make_screens,  # noqa: E402
                                      second_kick_table, solve_r0_500)
from imsim_tpu.sensor.silicon import SiliconParams as JSilicon  # noqa: E402
from imsim_tpu.sensor.treerings import TreeRings  # noqa: E402
from imsim_tpu.utils.grid import coarse_shape  # noqa: E402
from imsim_tpu.utils.lookup import PolyCDF as JPoly  # noqa: E402
from imsim_tpu_torch import convert as CV  # noqa: E402
from imsim_tpu_torch.image import photon_pooling as TPP  # noqa: E402
from imsim_tpu_torch.image.scene import WL_CDF_K  # noqa: E402

torch.set_num_threads(1)

DEG = np.pi / 180

# bench.py main()'s CCD: R22_S11 at pointing (30, -20) deg, mjd 60674.2,
# r band, 1e5 objects, sky 17,500 photons / arcsec^2 (bench.py:348); the
# sky stage's vignetting on the stride-32 grid (config/runner.py)
_BENCH = dict(det_name="R22_S11", seed=0, n_obj=100_000,
              total_photons=1.0e8, n_bright=24, atm_seed=42 + 271828,
              fwhm=0.7, sky_level=17_500.0, vig_step=32)


def vignetting_grid(ccd, step: int) -> np.ndarray:
    """The coarse vignetting grid of config/runner._sky_noise_pieces, from
    the default imsim_tpu.image.vignetting.Vignetting."""
    nx, ny = ccd.bounds.width, ccd.bounds.height
    gh, gw = coarse_shape((ny, nx), step)
    ys = ((np.arange(gh) * step) - (ny - 1) / 2) * PIXEL_SIZE_MM \
        + ccd.center_mm[1]
    xs = ((np.arange(gw) * step) - (nx - 1) / 2) * PIXEL_SIZE_MM \
        + ccd.center_mm[0]
    return np.asarray(Vignetting()(np.hypot(xs[None, :], ys[:, None])),
                      np.float32)


def readout_arrays(ccd) -> dict:
    """convert._READOUT of the JAX package's CcdReadout for `ccd`."""
    ro = JReadout(ccd)
    return dict(vendor=np.array(ccd.vendor), gains=np.asarray(ro.gains),
                read_noises=np.asarray(ro.read_noises),
                bias_levels=np.asarray(ro.bias_levels),
                xtalk=np.asarray(ro.xtalk),
                full_well=np.float64(ro.full_well))


def export_ccd_state(path: str = CV.BENCH_STATE) -> dict:
    """Write bench.py main()'s per-CCD state for R22_S11 to `path` (the
    arrays `convert.load_ccd_state` reads).  Returns the arrays
    written."""
    B = _BENCH
    fac = make_wcs_factory(30 * DEG, -20 * DEG, mjd=60674.2, band="r")
    ccd = get_camera("LsstCamSim")[B["det_name"]]
    nx, ny = ccd.bounds.width, ccd.bounds.height
    wcs = fac.get_wcs(ccd)

    def field_angles(x, y):
        return fac.icrf_to_field(*wcs.xy_to_radec(x, y))

    cols, flux, _ = CV.bench_columns(B["seed"], B["n_obj"], B["total_photons"],
                                  B["n_bright"], nx, ny, field_angles)
    n_pad = int(2 ** np.ceil(np.log2(B["n_obj"])))

    def pad(a, fill=0.0):
        out = np.full(n_pad, fill, np.float32)
        out[:B["n_obj"]] = a
        return out

    wl = np.linspace(552.0, 691.0, WL_CDF_K).astype(np.float32)
    jscene = JScene.from_columns(
        **{k: pad(v, 1.0 if k in ("p1", "p2", "mu") else 0.0)
           for k, v in cols.items()},
        wl_icdf=np.broadcast_to(wl, (n_pad, WL_CDF_K)))
    jhost = JHost(scene=jscene, flux=flux, nominal_flux=flux,
                  n_objects=B["n_obj"])
    pcfg = PoolingConfig(fft_sb_thresh=2e5, fwhm=B["fwhm"], pixel_scale=0.2,
                         noise_var=17_500.0 * 0.04)
    modes = classify_objects(jhost, pcfg, make_psf_mtf(pcfg))

    octx = make_optics_context(fac, ccd)
    sil = JSilicon.make(treering_model=TreeRings().get(B["det_name"]))
    atm = AtmConfig(fwhm=B["fwhm"])
    sk_poly, _ = JPoly.fit(second_kick_table(atm, 622.0))
    screens = make_screens(B["atm_seed"], atm)
    airmass = 1.0 / max(np.sin(np.radians(atm.altitude_deg)), 0.1)
    r0_500 = solve_r0_500(atm.fwhm, atm.L0) * airmass ** (-3.0 / 5.0)
    exp_disk = JP.exp_disk_poly()

    jtel = fac.telescope.for_detector(B["det_name"])
    containers = dict(
        tel=(jtel, ("z0", "c", "kappa", "coefs", "aper", "shift", "rot",
                    "kinds")),
        ctx=(octx, CV._CTX_F32 + CV._CTX_F64 + ("det_nx", "det_ny")),
        sil=(sil, ("thickness_um", "pixel_um", "diffusion_um", "bf_kernel",
                   "treering_center", "tr_waves", "tr_env", "tr_active")),
        sk=(sk_poly, CV._POLY), exp=(exp_disk, CV._POLY),
        scr=(screens, ("weights", "winds", "size", "scale", "t0")))
    arrays = {f"{p}.{k}": np.asarray(getattr(obj, k))
              for p, (obj, keys) in containers.items() for k in keys}
    arrays.update({f"sersic.{k}": np.asarray(v)
                   for k, v in zip(CV._SERSIC, JP.sersic_poly2d())})
    arrays.update({f"ro.{k}": v for k, v in readout_arrays(ccd).items()})
    arrays.update({
        "scr.r0_500": np.float64(r0_500), "scr.L0": np.float64(atm.L0),
        "scr.kcrit": np.float64(atm.kcrit),
        "det_name": np.array(B["det_name"]), "nx": np.int32(nx),
        "ny": np.int32(ny), "scene.seed": np.int64(B["seed"]),
        "scene.total_photons": np.float64(B["total_photons"]),
        "scene.n_bright": np.int32(B["n_bright"]),
        "scene.thx": np.asarray(cols["x"], np.float32),
        "scene.thy": np.asarray(cols["y"], np.float32),
        "scene.modes": np.asarray(modes, np.int8),
        "sky.level": np.float64(B["sky_level"]),
        "sky.vig_step": np.int32(B["vig_step"]),
        "sky.vig": vignetting_grid(ccd, B["vig_step"])})
    np.savez_compressed(path, **arrays)
    return arrays


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
    fresh = export_ccd_state(str(tmp_path / "state.npz"))
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
        JSilicon.make(treering_model=TreeRings().get("R22_S11")))
    np.testing.assert_array_equal(st.silicon.bf_kernel, sil.bf_kernel)
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
    ro = CV.readout_from_numpy(SimpleNamespace(**readout_arrays(ccd)), "cpu")
    for k in ("gains", "read_noises", "bias_levels", "xtalk", "pcte",
              "scte"):
        assert torch.equal(getattr(st.readout, k), getattr(ro, k)), k
    assert (st.readout.vendor, st.readout.full_well) == ("E2V", 175_000.0)
    assert st.readout.xtalk.shape == (16, 16)
    assert st.sky_level == 17_500.0 and st.vig_step == 32
    np.testing.assert_array_equal(st.vig_coarse, vignetting_grid(ccd, 32))
    assert st.vig_coarse.shape == coarse_shape((st.ny, st.nx), 32)


def test_synthetic_scene_equals_build_synthetic_host(visit):
    fac, ccd = visit
    build = _bench_build_synthetic_host()
    n = 700
    jhost = build(fac, ccd, n_obj=n, total_photons=2e6, seed=3, n_bright=5)
    wcs = fac.get_wcs(ccd)
    st = CV.load_ccd_state(device="cpu")
    host = CV.synthetic_scene(
        st, "cpu", seed=3, n_obj=n, total_photons=2e6, n_bright=5,
        field_angles=lambda x, y: fac.icrf_to_field(*wcs.xy_to_radec(x, y)))
    np.testing.assert_array_equal(host.scene.params.numpy(),
                                  np.asarray(jhost.scene.params))
    np.testing.assert_array_equal(host.scene.wl_cheb.numpy(),
                                  np.asarray(jhost.scene.wl_cheb))
    np.testing.assert_array_equal(host.flux, jhost.flux)
    assert host.n_objects == jhost.n_objects
    # the pixel positions behind the field angles
    thx, thy = fac.icrf_to_field(*wcs.xy_to_radec(host.pix_x, host.pix_y))
    np.testing.assert_array_equal(host.scene.params[:n, 0].numpy(),
                                  np.asarray(thx, np.float32))
    np.testing.assert_array_equal(host.scene.params[:n, 1].numpy(),
                                  np.asarray(thy, np.float32))


def test_synthetic_scene_drops_fft_objects_from_the_pool():
    """The bench scene keeps every drawn flux; the port's own classifier
    at the bench's FFT settings reproduces the exported modes (17 FFT
    stars), and the pooled plan leaves those stars out."""
    st = CV.load_ccd_state(device="cpu")
    host = CV.synthetic_scene(st, "cpu")
    fft = st.modes == 0
    assert fft.sum() == 17 and (host.flux[fft] > 1e6).all()
    cfg = TPP.PoolingConfig(xsize=st.nx, ysize=st.ny, fft_sb_thresh=2e5,
                            fwhm=0.7, noise_var=st.sky_level * 0.04)
    modes = TPP.classify_objects(host, cfg, TPP.make_psf_mtf(cfg))
    np.testing.assert_array_equal(modes, st.modes)
    assert host.scene.params.shape == (131072, 10)
    # the bench: ~1e8 photons pooled (the FFT-mode bright stars excluded)
    _, total, _, _ = TPP.pooled_plan(host, modes, cfg)
    assert total == host.flux[~fft].astype(np.int64).sum() and 1.0e8 < total < 1.4e8
    np.testing.assert_array_equal(host.scene.params[:100_000, 0].numpy(),
                                  st.thx)
    assert host.pix_x.shape == (100_000,) and 0 <= host.pix_x.min() \
        and host.pix_x.max() < st.nx and host.pix_y.max() < st.ny
    with pytest.raises(ValueError):
        CV.synthetic_scene(st, "cpu", n_obj=10)


if __name__ == "__main__":
    export_ccd_state()
    print(f"wrote {CV.BENCH_STATE}")
