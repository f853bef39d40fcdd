"""A CCD's state built by the port from its pointing and detector
(imsim_tpu_torch.convert.build_ccd_state, no JAX) against the JAX
package: the bench arguments give the exported fixture's state
(`load_ccd_state`) at chip_smoke gate (n)'s bars, other detectors give
the state the JAX package's host code gives for them, and a small render
from the built ITL state matches the JAX package's render as
tests/test_torch_render.py holds whole renders."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imsim_tpu.electronics.camera import get_camera as jcamera
from imsim_tpu.image import photon_pooling as JPP
from imsim_tpu.image.scene import DeviceScene as JScene
from imsim_tpu.image.scene import SceneHost as JHost
from imsim_tpu.optics.loader import load_telescope
from imsim_tpu.optics.wcs_factory import make_wcs_factory
from imsim_tpu.photons import profiles as JP
from imsim_tpu.photons.optics_ops import make_optics_context
from imsim_tpu.psf.atmosphere import (AtmConfig, make_screens,
                                      second_kick_table, solve_r0_500)
from imsim_tpu.sensor.silicon import SiliconParams as JSilicon
from imsim_tpu.sensor.silicon import vendor_bf_kernel
from imsim_tpu.sensor.treerings import TreeRings
from imsim_tpu.utils.lookup import PolyCDF as JPoly
from imsim_tpu_torch import convert as CV
from imsim_tpu_torch.image import photon_pooling as TPP
from imsim_tpu_torch.image.scene import WL_CDF_K

from test_torch_state import _BENCH, readout_arrays, vignetting_grid

torch.set_num_threads(1)

DEG = np.pi / 180
BENCH = (30 * DEG, -20 * DEG, 60674.2)


def jax_state(det, camera, silicon, band="r", rotTelPos=0.0,
              perturbations=()):
    """export_ccd_state's steps for `det`, converted leaf by leaf
    with convert's *_from_numpy (the telescope at the detector's focal
    height, as config/runner.prepare_ccd places it; silicon 'runner'
    swaps in the vendor kernel as prepare_ccd does)."""
    B = _BENCH
    n_obj = B["n_obj"]
    fac = make_wcs_factory(*BENCH, band=band, telescope=load_telescope(
        band=band, perturbations=perturbations, rotTelPos=rotTelPos))
    ccd = jcamera(camera)[det]
    nx, ny = ccd.bounds.width, ccd.bounds.height
    wcs = fac.get_wcs(ccd)
    cols, flux, _ = CV.bench_columns(
        B["seed"], n_obj, B["total_photons"], B["n_bright"], nx, ny,
        lambda x, y: fac.icrf_to_field(*wcs.xy_to_radec(x, y)))
    n_pad = int(2 ** np.ceil(np.log2(n_obj)))

    def pad(k, a):
        out = np.full(n_pad, 1.0 if k in ("p1", "p2", "mu") else 0.0,
                      np.float32)
        out[:n_obj] = a
        return out

    wl = np.linspace(552.0, 691.0, WL_CDF_K).astype(np.float32)
    jscene = JScene.from_columns(**{k: pad(k, v) for k, v in cols.items()},
                                 wl_icdf=np.broadcast_to(wl, (n_pad,
                                                              WL_CDF_K)))
    jhost = JHost(scene=jscene, flux=flux, nominal_flux=flux,
                  n_objects=n_obj)
    pcfg = JPP.PoolingConfig(fft_sb_thresh=2e5, fwhm=B["fwhm"],
                             pixel_scale=0.2, noise_var=17_500.0 * 0.04)
    modes = JPP.classify_objects(jhost, pcfg, JPP.make_psf_mtf(pcfg))
    sil = JSilicon.make(treering_model=TreeRings().get(det))
    if silicon == "runner":
        sil = dataclasses.replace(sil, bf_kernel=jnp.asarray(
            vendor_bf_kernel(ccd.vendor, strength=0.4)))
    atm = AtmConfig(fwhm=B["fwhm"])
    sk, _ = JPoly.fit(second_kick_table(atm, 622.0))
    screens = make_screens(B["atm_seed"], atm)
    r0_500 = solve_r0_500(atm.fwhm, atm.L0)
    tel = fac.telescope.for_detector(det, ccd.height_mm * 1e-3)
    return CV.CcdState(
        det_name=det, nx=nx, ny=ny, tel=CV.telescope_from_numpy(tel),
        ctx=CV.optics_context_from_numpy(make_optics_context(fac, ccd)),
        silicon=CV.silicon_from_numpy(sil), sk_table=CV.polycdf_from_numpy(
            sk), screen_spec=CV.screen_spec_from_numpy(screens, r0_500,
                                                       atm.L0, atm.kcrit),
        profiles=CV.ProfileTables(
            sersic=CV.sersic_from_numpy(JP.sersic_poly2d()),
            exp_disk=CV.polycdf_from_numpy(JP.exp_disk_poly())),
        thx=np.asarray(cols["x"], np.float32),
        thy=np.asarray(cols["y"], np.float32),
        modes=np.asarray(modes, np.int8), seed=B["seed"],
        total_photons=B["total_photons"], n_bright=B["n_bright"],
        readout=CV.readout_from_numpy(SimpleNamespace(**readout_arrays(ccd)),
                                      "cpu"),
        sky_level=B["sky_level"], vig_coarse=vignetting_grid(ccd, 32),
        vig_step=32), fac, wcs


def test_bench_arguments_rebuild_the_exported_state():
    """Gate (n) on the CPU: every leaf bit-equal but the field angles,
    within 1 float32 ulp."""
    steps = {}
    st = CV.build_ccd_state("R22_S11", *BENCH, band="r", rotTelPos=0.0,
                            device="cpu", timings=steps)
    bad, ulp = CV.state_mismatches(st, CV.load_ccd_state(device="cpu"))
    assert not bad and ulp <= 1, bad
    assert set(steps) == {"wcs", "scene", "tables", "readout"}
    assert len(st.thx) == 100_000 and int((st.modes == 0).sum()) == 17
    # a mismatch is reported, not passed over
    other = dataclasses.replace(st, vig_step=16, thx=st.thx * 1.001)
    bad, _ = CV.state_mismatches(other, st)
    assert set(bad) == {"vig_step", "thx"}
    with pytest.raises(ValueError):
        CV.build_ccd_state("R22_S11", *BENCH, device="cpu", silicon="x")


@pytest.mark.parametrize("det, camera, silicon", [
    ("R10_S11", "LsstCamSim", "bench"),
    ("R10_S11", "LsstCamSim", "runner"),
    ("R00_SW0", "LsstCam", "runner"),
])
def test_built_state_equals_the_jax_state(det, camera, silicon):
    st = CV.build_ccd_state(det, *BENCH, camera=camera, device="cpu",
                            silicon=silicon)
    want, _, _ = jax_state(det, camera, silicon)
    bad, ulp = CV.state_mismatches(st, want)
    assert not bad and ulp <= 1, bad
    vendor = {"R10_S11": "ITL", "R00_SW0": "ITL_WF"}[det]
    assert st.readout.vendor == vendor
    assert (st.nx, st.ny) == ((4072, 4000) if det == "R10_S11"
                              else (4072, 2000))
    if silicon == "runner" and vendor == "ITL":
        # the measured kernel's x/y anisotropy, not the isotropic one
        k = st.silicon.bf_kernel
        assert k[4, 5] != k[5, 4]


def test_built_state_other_visit():
    """Another band, a rotator angle and an M2 perturbation: the built
    state equals the JAX package's there too."""
    pert = [{"M2": {"shift": [2e-4, -1e-4, 5e-5], "rotX": 3e-5}}]
    st = CV.build_ccd_state("R22_S11", *BENCH, band="g", rotTelPos=0.35,
                            perturbations=pert, device="cpu")
    want, _, _ = jax_state("R22_S11", "LsstCamSim", "bench", band="g",
                           rotTelPos=0.35, perturbations=pert)
    bad, ulp = CV.state_mismatches(st, want)
    assert not bad and ulp <= 1, bad
    assert st.ctx.srot != 0.0


def _centroid(img, x, y, r=7):
    ix, iy = int(round(x)), int(round(y))
    box = img[iy - r:iy + r + 1, ix - r:ix + r + 1].astype(np.float64)
    yy, xx = np.mgrid[iy - r:iy + r + 1, ix - r:ix + r + 1]
    w = box.sum()
    cx = (box * xx).sum() / w
    cy = (box * yy).sum() / w
    var = (box * ((xx - cx) ** 2 + (yy - cy) ** 2)).sum() / w / 2
    return cx, cy, np.sqrt(var / w)


def test_render_from_the_built_itl_state_matches_jax():
    """30 stars on a grid and 20 Sersic galaxies in the 512 x 512 corner
    of R10_S11: the port renders from its own built state (telescope,
    optics context, runner silicon, second kick, profiles; field angles
    through its own WCS), the JAX package from its own host code, both
    on the JAX package's screens (the packages draw different screen
    noise).  Held as tests/test_torch_render.py holds whole renders:
    total landed flux to 3 sigma + 0.5%, star centroids to 0.05 px + 3
    sigma."""
    det = "R10_S11"
    st = CV.build_ccd_state(det, *BENCH, device="cpu", silicon="runner")
    _, fac, wcs = jax_state(det, "LsstCamSim", "runner")
    rng = np.random.default_rng(17)
    gx, gy = np.meshgrid(np.arange(6) * 70 + 80, np.arange(5) * 70 + 90)
    xs = np.concatenate([gx.ravel() + rng.uniform(-0.5, 0.5, 30),
                         rng.uniform(60, 450, 20)])
    ys = np.concatenate([gy.ravel() + rng.uniform(-0.5, 0.5, 30),
                         rng.uniform(60, 450, 20)])
    n = len(xs)
    cols = dict(obj_type=np.r_[np.zeros(30), np.ones(20)],
                p0=rng.uniform(0.3, 0.8, n), p1=rng.uniform(0.8, 3.0, n),
                p2=rng.uniform(0.4, 1.0, n), p3=rng.uniform(0, np.pi, n),
                g1=np.zeros(n), g2=np.zeros(n), mu=np.ones(n))
    flux = np.r_[np.full(30, 12_000.0), np.full(20, 4_000.0)]
    n_pad = 64

    def pad(a, fill=0.0):
        out = np.full(n_pad, fill, np.float32)
        out[:n] = a
        return out

    def padded(thx, thy):
        return dict(x=pad(thx), y=pad(thy), **{
            k: pad(v, 1.0 if k in ("p1", "p2", "mu") else 0.0)
            for k, v in cols.items()})

    wl = np.broadcast_to(np.linspace(552.0, 691.0, 96).astype(np.float32),
                         (n_pad, 96))
    jthx, jthy = fac.icrf_to_field(*wcs.xy_to_radec(xs, ys))
    jhost = JHost(scene=JScene.from_columns(**padded(jthx, jthy),
                                            wl_icdf=wl),
                  flux=flux.copy(), nominal_flux=flux.copy(), n_objects=n)
    thx, thy = st.field_angles(xs, ys)
    np.testing.assert_allclose(thx, jthx, rtol=0, atol=1e-13)
    host = CV.host_from_numpy(SimpleNamespace(
        scene=SimpleNamespace(params=np.asarray(JScene.from_columns(
            **padded(thx, thy), wl_icdf=wl).params),
            wl_cheb=np.asarray(jhost.scene.wl_cheb)),
        flux=flux.copy(), nominal_flux=flux.copy(), n_objects=n), "cpu")
    atm = AtmConfig(fwhm=0.7)
    screens = make_screens(42 + 271828, atm)
    sk, _ = JPoly.fit(second_kick_table(atm, 622.0))
    ccd = jcamera("LsstCamSim")[det]
    sil = dataclasses.replace(
        JSilicon.make(treering_model=TreeRings().get(det)),
        bf_kernel=jnp.asarray(vendor_bf_kernel("ITL", strength=0.4)))
    kw = dict(xsize=512, ysize=512, nbatch=3, pupil_pairing=4,
              screen_share=4, nsub=4)
    jimg, _, _ = JPP.render_ccd_pooled(
        3, jhost, JPP.PoolingConfig(**kw), sil,
        fac.telescope.for_detector(det), make_optics_context(fac, ccd),
        screens, sk)
    jimg = np.asarray(jimg)
    tally = {}
    timg, _, _ = TPP.render_ccd_pooled(
        3, host, TPP.PoolingConfig(**kw), st.silicon, st.tel, st.ctx,
        CV.screens_from_numpy(screens, "cpu"), st.sk_table,
        profiles=st.profiles, tally=tally)
    timg = timg.numpy()
    assert timg.shape == jimg.shape and np.isfinite(timg).all()
    jt, tt = float(jimg.sum()), float(timg.sum())
    assert abs(jt - tt) <= 3 * np.sqrt(jt) + 0.005 * jt, (jt, tt)
    assert abs(tt - float(tally["in_frame"])) <= 1e-4 * tt
    for x, y in zip(xs[:30], ys[:30]):
        jx, jy, js = _centroid(jimg, x, y)
        tx, ty, ts = _centroid(timg, x, y)
        sig = np.hypot(js, ts)
        assert abs(jx - tx) <= 0.05 + 3 * sig, (x, y, jx, tx, sig)
        assert abs(jy - ty) <= 0.05 + 3 * sig, (x, y, jy, ty, sig)
