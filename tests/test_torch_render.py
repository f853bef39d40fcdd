"""The port's pooled full-physics render held against the JAX package's
(imsim_tpu_torch.image.photon_pooling.render_ccd_pooled vs
imsim_tpu.image.photon_pooling.render_ccd_pooled) on the same scene and
the same per-CCD state, plus the profile samplers it runs.

The two packages draw from different random streams, so the images are
compared statistically; each tolerance is stated with its reason."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imsim_tpu.electronics.camera import get_camera
from imsim_tpu.image import photon_pooling as JPP
from imsim_tpu.image.scene import DeviceScene as JScene
from imsim_tpu.image.scene import SceneHost as JHost
from imsim_tpu.optics.wcs_factory import make_wcs_factory
from imsim_tpu.photons import profiles as JP
from imsim_tpu.photons.optics_ops import make_optics_context
from imsim_tpu.psf.atmosphere import (AtmConfig, make_screens,
                                      second_kick_table)
from imsim_tpu.sensor.silicon import SiliconParams as JSilicon
from imsim_tpu.sensor.treerings import TreeRings
from imsim_tpu.utils.lookup import PolyCDF as JPoly
from imsim_tpu_torch import convert as CV
from imsim_tpu_torch.image import photon_pooling as TPP
from imsim_tpu_torch.photons import profiles as TP
from imsim_tpu_torch.photons.profiles import ProfileTables

torch.set_num_threads(1)

DEG = np.pi / 180


@pytest.fixture(scope="module")
def corner_scene():
    """30 stars on a 60-px grid (the centroid probes) + 20 Sersic
    galaxies, inside the 512 x 512 corner of R22_S11, with the bench
    visit's per-CCD state built by the JAX package."""
    fac = make_wcs_factory(30 * DEG, -20 * DEG, mjd=60674.2, band="r")
    ccd = get_camera("LsstCamSim")["R22_S11"]
    wcs = fac.get_wcs(ccd)
    rng = np.random.default_rng(17)
    gx, gy = np.meshgrid(np.arange(6) * 70 + 80, np.arange(5) * 70 + 90)
    xs = np.concatenate([gx.ravel() + rng.uniform(-0.5, 0.5, 30),
                         rng.uniform(60, 450, 20)])
    ys = np.concatenate([gy.ravel() + rng.uniform(-0.5, 0.5, 30),
                         rng.uniform(60, 450, 20)])
    n = len(xs)
    thx, thy = fac.icrf_to_field(*wcs.xy_to_radec(xs, ys))
    obj_type = np.r_[np.zeros(30), np.ones(20)].astype(np.float32)
    flux = np.r_[np.full(30, 12_000.0), np.full(20, 4_000.0)]
    n_pad = 64

    def pad(a, fill=0.0):
        out = np.full(n_pad, fill, np.float32)
        out[:n] = a
        return out

    wl = np.linspace(552.0, 691.0, 96).astype(np.float32)
    scene = JScene.from_columns(
        x=pad(thx), y=pad(thy), obj_type=pad(obj_type),
        p0=pad(rng.uniform(0.3, 0.8, n)), p1=pad(rng.uniform(0.8, 3.0, n),
                                                 1.0),
        p2=pad(rng.uniform(0.4, 1.0, n), 1.0),
        p3=pad(rng.uniform(0, np.pi, n)), g1=pad(np.zeros(n)),
        g2=pad(np.zeros(n)), mu=pad(np.ones(n), 1.0),
        wl_icdf=np.broadcast_to(wl, (n_pad, 96)))
    jhost = JHost(scene=scene, flux=flux.copy(), nominal_flux=flux.copy(),
                  n_objects=n)
    atm = AtmConfig(fwhm=0.7)
    sk_poly, _ = JPoly.fit(second_kick_table(atm, 622.0))
    return dict(
        fac=fac, jhost=jhost, xs=xs, ys=ys,
        tel=fac.telescope.for_detector("R22_S11"),
        octx=make_optics_context(fac, ccd),
        sil=JSilicon.make(treering_model=TreeRings().get("R22_S11")),
        screens=make_screens(42 + 271828, atm), sk=sk_poly)


def _centroid(img, x, y, r=7):
    ix, iy = int(round(x)), int(round(y))
    box = img[iy - r:iy + r + 1, ix - r:ix + r + 1].astype(np.float64)
    yy, xx = np.mgrid[iy - r:iy + r + 1, ix - r:ix + r + 1]
    w = box.sum()
    cx = (box * xx).sum() / w
    cy = (box * yy).sum() / w
    # centroid standard error: second moment over the photon count
    var = (box * ((xx - cx) ** 2 + (yy - cy) ** 2)).sum() / w / 2
    return cx, cy, np.sqrt(var / w)


def test_render_ccd_pooled_matches_jax(corner_scene):
    s = corner_scene
    kw = dict(xsize=512, ysize=512, nbatch=3, pupil_pairing=4,
              screen_share=4, nsub=4)
    jimg, _, _ = JPP.render_ccd_pooled(
        3, s["jhost"], JPP.PoolingConfig(**kw), s["sil"], s["tel"],
        s["octx"], s["screens"], s["sk"])
    jimg = np.asarray(jimg)

    dev = "cpu"
    host = CV.host_from_numpy(s["jhost"], dev)
    profiles = ProfileTables(
        sersic=CV.sersic_from_numpy(JP.sersic_poly2d()),
        exp_disk=CV.polycdf_from_numpy(JP.exp_disk_poly()))
    tally = {}
    timg, _, _ = TPP.render_ccd_pooled(
        3, host, TPP.PoolingConfig(**kw),
        CV.silicon_from_numpy(s["sil"]),
        CV.telescope_from_numpy(s["tel"]),
        CV.optics_context_from_numpy(s["octx"]),
        CV.screens_from_numpy(s["screens"], dev),
        CV.polycdf_from_numpy(s["sk"]), profiles=profiles, tally=tally)
    timg = timg.numpy()
    assert timg.shape == jimg.shape and np.isfinite(timg).all()

    # total landed flux: the photon counts per object are identical, so
    # the totals differ only by which photons land (edge losses,
    # vignetting, silicon depth): Poisson-scale, 3 sigma, plus 0.5% for
    # the first-order BF/tree-ring redistribution at the frame edge
    jt, tt = float(jimg.sum()), float(timg.sum())
    assert abs(jt - tt) <= 3 * np.sqrt(jt) + 0.005 * jt, (jt, tt)
    # the port's charge bookkeeping: image sum == in-frame flux binned
    assert abs(tt - float(tally["in_frame"])) <= 1e-4 * tt

    # bright-star centroids: 12k photons each; statistical error of each
    # centroid ~0.01-0.02 px; 0.05 px of systematic allowance (f32
    # field-angle rounding, chain rounding) + 3 sigma of the difference
    for x, y in zip(s["xs"][:30], s["ys"][:30]):
        jx, jy, js = _centroid(jimg, x, y)
        tx, ty, ts = _centroid(timg, x, y)
        sig = np.hypot(js, ts)
        assert abs(jx - tx) <= 0.05 + 3 * sig, (x, y, jx, tx, sig)
        assert abs(jy - ty) <= 0.05 + 3 * sig, (x, y, jy, ty, sig)


def test_fft_branch_is_refused():
    """The FFT branch runs where it used to be refused: on the bench
    scene the port's classifier at the bench's FFT settings sends the 17
    bright stars to it, and force_fft sends every non-faint object.  A
    force_fft config without the PSF MTF (fft_sb_thresh 0) is still
    refused by the pass, which has no PSF to render with."""
    st = CV.load_ccd_state(device="cpu")
    host = CV.synthetic_scene(st, "cpu")
    cfg = TPP.PoolingConfig(xsize=st.nx, ysize=st.ny, fft_sb_thresh=2e5,
                            fwhm=0.7, noise_var=st.sky_level * 0.04)
    modes = TPP.classify_objects(host, cfg, TPP.make_psf_mtf(cfg))
    assert (modes == TPP.FFT).sum() == 17
    forced = TPP.PoolingConfig(force_fft=True)
    modes = TPP.classify_objects(host, forced)
    assert ((modes == TPP.FFT) == (host.flux[:host.n_objects]
                                   >= forced.faint_thresh)).all()
    with pytest.raises(ValueError, match="fft_sb_thresh"):
        TPP._fft_pass(torch.zeros((16, 16)), host, modes, forced, None, 0)


def test_render_ccd_pooled_fft_branch_matches_jax(corner_scene, monkeypatch):
    """The whole slice on the corner scene with three grid stars at 4e6
    photons and two galaxies at 3e7 (FFT mode, with spikes) and the
    rest pooled, per-object realized flux tracked.  The FFT part is held
    to the JAX package's noiseless part (poisson_approx -> identity in
    both): the pass's added charge and the FFT objects' realized flux to
    1e-5; the pooled part statistically, as
    test_render_ccd_pooled_matches_jax (image minus the FFT field: total
    flux, the other grid stars' centroids), and its realized flux per
    object within 5 sqrt(flux) + 1% (vignetting differs by photon)."""
    import imsim_tpu.utils.rng as JR
    from imsim_tpu.image.diffraction_fft import spike_kernel as j_kernel
    from imsim_tpu_torch.utils import rng as TR

    monkeypatch.setattr(JR, "poisson_approx", lambda key, lam: lam)
    monkeypatch.setattr(TR, "poisson_approx", lambda gen, lam: lam)
    monkeypatch.setattr(TPP, "poisson_approx", lambda gen, lam: lam)
    s = corner_scene
    flux = s["jhost"].flux.copy()
    flux[:3] = 4e6
    flux[30:32] = 3e7
    jhost = JHost(scene=s["jhost"].scene, flux=flux, nominal_flux=flux,
                  n_objects=s["jhost"].n_objects, pix_x=s["xs"],
                  pix_y=s["ys"])
    kw = dict(xsize=512, ysize=512, nbatch=3, pupil_pairing=4,
              screen_share=4, nsub=4, fft_sb_thresh=2e5, fwhm=0.7)
    sp = dict(kernel=j_kernel(622.0, 0.2, 45.0, 0.1, n=65,
                              spike_flux_fraction=0.02, profile_power=1.1,
                              r_scale_px=3.0), sat=1e5)
    jcfg = JPP.PoolingConfig(**kw)
    jimg, jmodes, jreal = JPP.render_ccd_pooled(
        3, jhost, jcfg, s["sil"], s["tel"], s["octx"], s["screens"], s["sk"],
        spikes=sp, track_realized=True)
    jfft, _ = JPP._fft_pass(jnp.zeros((512, 512)), jhost, jmodes, jcfg,
                            JPP.make_psf_mtf(jcfg), 3, spikes=sp)
    jimg, jfft = np.asarray(jimg, np.float64), np.asarray(jfft, np.float64)

    host = CV.host_from_numpy(jhost, "cpu")
    host.pix_x, host.pix_y = s["xs"], s["ys"]
    profiles = ProfileTables(
        sersic=CV.sersic_from_numpy(JP.sersic_poly2d()),
        exp_disk=CV.polycdf_from_numpy(JP.exp_disk_poly()))
    tally = {}
    timg, modes, treal = TPP.render_ccd_pooled(
        3, host, TPP.PoolingConfig(**kw), CV.silicon_from_numpy(s["sil"]),
        CV.telescope_from_numpy(s["tel"]),
        CV.optics_context_from_numpy(s["octx"]),
        CV.screens_from_numpy(s["screens"], "cpu"),
        CV.polycdf_from_numpy(s["sk"]), profiles=profiles, spikes=sp,
        track_realized=True, tally=tally)
    np.testing.assert_array_equal(modes, jmodes)
    fft = np.nonzero(modes == TPP.FFT)[0]
    assert list(fft) == [0, 1, 2, 30, 31]
    # the FFT part, noiseless
    assert float(tally["fft"]) == pytest.approx(jfft.sum(), rel=1e-5)
    np.testing.assert_allclose(treal[fft], jreal[fft], rtol=1e-5)
    # the pooled part: charge accounting, total and centroids
    tpool = timg.numpy().astype(np.float64) - jfft
    jpool = jimg - jfft
    tt, jt = tpool.sum(), jpool.sum()
    assert abs(tt - float(tally["in_frame"])) <= 1e-4 * tt + 1.0
    assert abs(jt - tt) <= 3 * np.sqrt(jt) + 0.005 * jt, (jt, tt)
    for x, y in zip(s["xs"][3:30], s["ys"][3:30]):
        jx, jy, js = _centroid(jpool, x, y)
        tx, ty, ts = _centroid(tpool, x, y)
        sig = np.hypot(js, ts)
        assert abs(jx - tx) <= 0.05 + 3 * sig, (x, y, jx, tx, sig)
        assert abs(jy - ty) <= 0.05 + 3 * sig, (x, y, jy, ty, sig)
    pooled = np.nonzero(modes != TPP.FFT)[0]
    np.testing.assert_array_less(
        np.abs(treal[pooled] - jreal[pooled]),
        5 * np.sqrt(flux[pooled]) + 0.01 * flux[pooled] + 1)
    assert treal[s["jhost"].n_objects:].sum() == 0


def test_profile_samplers_match_jax():
    """Sersic 2-D Chebyshev inverse CDF, the exponential-disk and
    second-kick PolyCDFs, ellipse and lensing maps: same inputs, f32
    evaluation in both packages (relative 1e-5 on the radius, whose
    Clenshaw sums run over ~30 terms)."""
    rng = np.random.default_rng(4)
    u = rng.uniform(0, 1, 4096).astype(np.float32)
    n_s = rng.uniform(0.3, 6.2, 4096).astype(np.float32)
    want = np.asarray(JP.sample_sersic_poly(jnp.asarray(u), jnp.asarray(n_s)))
    got = TP.sample_sersic_poly(torch.as_tensor(u), torch.as_tensor(n_s),
                                CV.sersic_from_numpy(JP.sersic_poly2d()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)

    sk, _ = JPoly.fit(second_kick_table(AtmConfig(fwhm=0.7), 622.0))
    for jpoly in (JP.exp_disk_poly(), sk):
        want = np.asarray(jpoly(jnp.asarray(u)))
        got = CV.polycdf_from_numpy(jpoly)(torch.as_tensor(u)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    dx, dy, q, b, g1, g2, mu = (rng.normal(size=4096).astype(np.float32)
                                for _ in range(7))
    q = np.abs(q) % 1 + 0.1
    g1, g2, mu = 0.05 * g1, 0.05 * g2, 1 + 0.05 * mu
    T = lambda a: torch.as_tensor(a)  # noqa: E731
    for want, got in zip(
            JP.apply_ellipse(*map(jnp.asarray, (dx, dy, q, b))) +
            JP.apply_shear_mag(*map(jnp.asarray, (dx, dy, g1, g2, mu))),
            TP.apply_ellipse(*map(T, (dx, dy, q, b))) +
            TP.apply_shear_mag(*map(T, (dx, dy, g1, g2, mu)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_sample_intrinsic_knot_lcg_matches_uint32():
    """The knot LCG runs in int64 with & 0xFFFFFFFF: equal to uint32
    wraparound arithmetic."""
    from imsim_tpu_torch.image.render import _lcg

    rng = np.random.default_rng(2)
    obj = rng.integers(0, 2**31 - 1, 1000, dtype=np.int64)
    pick = rng.integers(0, 64, 1000, dtype=np.int64)
    seed32 = (obj.astype(np.uint32) * np.uint32(2654435761)
              + pick.astype(np.uint32) * np.uint32(40503))
    u1 = seed32 * np.uint32(1664525) + np.uint32(1013904223)
    seed64 = (torch.as_tensor(obj) * 2654435761
              + torch.as_tensor(pick) * 40503) & 0xFFFFFFFF
    assert (_lcg(seed64).numpy() == u1.astype(np.int64)).all()


def test_lookup_evaluators_match_jax():
    """UniformTable and the per-row / per-column Clenshaw evaluators."""
    from imsim_tpu.utils.lookup import UniformTable as JTable
    from imsim_tpu.utils.lookup import clenshaw_cols as j_cols
    from imsim_tpu.utils.lookup import clenshaw_rows as j_rows
    from imsim_tpu_torch.utils.lookup import (UniformTable, clenshaw_cols,
                                              clenshaw_rows)

    rng = np.random.default_rng(8)
    y = rng.uniform(0, 5, 300).astype(np.float32)
    x = rng.uniform(-1, 12, 5000).astype(np.float32)
    want = np.asarray(JTable(0.5, 0.03, jnp.asarray(y))(jnp.asarray(x)))
    got = UniformTable(0.5, 0.03, torch.as_tensor(y))(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    c = rng.normal(size=(5000, 14)).astype(np.float32)
    u = rng.uniform(-1, 1, 5000).astype(np.float32)
    np.testing.assert_allclose(
        clenshaw_rows(torch.as_tensor(c), torch.as_tensor(u)).numpy(),
        np.asarray(j_rows(jnp.asarray(c), jnp.asarray(u))), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_allclose(
        clenshaw_cols(torch.as_tensor(c.T.copy()), torch.as_tensor(u)).numpy(),
        np.asarray(j_cols(jnp.asarray(c.T), jnp.asarray(u))), rtol=1e-5,
        atol=1e-5)


def test_ideal_sensor_render_and_unported_families(corner_scene):
    """Without silicon the pooled pass bins into the ideal sensor (charge
    accounted exactly).  The families and the path that used to be
    refused now render: a streak object on the optics path, and the
    analytic PSF when tel and ctx are left out."""
    s = corner_scene
    host = CV.host_from_numpy(s["jhost"], "cpu")
    profiles = ProfileTables(
        sersic=CV.sersic_from_numpy(JP.sersic_poly2d()),
        exp_disk=CV.polycdf_from_numpy(JP.exp_disk_poly()))
    cfg = TPP.PoolingConfig(xsize=512, ysize=512, nbatch=2)
    args = (None, CV.telescope_from_numpy(s["tel"]),
            CV.optics_context_from_numpy(s["octx"]),
            CV.screens_from_numpy(s["screens"], "cpu"),
            CV.polycdf_from_numpy(s["sk"]))
    tally = {}
    img, modes, realized = TPP.render_ccd_pooled(
        5, host, cfg, *args, profiles=profiles, tally=tally)
    assert realized.shape == (host.scene.n,) and not realized.any()
    assert float(img.sum()) == pytest.approx(float(tally["in_frame"]),
                                             rel=1e-6)
    assert float(tally["in_frame"]) > 0.9 * host.flux.sum()
    assert (modes == TPP.PHOT).all()
    host.scene.params[3, 2] = 3.0      # a streak, 2 x 1 arcsec
    host.scene.params[3, 3:6] = torch.tensor([2.0, 1.0, 0.3])
    tally = {}
    img = TPP.render_ccd_pooled(5, host, cfg, *args, profiles=profiles,
                                tally=tally)[0]
    assert float(img.sum()) == pytest.approx(float(tally["in_frame"]),
                                             rel=1e-6)
    # the analytic path reads COL_X/COL_Y as pixels: here field angles,
    # so the photons land at the frame's origin corner: all but the
    # profiles' far tails within 128 px
    tally = {}
    img = TPP.render_ccd_pooled(5, host, cfg, profiles=profiles,
                                tally=tally)[0]
    assert float(tally["in_frame"]) > 0
    assert float(img[:128, :128].sum()) >= 0.999 * float(img.sum())
