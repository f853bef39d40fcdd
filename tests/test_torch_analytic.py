"""The port's analytic-PSF path against the JAX package: the host PSF
tables, the per-object table gathers, every object family of
sample_intrinsic, render.shoot, the analytic pooled CCD
(render_ccd_pooled without optics) and the unpooled render_ccd.

Deterministic stages get the JAX package's own draws (its key splits
reproduced here) and are held to 1e-6 relative; whole renders draw from
different streams and are compared statistically.  Each tolerance is
stated with its reason."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imsim_tpu.image import photon_pooling as JPP
from imsim_tpu.image import render as JR
from imsim_tpu.image.scene import DeviceScene as JScene
from imsim_tpu.image.scene import SceneHost as JHost
from imsim_tpu.image.scene import make_photon_batches as j_batches
from imsim_tpu.photons import profiles as JP
from imsim_tpu.sensor.silicon import SiliconParams as JSilicon
from imsim_tpu.sensor.treerings import TreeRings
from imsim_tpu_torch import convert as CV
from imsim_tpu_torch.image import photon_pooling as TPP
from imsim_tpu_torch.image import render as TR
from imsim_tpu_torch.image.scene import DeviceScene as TScene
from imsim_tpu_torch.image.scene import make_photon_batches as t_batches
from imsim_tpu_torch.photons import profiles as TP
from imsim_tpu_torch.photons.profiles import ProfileTables

torch.set_num_threads(1)

POINT, SERSIC, KNOTS, STREAK, FITS = 0, 1, 2, 3, 4


@pytest.fixture(scope="module")
def profiles():
    return ProfileTables(sersic=CV.sersic_from_numpy(JP.sersic_poly2d()),
                         exp_disk=CV.polycdf_from_numpy(JP.exp_disk_poly()))


def _same_table(a, b):
    assert (a.x0, a.dx) == (b.x0, b.dx)
    np.testing.assert_array_equal(np.asarray(a.y), np.asarray(b.y))


def test_psf_tables_bit_equal():
    """The Kolmogorov table and the DoubleGaussianPSF table of the
    runner (config/runner.py:657-686, both its parametrizations) are
    copies of the same numpy/scipy code: bit-equal."""
    _same_table(JP.kolmogorov_cdf(), TP.kolmogorov_cdf())
    _same_table(JP.kolmogorov_cdf(512), TP.kolmogorov_cdf(512))
    for fwhm in (None, 0.8):
        if fwhm is None:
            f1, f2, w1 = 0.6, 1.2, 0.8
        else:
            alpha = fwhm / 2.3835
            s1 = np.sqrt(max(alpha ** 2 - 0.2 ** 2 / 12.0, 1e-8))
            s2 = np.sqrt(max(4 * alpha ** 2 - 0.2 ** 2 / 12.0, 1e-8))
            w1 = 1.0 / 1.1
            f1, f2 = 2.3548200450309493 * s1, 2.3548200450309493 * s2
        s1, s2 = f1 / 2.3548200450309493, f2 / 2.3548200450309493

        def T(k):
            return (w1 * np.exp(-0.5 * (s1 * k) ** 2)
                    + (1 - w1) * np.exp(-0.5 * (s2 * k) ** 2))

        _same_table(JP.radial_cdf_from_mtf(T, r_max=8 * f2, k_max=40.0 / f1),
                    TP.radial_cdf_from_mtf(T, r_max=8 * f2, k_max=40.0 / f1))
    k = np.linspace(1e-8, 50, 777)
    r = np.linspace(1e-6, 10, 300)
    T = np.exp(-0.3 * k)
    np.testing.assert_array_equal(JP._enclosed_flux_from_mtf(T, k, r),
                                  TP._enclosed_flux_from_mtf(T, k, r))


def test_analytic_psf_tables_follow_the_config():
    """The analytic PSF: the Kolmogorov table scaled to fwhm, or the
    given table (cfg.psf_table in render_ccd_pooled); the Gaussian sigma
    from gauss_fwhm."""
    tabs = TPP.analytic_psf_tables(0.7, 0.3, "cpu")
    kol = JP.kolmogorov_cdf()
    np.testing.assert_array_equal(tabs["kolmogorov"].y.numpy(), kol.y * 0.7)
    assert tabs["gauss_sigma"] == 0.3 / 2.3548200450309493
    tab = TP.radial_cdf_from_mtf(lambda k: np.exp(-0.5 * (0.3 * k) ** 2),
                                 r_max=4.0)
    tabs = TPP.analytic_psf_tables(0.7, 0.3, "cpu", tab)
    np.testing.assert_array_equal(tabs["kolmogorov"].y.numpy(), tab.y)


def test_scene_from_columns_matches_jax():
    """labs_icdf from the port's absorption table, wl_cheb and the
    packed params equal the JAX package's DeviceScene.from_columns."""
    rng = np.random.default_rng(1)
    n = 40
    cols = {k: rng.uniform(0, 1, n).astype(np.float32)
            for k in ("x", "y", "obj_type", "p0", "p1", "p2", "p3", "g1",
                      "g2", "mu")}
    wl = np.sort(rng.uniform(320, 1080, (n, 96)), axis=1).astype(np.float32)
    cloud = rng.normal(size=(3, 1024, 2)).astype(np.float32)
    j = JScene.from_columns(**cols, wl_icdf=wl, aux_cloud=cloud)
    t = TScene.from_columns(**cols, wl_icdf=wl, aux_cloud=cloud,
                            device="cpu")
    for name in ("params", "wl_icdf", "labs_icdf", "wl_cheb", "aux_cloud"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), name)
    t2 = CV.scene_from_numpy(j, "cpu")
    np.testing.assert_array_equal(t2.labs_icdf.numpy(),
                                  np.asarray(j.labs_icdf))


def test_make_photon_batches_matches_jax():
    flux = np.array([3.0, 0.0, 7.0, 2.0, 0.0, 0.0, 0.0, 0.0])
    scene = JScene.from_columns(*[np.zeros(8, np.float32)] * 10,
                                wl_icdf=np.full((8, 96), 600.0, np.float32))
    jh = JHost(scene=scene, flux=flux, nominal_flux=flux, n_objects=4)
    th = CV.host_from_numpy(jh, "cpu")
    for mb in (None, 1):
        want = list(j_batches(jh, 5, mb))
        got = list(t_batches(th, 5, mb))
        assert len(got) == len(want)
        for (ti, tw), (ji, jw) in zip(got, want):
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_interp_rows_match_jax():
    """The pair and quad row gathers: the same f32 arithmetic, 1e-6
    relative."""
    rng = np.random.default_rng(2)
    ta = np.sort(rng.uniform(300, 1100, (50, 96)), axis=1).astype(np.float32)
    tb = rng.uniform(0, 400, (50, 96)).astype(np.float32)
    rows = rng.integers(0, 50, 20_000).astype(np.int32)
    u = rng.uniform(0, 1, 20_000).astype(np.float32)
    u[:3] = (0.0, 1.0 - 2 ** -24, 0.5)
    want = np.asarray(JR._interp_rows(jnp.asarray(ta), jnp.asarray(rows),
                                      jnp.asarray(u)))
    T = torch.as_tensor
    got = TR._interp_rows(T(ta), T(rows), T(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    wa, wb = JR._interp_rows2(*map(jnp.asarray, (ta, tb, rows, u)))
    ga, gb = TR._interp_rows2(*map(T, (ta, tb, rows, u)))
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=1e-6)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-6,
                               atol=1e-6 * tb.max())


def _jax_intrinsic_draws(key, n):
    """sample_intrinsic's draws as the JAX package makes them."""
    k_srs, k_pick, k_box = jax.random.split(key, 3)
    ku, kt = jax.random.split(k_srs)
    ub = np.asarray(jax.random.uniform(k_box, (n, 2)))
    return dict(u_r=np.array(jax.random.uniform(ku, (n,))),
                theta=np.array(jax.random.uniform(kt, (n,), jnp.float32,
                                                  0.0, 2 * jnp.pi)),
                pick=np.array(jax.random.uniform(k_pick, (n,))),
                box_x=ub[:, 0].copy(), box_y=ub[:, 1].copy())


def _family_scene(types, rng, n_obj=64):
    """n_obj objects of the given types at pixel positions, with
    lensing, and three FITS point clouds (COL_P2 of a FITS object is
    its cloud index)."""
    t = np.resize(np.asarray(types, np.float32), n_obj)
    p2 = rng.uniform(0.3, 1.0, n_obj)
    p2[t == FITS] = rng.integers(1, 3, int((t == FITS).sum()))
    p1 = rng.uniform(0.5, 4.0, n_obj)
    p1[t == KNOTS] = 25.0
    p0 = rng.uniform(0.2, 1.5, n_obj)
    p0[t == STREAK] = rng.uniform(5, 40, int((t == STREAK).sum()))
    cols = dict(x=rng.uniform(50, 450, n_obj), y=rng.uniform(50, 450, n_obj),
                obj_type=t, p0=p0, p1=p1, p2=p2,
                p3=rng.uniform(0, np.pi, n_obj),
                g1=rng.normal(0, 0.03, n_obj), g2=rng.normal(0, 0.03, n_obj),
                mu=1 + rng.normal(0, 0.03, n_obj))
    cols = {k: np.asarray(v, np.float32) for k, v in cols.items()}
    wl = np.sort(rng.uniform(500, 700, (n_obj, 96)), axis=1).astype(
        np.float32)
    cloud = np.concatenate([np.zeros((1, 1024, 2)),
                            rng.normal(0, 0.8, (2, 1024, 2))]).astype(
        np.float32)
    return (JScene.from_columns(**cols, wl_icdf=wl, aux_cloud=cloud),
            TScene.from_columns(**cols, wl_icdf=wl, aux_cloud=cloud,
                                device="cpu"))


@pytest.mark.parametrize("types,rel", [
    ((STREAK,), 1e-6), ((FITS,), 1e-6), ((POINT, STREAK, FITS), 1e-6),
    # the Sersic and exponential-disk inverse CDFs are ~30-term Clenshaw
    # sums evaluated in f32 by both packages (test_torch_render's 1e-5)
    ((POINT, SERSIC, KNOTS, STREAK, FITS), 1e-5)])
def test_sample_intrinsic_families_match_jax(profiles, types, rel):
    """Every family's branch with the JAX package's draws injected:
    offsets in pixels (pixel_scale 0.2), against max |offset|."""
    rng = np.random.default_rng(5)
    js, ts = _family_scene(types, rng)
    n = 30_000
    obj = rng.integers(0, 64, n).astype(np.int32)
    key = jax.random.PRNGKey(11)
    fam = tuple(sorted(set(types)))
    want = JR.sample_intrinsic(key, js.params[jnp.asarray(obj)].T,
                               jnp.asarray(obj), 0.2, aux_cloud=js.aux_cloud,
                               families=fam)
    d = {k: torch.as_tensor(v) for k, v in
         _jax_intrinsic_draws(key, n).items()}
    obj_t = torch.as_tensor(obj)
    got = TR.sample_intrinsic(None, ts.params[obj_t.long()].T, obj_t,
                              profiles, fam, 0.2, ts.aux_cloud, d)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    assert scale > 1.0
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= rel * scale


def _jax_shoot_draws(key, n):
    keys = jax.random.split(key, 6)
    ku, kt = jax.random.split(keys[1])
    xy = np.asarray(jax.random.normal(keys[2], (n, 2)))
    u12 = np.asarray(jax.random.uniform(keys[4], (2, n)))
    d = dict(psf_u=jax.random.uniform(ku, (n,)),
             psf_theta=jax.random.uniform(kt, (n,), jnp.float32, 0.0,
                                          2 * jnp.pi),
             gauss_x=xy[:, 0].copy(), gauss_y=xy[:, 1].copy(),
             wl_u=jax.random.uniform(keys[3], (n,)), pupil_u1=u12[0],
             pupil_u2=u12[1], time_u=jax.random.uniform(keys[5], (n,)))
    d = {k: torch.as_tensor(np.array(v)) for k, v in d.items()}
    d["intrinsic"] = {k: torch.as_tensor(v) for k, v in
                      _jax_intrinsic_draws(keys[0], n).items()}
    return d


def test_shoot_matches_jax(profiles):
    """render.shoot with the JAX package's draws: positions to one f32
    ulp of the frame coordinate plus 1e-6 of the offsets (the final add
    x0 + dx rounds at the position's scale), wavelength, absorption
    length, pupil and time to 1e-6 relative."""
    rng = np.random.default_rng(6)
    types = (POINT, SERSIC, KNOTS, STREAK, FITS)
    js, ts = _family_scene(types, rng)
    n = 30_000
    obj = rng.integers(0, 64, n).astype(np.int32)
    w = (rng.uniform(size=n) < 0.9).astype(np.float32)
    kol = JP.kolmogorov_cdf()
    jtab = dataclasses.replace(kol, y=jnp.asarray(kol.y * 0.7))
    key = jax.random.PRNGKey(3)
    want = JR.shoot(key, js, jnp.asarray(obj), jnp.asarray(w),
                    {"kolmogorov": jtab, "gauss_sigma": 0.3 / 2.35482},
                    exptime=30.0, pixel_scale=0.2, families=types)
    ttab = dataclasses.replace(TP.kolmogorov_cdf(),
                               y=torch.as_tensor(kol.y * 0.7))
    got = TR.shoot(None, ts, torch.as_tensor(obj), torch.as_tensor(w),
                   {"kolmogorov": ttab, "gauss_sigma": 0.3 / 2.35482},
                   profiles, exptime=30.0, pixel_scale=0.2, families=types,
                   draws=_jax_shoot_draws(key, n))
    x0 = np.asarray(js.params)[obj, :2]
    for i, name in enumerate(("x", "y")):
        g, wv = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        off = np.abs(wv - x0[:, i]).max()
        assert np.abs(g - wv).max() <= 1e-6 * off + np.spacing(
            np.float32(np.abs(wv).max())), name
    for name in ("wavelength", "abs_len", "pupil_u", "pupil_v", "time",
                 "flux"):
        g, wv = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert np.abs(g - wv).max() <= 1e-6 * np.abs(wv).max(), name


@pytest.fixture(scope="module")
def pixel_scene():
    """30 stars on a 70-px grid + 20 Sersic galaxies inside 512 x 512,
    positions in pixels, R22_S11's silicon with its tree rings."""
    rng = np.random.default_rng(17)
    gx, gy = np.meshgrid(np.arange(6) * 70 + 80, np.arange(5) * 70 + 90)
    xs = np.concatenate([gx.ravel() + rng.uniform(-0.5, 0.5, 30),
                         rng.uniform(60, 450, 20)])
    ys = np.concatenate([gy.ravel() + rng.uniform(-0.5, 0.5, 30),
                         rng.uniform(60, 450, 20)])
    n, n_pad = len(xs), 64
    flux = np.r_[np.full(30, 12_000.0), np.full(20, 4_000.0)]

    def pad(a, fill=0.0):
        out = np.full(n_pad, fill, np.float32)
        out[:n] = a
        return out

    wl = np.linspace(552.0, 691.0, 96).astype(np.float32)
    scene = JScene.from_columns(
        x=pad(xs), y=pad(ys), obj_type=pad(np.r_[np.zeros(30), np.ones(20)]),
        p0=pad(rng.uniform(0.3, 0.8, n)), p1=pad(rng.uniform(0.8, 3, n), 1.0),
        p2=pad(rng.uniform(0.4, 1.0, n), 1.0),
        p3=pad(rng.uniform(0, np.pi, n)), g1=pad(np.zeros(n)),
        g2=pad(np.zeros(n)), mu=pad(np.ones(n), 1.0),
        wl_icdf=np.broadcast_to(wl, (n_pad, 96)))
    return dict(jhost=JHost(scene=scene, flux=flux, nominal_flux=flux,
                            n_objects=n, pix_x=xs, pix_y=ys),
                xs=xs, ys=ys,
                sil=JSilicon.make(treering_model=TreeRings().get("R22_S11")))


def _moments(img, x, y, r=7):
    """Centroid, second moment <r^2> about it (px^2) and their standard
    errors, in a (2r+1)^2 box."""
    ix, iy = int(round(x)), int(round(y))
    box = img[iy - r:iy + r + 1, ix - r:ix + r + 1].astype(np.float64)
    yy, xx = np.mgrid[iy - r:iy + r + 1, ix - r:ix + r + 1]
    w = box.sum()
    cx, cy = (box * xx).sum() / w, (box * yy).sum() / w
    r2 = (xx - cx) ** 2 + (yy - cy) ** 2
    m2 = (box * r2).sum() / w
    m4 = (box * r2 ** 2).sum() / w
    return cx, cy, np.sqrt(m2 / 2 / w), m2, np.sqrt((m4 - m2 ** 2) / w)


def test_render_ccd_pooled_analytic_matches_jax(pixel_scene, profiles):
    """render_ccd_pooled without tel/ctx (the analytic path, silicon with
    the per-chunk displacement and the folded tree rings) against the
    JAX package's: total landed flux within 3 sqrt + 0.5% (edge losses
    differ by photon), charge accounting to 1e-4, star centroids within
    0.05 px + 3 sigma, the stars' mean second moment within 4 sigma +
    1%."""
    s = pixel_scene
    kw = dict(xsize=512, ysize=512, nbatch=3, pupil_pairing=4,
              screen_share=4, nsub=4, fwhm=0.7)
    jimg = np.asarray(JPP.render_ccd_pooled(
        3, s["jhost"], JPP.PoolingConfig(**kw), s["sil"])[0], np.float64)
    host = CV.host_from_numpy(s["jhost"], "cpu")
    tally = {}
    timg, modes, _ = TPP.render_ccd_pooled(
        3, host, TPP.PoolingConfig(**kw), CV.silicon_from_numpy(s["sil"]),
        profiles=profiles, tally=tally)
    timg = timg.numpy().astype(np.float64)
    assert (modes == TPP.PHOT).all() and np.isfinite(timg).all()
    jt, tt = jimg.sum(), timg.sum()
    assert abs(jt - tt) <= 3 * np.sqrt(jt) + 0.005 * jt, (jt, tt)
    assert abs(tt - float(tally["in_frame"])) <= 1e-4 * tt
    jm, tm = [], []
    for x, y in zip(s["xs"][:30], s["ys"][:30]):
        j, t = _moments(jimg, x, y), _moments(timg, x, y)
        sig = np.hypot(j[2], t[2])
        assert abs(j[0] - t[0]) <= 0.05 + 3 * sig, (x, j, t)
        assert abs(j[1] - t[1]) <= 0.05 + 3 * sig, (y, j, t)
        jm.append(j[3:])
        tm.append(t[3:])
    jm, tm = np.array(jm), np.array(tm)
    sig = np.hypot(np.sqrt((jm[:, 1] ** 2).sum()),
                   np.sqrt((tm[:, 1] ** 2).sum())) / 30
    assert abs(jm[:, 0].mean() - tm[:, 0].mean()) \
        <= 4 * sig + 0.01 * jm[:, 0].mean()


def test_render_ccd_pooled_analytic_without_silicon(pixel_scene, profiles):
    """The ideal binner on the analytic path: charge accounted exactly;
    cfg.psf_table (a narrow Gaussian) tightens the stars."""
    s = pixel_scene
    host = CV.host_from_numpy(s["jhost"], "cpu")
    cfg = TPP.PoolingConfig(xsize=512, ysize=512, nbatch=2, fwhm=0.7)
    tally = {}
    img = TPP.render_ccd_pooled(5, host, cfg, profiles=profiles,
                                tally=tally)[0].numpy()
    assert img.sum() == pytest.approx(float(tally["in_frame"]), rel=1e-6)
    narrow = TP.radial_cdf_from_mtf(lambda k: np.exp(-0.5 * (0.05 * k) ** 2),
                                    r_max=0.5)
    img2 = TPP.render_ccd_pooled(
        5, host, dataclasses.replace(cfg, psf_table=narrow, gauss_fwhm=0.01),
        profiles=profiles)[0].numpy()
    m = [_moments(img, x, y)[3] for x, y in zip(s["xs"][:30], s["ys"][:30])]
    m2 = [_moments(img2, x, y)[3] for x, y in zip(s["xs"][:30],
                                                   s["ys"][:30])]
    assert np.mean(m2) < 0.5 * np.mean(m)


def test_render_ccd_matches_jax_end_to_end_scenes(tmp_path, profiles):
    """render_ccd on tests/test_end_to_end.py's scenes: the photometry
    scene (4 objects, every photon binned exactly once; aperture fluxes
    within the reference's 4 sigma + 2%, and within 4 sigma + 2% of the
    JAX package's) and the sky scene (40 e-/px mean within 5%, std
    within 20%, as there)."""
    from imsim_tpu.catalog.bandpass import rubin_bandpass
    from imsim_tpu.catalog.instcat import read_instcat
    from imsim_tpu.image.ccd_render import RenderConfig as JCfg
    from imsim_tpu.image.ccd_render import render_ccd as j_render
    from imsim_tpu.image.scene import build_scene
    from imsim_tpu_torch.image.ccd_render import RenderConfig, render_ccd
    from tests.test_end_to_end import _mk_wcs, _write_instcat

    w = np.linspace(300, 1200, 91)
    np.savetxt(tmp_path / "flat_sed.txt", np.c_[w, np.ones_like(w)])
    wcs = _mk_wcs()
    cat = tmp_path / "cat2.txt"
    _write_instcat(cat, wcs, [(128, 128, 22.0, "point"),
                              (384, 384, 21.5, "point"),
                              (128, 384, 21.0, "sersic"),
                              (384, 128, 22.5, "knots")])
    tab = read_instcat(str(cat), wcs, xsize=512, ysize=512)
    bp = rubin_bandpass("r", airmass=1.2)
    jhost = build_scene(tab, bp, [str(tmp_path)], exptime=30.0,
                        rng=np.random.default_rng(7))
    host = CV.host_from_numpy(jhost, "cpu")
    kw = dict(xsize=512, ysize=512, batch_size=1 << 16, fwhm=0.7,
              sky_level=0.0)
    jimg = np.asarray(j_render(42, jhost, JCfg(**kw)))
    img = render_ccd(42, host, RenderConfig(**kw), profiles=profiles).numpy()
    assert img.sum() == pytest.approx(host.flux.sum(), rel=1e-6)
    for i in range(4):
        x, y = int(round(tab.x[i])), int(round(tab.y[i]))
        ap = img[max(y - 40, 0):y + 40, max(x - 40, 0):x + 40].sum()
        jap = jimg[max(y - 40, 0):y + 40, max(x - 40, 0):x + 40].sum()
        f = host.flux[i]
        assert abs(ap - f) < 4 * np.sqrt(f) + 0.02 * f
        assert abs(ap - jap) < 4 * np.sqrt(2 * f) + 0.02 * f

    cat = tmp_path / "cat3.txt"
    _write_instcat(cat, wcs, [(128, 128, 25.0, "point")])
    tab = read_instcat(str(cat), wcs, xsize=512, ysize=512)
    host = CV.host_from_numpy(build_scene(tab, bp, [str(tmp_path)]), "cpu")
    img = render_ccd(42, host, RenderConfig(
        xsize=512, ysize=512, batch_size=1 << 16, sky_level=1000.0),
        profiles=profiles).numpy()
    corner = img[:100, 300:400]
    assert corner.mean() == pytest.approx(40.0, rel=0.05)
    assert corner.std() == pytest.approx(np.sqrt(40.0), rel=0.2)
