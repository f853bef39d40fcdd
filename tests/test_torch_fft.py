"""The port's FFT branch (imsim_tpu_torch.image.fft_render and the FFT
pass of image.photon_pooling) held against the JAX package's.

Host tables are copies of the JAX package's numpy/scipy code: bit-equal.
Device stages run on the same inputs in both packages and are held to
1e-5 of max |out| (float32 FFTs of different libraries).  The noiseless
star field, the FFT pass and its `realized` are compared with the JAX
functions run with imsim_tpu.utils.rng.poisson_approx replaced by the
identity (both functions import the name when they run), and the port's
with its own poisson_approx replaced likewise.

    python tests/test_torch_fft.py

measures the JAX package's own gap between the noiseless star field's
sum and its summed `realized` at the bench CCD's Npad (chip_smoke.py's
gate (b) bar is twice that gap, at least 1e-3)."""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import imsim_tpu.utils.rng as JR  # noqa: E402
from imsim_tpu.image import fft_render as JF  # noqa: E402
from imsim_tpu.image import photon_pooling as JPP  # noqa: E402
from imsim_tpu.image.scene import DeviceScene as JScene  # noqa: E402
from imsim_tpu.image.scene import SceneHost as JHost  # noqa: E402
from imsim_tpu.photons import profiles as JP  # noqa: E402
from imsim_tpu_torch import convert as CV  # noqa: E402
from imsim_tpu_torch.image import fft_render as TF  # noqa: E402
from imsim_tpu_torch.image import photon_pooling as TPP  # noqa: E402
from imsim_tpu_torch.psf import atmosphere as TA  # noqa: E402
from imsim_tpu_torch.utils import rng as TR  # noqa: E402

torch.set_num_threads(1)

REL = 1e-5     # device stages: of max |out|
BENCH = dict(fft_sb_thresh=2e5, fwhm=0.7, noise_var=17_500.0 * 0.04)


def _close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rel * scale, (
        np.abs(got - want).max() / scale)


@pytest.fixture
def no_noise(monkeypatch):
    """poisson_approx -> identity in both packages."""
    monkeypatch.setattr(JR, "poisson_approx", lambda key, lam: lam)
    monkeypatch.setattr(TR, "poisson_approx", lambda gen, lam: lam)
    monkeypatch.setattr(TPP, "poisson_approx", lambda gen, lam: lam)


def _tables(cfg_kw):
    jt = JPP.make_psf_mtf(JPP.PoolingConfig(**cfg_kw))
    tt = TPP.make_psf_mtf(TPP.PoolingConfig(**cfg_kw))
    return jt, tt


def _same_table(a, b):
    assert (a.x0, a.dx) == (b.x0, b.dx)
    np.testing.assert_array_equal(np.asarray(a.y), b.y)
    assert b.y.dtype == np.float32


@pytest.mark.parametrize("fwhm,gauss", [(0.7, 0.3), (0.9, 0.25)])
def test_psf_mtf_tables_bit_equal(fwhm, gauss):
    kw = dict(fft_sb_thresh=2e5, fwhm=fwhm, gauss_fwhm=gauss)
    jt, tt = _tables(kw)
    _same_table(jt, tt)
    assert tt.x_max == jt.x_max
    r0 = 0.9758834 * 500e-9 / (fwhm * np.pi / 180 / 3600)
    _same_table(JF.vonkarman_mtf_table(622.0, r0),
                TF.vonkarman_mtf_table(622.0, r0))
    _same_table(JF.airy_mtf_table(622.0), TF.airy_mtf_table(622.0))
    rho = np.geomspace(1e-3, 10.0, 64)
    np.testing.assert_array_equal(TA.vonkarman_structure(rho, r0, 25.0),
                                  JP.vonkarman_structure(rho, r0, 25.0))
    assert TPP.make_psf_mtf(TPP.PoolingConfig()) is None


@pytest.mark.parametrize("n_s", [0.5, 1.0, 1.5, 4.0, 6.2])
def test_sersic_and_combined_tables_bit_equal(n_s):
    _same_table(JF.sersic_mtf_table(n_s), TF.sersic_mtf_table(n_s))
    jt, tt = _tables(BENCH)
    _same_table(JF.combined_mtf_table(jt, JF.sersic_mtf_table(n_s), 0.6),
                TF.combined_mtf_table(tt, TF.sersic_mtf_table(n_s), 0.6))
    assert TF.galaxy_peak_factor(tt, n_s, 0.45) \
        == JF.galaxy_peak_factor(jt, n_s, 0.45)


def test_stamp_sizes_peaks_and_cheb_bit_equal():
    jt, tt = _tables(BENCH)
    flux = np.geomspace(1e3, 3e7, 25)
    np.testing.assert_array_equal(
        TF.peak_surface_brightness(flux, tt, 0.2),
        JF.peak_surface_brightness(flux, jt, 0.2))
    for f in flux:
        for nv in (0.0, 700.0):
            assert TF.stamp_bucket(f, tt, 0.2, nv) \
                == JF.stamp_bucket(f, jt, 0.2, nv), (f, nv)
    for deg in (96, 40):
        a, b = JF.mtf_cheb(jt, deg), TF.mtf_cheb(tt, deg)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]
    for n in (100, 1000, 4096 + 512, 4096 + 4096, 7777):
        assert TF.good_fft_size(n) == JF.good_fft_size(n)
    rng = np.random.default_rng(3)
    args = [rng.uniform(0.3, 1, 9), rng.uniform(0, 3, 9),
            rng.normal(0, 0.05, 9), rng.normal(0, 0.05, 9),
            1 + rng.normal(0, 0.03, 9), rng.uniform(0.1, 2, 9)]
    np.testing.assert_array_equal(TF.lens_matrix(*args),
                                  JF.lens_matrix(*args))


def test_classifier_reproduces_the_bench_modes():
    """The port's classifier with its own PSF MTF at the bench settings
    (2e5 e-/px, fwhm 0.7, noise_var 700) gives the exported modes."""
    st = CV.load_ccd_state(device="cpu")
    host = CV.synthetic_scene(st, "cpu")
    cfg = TPP.PoolingConfig(**BENCH)
    modes = TPP.classify_objects(host, cfg, TPP.make_psf_mtf(cfg))
    np.testing.assert_array_equal(modes, st.modes)
    assert (modes == TPP.FFT).sum() == 17


def _galaxy_inputs(B, N, rng):
    jt, tt = _tables(BENCH)
    gt = JF.sersic_mtf_table(1.5)
    p = [rng.uniform(0.4, 1, B), rng.uniform(0, 3, B),
         rng.normal(0, 0.05, B), rng.normal(0, 0.05, B),
         1 + rng.normal(0, 0.03, B), rng.uniform(0.3, 1.2, B)]
    A = JF.lens_matrix(*p).astype(np.float32)
    common = dict(
        mtf_y=np.broadcast_to(np.asarray(jt.y), (B, len(jt.y))).copy(),
        mtf_dx=np.full(B, jt.dx, np.float32),
        flux=rng.uniform(1e5, 1e7, B).astype(np.float32),
        q=rng.uniform(0.5, 1, B).astype(np.float32),
        beta=rng.uniform(0, np.pi, B).astype(np.float32),
        sub_dx=rng.uniform(0, 1, B).astype(np.float32),
        sub_dy=rng.uniform(0, 1, B).astype(np.float32))
    gal = dict(gal_y=np.broadcast_to(np.asarray(gt.y), (B, len(gt.y))).copy(),
               gal_A=A)
    return common, gal, float(gt.dx)


@pytest.mark.parametrize("galaxy", [False, True])
def test_render_fft_stamps_matches_jax(galaxy):
    B, N = 4, 128
    common, gal, gal_dx = _galaxy_inputs(B, N, np.random.default_rng(5))
    kw = dict(common, **gal) if galaxy else common
    want = JF.render_fft_stamps(
        *[jnp.asarray(kw[k]) for k in ("mtf_y", "mtf_dx", "flux", "q",
                                       "beta", "sub_dx", "sub_dy")], N, 0.2,
        **(dict(gal_y=jnp.asarray(kw["gal_y"]), gal_dx=gal_dx,
                gal_A=jnp.asarray(kw["gal_A"])) if galaxy else {}))
    got = TF.render_fft_stamps(
        *[torch.as_tensor(kw[k]) for k in ("mtf_y", "mtf_dx", "flux", "q",
                                           "beta", "sub_dx", "sub_dy")],
        N, 0.2, **(dict(gal_y=torch.as_tensor(kw["gal_y"]), gal_dx=gal_dx,
                        gal_A=torch.as_tensor(kw["gal_A"])) if galaxy
                   else {}))
    _close(got.numpy(), want)
    # the stamp holds its flux (the MTF is 1 at k = 0)
    np.testing.assert_allclose(got.sum(dim=(1, 2)).numpy(), kw["flux"],
                               rtol=1e-3)


def test_add_stamps_matches_jax():
    """Corners inside, across every edge and clamped at -N and dim."""
    rng = np.random.default_rng(6)
    H, W, N = 200, 150, 64
    img = rng.uniform(0, 10, (H, W)).astype(np.float32)
    stamps = rng.uniform(0, 100, (6, N, N)).astype(np.float32)
    x0 = np.array([10, -30, W - 20, -N, W, 40], np.int32)
    y0 = np.array([20, 150, -40, 5, -N, H], np.int32)
    want = JF.add_stamps(jnp.asarray(img), jnp.asarray(stamps),
                         jnp.asarray(x0), jnp.asarray(y0))
    got = TF.add_stamps(torch.as_tensor(img), torch.as_tensor(stamps), x0, y0)
    _close(got.numpy(), want)


def _stars(rng, B, H, W, pad):
    return (rng.uniform(2e5, 8e6, B).astype(np.float32),
            rng.uniform(-pad, W - 1 + pad, B).astype(np.float32),
            rng.uniform(-20, H + 20, B).astype(np.float32))


@pytest.mark.parametrize("spikes", [False, True])
def test_star_field_matches_jax(no_noise, spikes):
    """Noiseless star field and realized (the port's star_field against
    JAX star_field_pass with the identity for the noise), with and
    without the spike overlay on the margin crop."""
    from imsim_tpu.image.diffraction_fft import spike_kernel as j_kernel

    _, tt = _tables(BENCH)
    cheb, k_max, _ = TF.mtf_cheb(tt)
    H, W = 300, 260
    kern, margin, sat = None, 0, 0.0
    if spikes:
        kern = j_kernel(622.0, 0.2, 45.0, 0.1, n=65,
                        spike_flux_fraction=0.02, profile_power=1.1,
                        r_scale_px=3.0)
        margin, sat = 32, 1e5
    pad = max(64, margin)
    Npad = TF.good_fft_size(max(H, W) + 2 * pad)
    flux, x, y = _stars(np.random.default_rng(7), 6, H, W, pad)
    with jax.disable_jit():
        want, w_real = JF.star_field_pass(
            jnp.zeros((H, W)), jnp.asarray(cheb), jnp.float32(k_max),
            jnp.asarray(flux), jnp.asarray(x), jnp.asarray(y),
            None if kern is None else jnp.asarray(kern), jnp.float32(sat),
            jax.random.PRNGKey(0), Npad, H, W, pad, 0.2, margin)
    got, g_real = TF.star_field(
        cheb, float(np.float32(k_max)), torch.as_tensor(flux),
        torch.as_tensor(x), torch.as_tensor(y), kern, sat, Npad, H, W, pad,
        0.2, margin)
    _close(got.numpy(), want)
    _close(g_real.numpy(), w_real)
    # star_field_pass with the identity noise adds the noiseless field
    img = torch.ones((H, W))
    out, _ = TF.star_field_pass(
        img, cheb, float(np.float32(k_max)), torch.as_tensor(flux),
        torch.as_tensor(x), torch.as_tensor(y), kern, sat, None, Npad, H, W,
        pad, 0.2, margin)
    assert torch.equal(out, img + got)


def test_star_field_noise_is_poisson():
    """The noisy field's added charge matches the noiseless field within
    5 sqrt(its sum), and its residual variance matches the field: the
    mean of res^2 / lam over the pixels above 50 e- is 1 within 5 sigma
    (sigma = sqrt(2 / pixels))."""
    _, tt = _tables(BENCH)
    cheb, k_max, _ = TF.mtf_cheb(tt)
    H, W, pad = 256, 256, 64
    Npad = TF.good_fft_size(H + 2 * pad)
    flux, x, y = (torch.as_tensor(a) for a in
                  _stars(np.random.default_rng(8), 5, H, W, pad))
    args = (cheb, float(np.float32(k_max)), flux, x, y, None, 0.0)
    vis, _ = TF.star_field(*args, Npad, H, W, pad)
    out, _ = TF.star_field_pass(torch.zeros((H, W)), *args,
                                TR.stream(1, "fftnoise", 0, device="cpu"),
                                Npad, H, W, pad)
    tot = float(vis.sum(dtype=torch.float64))
    assert abs(float(out.sum(dtype=torch.float64)) - tot) \
        <= 5 * np.sqrt(tot)
    assert torch.equal(out, torch.round(out))
    sel = vis > 50
    z2 = ((out - vis)[sel].double() ** 2 / vis[sel].double()).mean()
    assert abs(float(z2) - 1.0) < 5 * np.sqrt(2.0 / int(sel.sum()))


def _fft_scene(n_fft_gal=3, seed=9):
    """A 384 x 320 frame: 4 bright stars (one off the left edge), 3
    bright Sersic/knot galaxies and 20 faint pooled objects, in both
    packages' containers.  COL_X/COL_Y hold the pixel positions (no
    optics), so the FFT pass reads them."""
    rng = np.random.default_rng(seed)
    n = 27
    xs = np.r_[rng.uniform(30, 290, 3), -12.0, rng.uniform(40, 280, 23)]
    ys = np.r_[rng.uniform(30, 350, 3), 100.0, rng.uniform(40, 340, 23)]
    t = np.r_[np.zeros(4), np.ones(n_fft_gal - 1), 2.0,
              rng.integers(0, 2, 20)].astype(np.float32)
    flux = np.r_[rng.uniform(3e6, 9e6, 4), rng.uniform(2e7, 4e7, n_fft_gal),
                 rng.uniform(200, 2000, 20)]
    n_pad = 32

    def pad(a, fill=0.0):
        out = np.full(n_pad, fill, np.float32)
        out[:n] = a
        return out

    cols = dict(x=pad(xs), y=pad(ys), obj_type=pad(t),
                p0=pad(rng.uniform(0.2, 0.5, n)),
                p1=pad(np.where(t == 2, 30.0, rng.uniform(0.8, 3.0, n)), 1.0),
                p2=pad(rng.uniform(0.5, 1.0, n), 1.0),
                p3=pad(rng.uniform(0, np.pi, n)),
                g1=pad(rng.normal(0, 0.02, n)), g2=pad(rng.normal(0, 0.02, n)),
                mu=pad(1 + rng.normal(0, 0.02, n), 1.0))
    wl = np.linspace(552.0, 691.0, 96).astype(np.float32)
    jscene = JScene.from_columns(**cols,
                                 wl_icdf=np.broadcast_to(wl, (n_pad, 96)))
    jhost = JHost(scene=jscene, flux=flux, nominal_flux=flux, n_objects=n)
    return jhost, CV.host_from_numpy(jhost, "cpu")


@pytest.mark.parametrize("spikes", [False, True])
def test_fft_pass_matches_jax(no_noise, spikes):
    """The whole FFT pass, stars and galaxy buckets, noiseless: image and
    realized within 1e-5 of their max against JAX _fft_pass; the port's
    stamps sit in the same buckets.  The spiked case also scales the FFT
    flux by a per-object vignetting factor (fft_vign)."""
    from imsim_tpu.image.diffraction_fft import spike_kernel as j_kernel

    jhost, host = _fft_scene()
    kw = dict(xsize=320, ysize=384, fft_sb_thresh=2e5, fwhm=0.7)
    jcfg, tcfg = JPP.PoolingConfig(**kw), TPP.PoolingConfig(**kw)
    jt, tt = JPP.make_psf_mtf(jcfg), TPP.make_psf_mtf(tcfg)
    modes = TPP.classify_objects(host, tcfg, tt)
    np.testing.assert_array_equal(modes,
                                  JPP.classify_objects(jhost, jcfg, jt))
    assert (modes[:7] == TPP.FFT).all() and (modes[7:] != TPP.FFT).all()
    sp, vign = None, None
    if spikes:
        sp = dict(kernel=j_kernel(622.0, 0.2, 45.0, 0.1, n=65,
                                  spike_flux_fraction=0.03,
                                  profile_power=1.2, r_scale_px=2.5),
                  sat=2e5)
        vign = np.linspace(0.8, 1.0, 27)
    with jax.disable_jit():
        jimg, jreal = JPP._fft_pass(jnp.zeros((384, 320)), jhost, modes,
                                    jcfg, jt, 3, spikes=sp, vign=vign)
    timg, treal = TPP._fft_pass(torch.zeros((384, 320)), host, modes, tcfg,
                                tt, 3, spikes=sp, vign=vign)
    _close(timg.numpy(), jimg)
    _close(treal.numpy(), jreal)
    stars, buckets = TPP.fft_plan(host, modes, tcfg, tt, sp)
    assert list(stars.ids) == [0, 1, 2, 3]
    assert sorted(i for b in buckets for i in b.ids) == [4, 5, 6]


def test_fft_pass_needs_the_psf_mtf():
    """force_fft with fft_sb_thresh 0 has no PSF MTF: the pass refuses
    it (the JAX package fails inside its stamp sizing)."""
    _, host = _fft_scene()
    cfg = TPP.PoolingConfig(xsize=320, ysize=384, force_fft=True)
    modes = TPP.classify_objects(host, cfg)
    assert (modes == TPP.FFT).sum() == 27
    with pytest.raises(ValueError, match="fft_sb_thresh"):
        TPP._fft_pass(torch.zeros((384, 320)), host, modes, cfg, None, 0)


def jax_star_field_gap() -> dict:
    """The JAX package's gap between the noiseless star field's sum and
    its summed `realized` for the bench CCD's 17 FFT stars at the bench's
    Npad, with the spikes off and poisson_approx replaced by the
    identity; the stars at the scene's pixel positions."""
    st = CV.load_ccd_state(device="cpu")
    host = CV.synthetic_scene(st, "cpu")
    cfg = TPP.PoolingConfig(xsize=st.nx, ysize=st.ny, **BENCH)
    tt = TPP.make_psf_mtf(cfg)
    kern = np.zeros((513, 513), np.float32)    # sets the margin only
    stars, _ = TPP.fft_plan(host, st.modes, cfg, tt,
                            dict(kernel=kern, sat=175_000.0))
    JR_poisson = JR.poisson_approx
    JR.poisson_approx = lambda key, lam: lam
    try:
        img, real = JF.star_field_pass(
            jnp.zeros((st.ny, st.nx)), jnp.asarray(stars.cheb),
            jnp.float32(stars.k_max), jnp.asarray(stars.flux),
            jnp.asarray(stars.x), jnp.asarray(stars.y), None,
            jnp.float32(0.0), jax.random.PRNGKey(0), stars.Npad, st.ny,
            st.nx, stars.pad, 0.2, stars.margin)
        field_sum = float(np.asarray(img, np.float64).sum())
    finally:
        JR.poisson_approx = JR_poisson
    real_sum = float(np.asarray(real, np.float64).sum())
    return dict(Npad=stars.Npad, pad=stars.pad, n_stars=len(stars.ids),
                field_sum=field_sum, realized_sum=real_sum,
                rel_gap=(field_sum - real_sum) / real_sum)


if __name__ == "__main__":
    import json

    print(json.dumps(jax_star_field_gap()))
