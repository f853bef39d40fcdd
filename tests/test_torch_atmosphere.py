"""Atmosphere: the port's first kick on the JAX package's screens, and
its FFT screen synthesis on the same noise, against the JAX package."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imsim_tpu.photons import profiles as JP
from imsim_tpu.psf import atmosphere as JA
from imsim_tpu_torch import convert as CV
from imsim_tpu_torch.psf import atmosphere as TA

torch.set_num_threads(1)

# a 51.2 m screen (64 x 64 texels at 0.8 m) keeps the FFTs small
CFG = JA.AtmConfig(fwhm=0.7, screen_size=51.2)
SEED = 42 + 271828


@pytest.fixture(scope="module")
def screens():
    return JA.make_screens(SEED, CFG)


@pytest.mark.parametrize("share", [1, 4])
def test_first_kick_angles_match_jax(screens, share):
    """Nearest-texel gathers at the wind-advected pupil position: the
    same f32 arithmetic picks the same texels, so the kicks agree to
    f32 rounding (1e-9 rad on ~1e-6 rad kicks)."""
    rng = np.random.default_rng(7)
    n = 4096
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    pu, pv = f32(rng.uniform(-4, 4, n)), f32(rng.uniform(-4, 4, n))
    t = f32(rng.uniform(0, 30, n))
    thx, thy = f32(rng.uniform(-0.01, 0.01, n)), f32(rng.uniform(-0.01,
                                                                  0.01, n))
    want = JA.first_kick_angles(*map(jnp.asarray, (pu, pv, t)), screens,
                                theta_x=jnp.asarray(thx),
                                theta_y=jnp.asarray(thy), share=share)
    T = torch.as_tensor
    got = TA.first_kick_angles(T(pu), T(pv), T(t),
                               CV.screens_from_numpy(screens, "cpu"),
                               theta_x=T(thx), theta_y=T(thy), share=share)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-9)
    assert TA.strong_layer_mask(screens.weights) == \
        JA.strong_layer_mask(screens.weights)


def test_make_screens_same_noise_matches_jax(screens):
    """The torch FFT synthesis on the noise the JAX package draws for
    each layer reproduces its gradient screens: relative 1e-4 of the
    screen's max gradient (f32 FFT rounding in two FFT libraries)."""
    n = int(round(CFG.screen_size / CFG.screen_scale))
    noise = []
    for i in range(CFG.nlayers):
        k1, k2 = jax.random.split(jax.random.PRNGKey(SEED + 1000 * i))
        noise.append(np.asarray(jax.random.normal(k1, (n, n)))
                     + 1j * np.asarray(jax.random.normal(k2, (n, n))))
    airmass = 1.0 / max(np.sin(np.radians(CFG.altitude_deg)), 0.1)
    r0_500 = JA.solve_r0_500(CFG.fwhm, CFG.L0) * airmass ** (-3.0 / 5.0)
    spec = CV.screen_spec_from_numpy(screens, r0_500, CFG.L0, CFG.kcrit)
    got = TA.make_screens(spec, "cpu", noise=torch.as_tensor(
        np.stack(noise).astype(np.complex64)))
    want = np.asarray(screens.grad)
    assert got.grad.shape == want.shape
    assert np.abs(got.grad.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    assert got.weights == screens.weights
    np.testing.assert_array_equal(got.winds, np.asarray(screens.winds))


def test_spectrum_helpers_are_copies():
    """The copied host helpers equal the JAX package's."""
    k = np.geomspace(1e-3, 1e2, 200)
    np.testing.assert_array_equal(TA.vonkarman_phase_spectrum(k, 0.15, 25.0),
                                  JP.vonkarman_phase_spectrum(k, 0.15, 25.0))
    np.testing.assert_array_equal(
        TA._screen_spectrum_amplitude(64, 0.8, 0.3, 25.0, 1.4),
        JA._screen_spectrum_amplitude(64, 0.8, 0.3, 25.0, 1.4))


def test_screens_from_generator_are_seeded():
    spec = TA.ScreenSpec(weights=(0.7, 0.3), winds=np.zeros((2, 2)),
                         r0_layer=np.array([0.2, 0.4]), L0=25.0,
                         kcrit_rad=1.0, size=25.6, scale=0.8)
    from imsim_tpu_torch.utils.rng import stream

    a = TA.make_screens(spec, "cpu", gen=stream(1, "screens", device="cpu"))
    b = TA.make_screens(spec, "cpu", gen=stream(1, "screens", device="cpu"))
    c = TA.make_screens(spec, "cpu", gen=stream(2, "screens", device="cpu"))
    assert a.grad.shape == (2, 32, 32, 2)
    assert torch.equal(a.grad, b.grad) and not torch.equal(a.grad, c.grad)
    assert torch.isfinite(a.grad).all()


@pytest.mark.parametrize("share", [1, 4])
def test_screens_the_jax_package_saved_load_in_the_port(tmp_path, screens,
                                                        share):
    """An npz the JAX package's save_screens wrote loads in the port
    (load_screens, on the caller's device, with the exposure's t0): its
    arrays are the saved ones, and first_kick_angles on it stays within
    1e-9 rad of the JAX package's on its own load."""
    path = str(tmp_path / "atm.npz")
    JA.save_screens(path, screens)
    jl = JA.load_screens(path, t0=12.5)
    tl = TA.load_screens(path, t0=12.5, device="cpu")
    assert tl.grad.device.type == "cpu" and tl.t0 == 12.5
    assert np.array_equal(tl.grad.numpy(), np.asarray(jl.grad))
    assert np.array_equal(tl.winds, np.asarray(jl.winds))
    assert (tl.scale, tl.size, tl.weights) == (jl.scale, jl.size, jl.weights)
    rng = np.random.default_rng(8)
    n = 4096
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    pu, pv = f32(rng.uniform(-4, 4, n)), f32(rng.uniform(-4, 4, n))
    t = f32(rng.uniform(0, 30, n))
    want = JA.first_kick_angles(*map(jnp.asarray, (pu, pv, t)), jl,
                                share=share)
    T = torch.as_tensor
    got = TA.first_kick_angles(T(pu), T(pv), T(t), tl, share=share)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-9)


def test_port_save_load_round_trip_is_bit_equal(tmp_path):
    """The port's own screens through save_screens and load_screens: the
    same arrays, scalars and weights; screens without weights too."""
    spec = TA.ScreenSpec(weights=(0.6, 0.4), winds=np.array(
        [[1.0, 2.0], [-3.0, 0.5]], np.float32), r0_layer=np.array([0.2, 0.4]),
        L0=25.0, kcrit_rad=1.0, size=25.6, scale=0.8, t0=3.0)
    from imsim_tpu_torch.utils.rng import stream

    scr = TA.make_screens(spec, "cpu", gen=stream(3, "screens",
                                                  device="cpu"))
    for weights in (scr.weights, None):
        s = TA.AtmScreens(grad=scr.grad, winds=scr.winds, scale=scr.scale,
                          size=scr.size, t0=scr.t0, weights=weights)
        path = str(tmp_path / f"s{weights is None}.npz")
        TA.save_screens(path, s)
        back = TA.load_screens(path, t0=3.0, device="cpu")
        assert torch.equal(back.grad, s.grad) and back.grad.dtype == \
            torch.float32
        assert np.array_equal(back.winds, s.winds)
        assert back.winds.dtype == s.winds.dtype
        assert (back.scale, back.size, back.t0, back.weights) == \
            (s.scale, s.size, s.t0, s.weights)
