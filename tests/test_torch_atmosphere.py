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
