"""The port's sky and noise stage (imsim_tpu_torch.image.ccd_render,
utils.grid, utils.rng.poisson_approx) held against the JAX package's.

The grid helpers and the noiseless sky are deterministic: within 1e-6
of max |out|.  The noise is drawn from different random streams in the
two packages, so it is compared by its mean and variance: each within 5
standard errors of the difference of the two estimates."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imsim_tpu.image.ccd_render import _add_sky_and_noise as j_sky
from imsim_tpu.utils import grid as JG
from imsim_tpu.utils.rng import poisson_approx as j_poisson
from imsim_tpu_torch.image import ccd_render as TC
from imsim_tpu_torch.utils import grid as TG
from imsim_tpu_torch.utils.rng import poisson_approx, stream

torch.set_num_threads(1)


@pytest.mark.parametrize("shape,step", [((300, 257), 32), ((64, 64), 7),
                                        ((50, 40), 1)])
def test_upsample_bilinear_matches_jax(shape, step):
    gh, gw = TG.coarse_shape(shape, step)
    assert (gh, gw) == JG.coarse_shape(shape, step)
    g = np.random.default_rng(step).uniform(0.5, 1.0, (gh, gw)).astype(
        np.float32)
    want = np.asarray(JG.upsample_bilinear(jnp, jnp.asarray(g), shape, step))
    got = TG.upsample_bilinear(torch.as_tensor(g), shape, step).numpy()
    assert got.shape == tuple(shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _pieces(H, W, step=32):
    """A gradient, a coarse vignetting grid and a fringe map."""
    rng = np.random.default_rng(11)
    gh, gw = TG.coarse_shape((H, W), step)
    vig = rng.uniform(0.85, 1.0, (gh, gw)).astype(np.float32)
    fringe = (1 + 0.02 * rng.standard_normal((H, W))).astype(np.float32)
    grad = (np.float32(2e-4), np.float32(-1e-4), np.float32(1.0))
    return grad, vig, fringe


def test_sky_expectation_matches_the_jax_formula():
    """sky_level x pixel_scale^2 x (a x + b y + c) x upsampled vignetting
    x fringe, the JAX package's expression in jnp."""
    H, W = 256, 320
    grad, vig, fringe = _pieces(H, W)
    up = JG.upsample_bilinear(jnp, jnp.asarray(vig), (H, W), 32) \
        * jnp.asarray(fringe)
    yy = jnp.arange(H, dtype=jnp.float32)[:, None]
    xx = jnp.arange(W, dtype=jnp.float32)[None, :]
    want = np.asarray(jnp.float32(17_500.0) * (0.2 ** 2)
                      * (grad[0] * xx + grad[1] * yy + grad[2]) * up)
    got = TC.sky_expectation((H, W), 17_500.0, grad, vig, 0.2, 32, fringe,
                             "cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * want.max())


def _moments(x):
    x = np.asarray(x, np.float64).ravel()
    return x.mean(), x.var(), len(x)


@pytest.mark.parametrize("lam", [0.3, 4.0, 150.0, 999.0, 1001.0, 5e4])
def test_poisson_approx_matches_jax(lam):
    """Exact draws below 1000, the rounded Gaussian from 1000 up: mean
    and variance of 2^17 draws each within 5 sigma (Var(s^2) ~
    (lam + 2 lam^2) / n)."""
    n = 1 << 17
    want = j_poisson(jax.random.PRNGKey(1), jnp.full((n,), lam, jnp.float32))
    got = poisson_approx(stream(1, "p", device="cpu"),
                         torch.full((n,), lam))
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.round(got)) and bool((got >= 0).all())
    (mj, vj, _), (mt, vt, _) = _moments(want), _moments(got.numpy())
    assert abs(mt - mj) <= 5 * np.sqrt(2 * lam / n)
    assert abs(vt - vj) <= 5 * np.sqrt(2 * (lam + 2 * lam ** 2) / n)


@pytest.mark.parametrize("exact,level,read_noise", [
    (False, 17_500.0, 0.0),    # the bench sky: ~700 e-/px, Gaussian
    (True, 50.0, 0.0),         # a dark sky, exact Poisson: 2 e-/px
    (False, 17_500.0, 9.0),    # the CCD read-noise floor, gain 1.5
])
def test_add_sky_and_noise_matches_jax_statistically(exact, level,
                                                     read_noise):
    """Both packages on the same image and sky pieces: the mean added
    charge and the variance of the residual about the noiseless sky
    agree within 5 sigma of the difference; the port's variance is the
    sky's plus 1/12 (the rounding) plus (read_noise / gain)^2."""
    H, W = 384, 320
    grad, vig, fringe = _pieces(H, W)
    img = np.random.default_rng(2).uniform(0, 100, (H, W)).astype(
        np.float32)
    kw = dict(exact_poisson=exact, read_noise=read_noise, gain=1.5,
              vig_step=32)
    want = np.asarray(j_sky(jax.random.PRNGKey(4), jnp.asarray(img),
                            jnp.float32(level), grad, jnp.asarray(vig), 0.2,
                            fringe=jnp.asarray(fringe), **kw))
    got = TC.add_sky_and_noise(stream(4, "sky", device="cpu"),
                               torch.as_tensor(img), level, grad, vig, 0.2,
                               fringe=fringe, **kw).numpy()
    sky = TC.sky_expectation((H, W), level, grad, vig, 0.2, 32, fringe,
                             "cpu").numpy().astype(np.float64)
    extra = (read_noise / 1.5) ** 2 + (0.0 if exact else 1.0 / 12)
    n = H * W
    var = sky.mean() + extra
    (mj, vj, _), (mt, vt, _) = (_moments(want - img - sky),
                                _moments(got - img - sky))
    assert abs(mt - mj) <= 5 * np.sqrt(2 * var / n)
    assert abs(mt) <= 5 * np.sqrt(var / n)
    assert abs(vt - vj) <= 5 * np.sqrt(2 * (var + 2 * var ** 2) / n)
    assert abs(vt - var) <= 5 * np.sqrt((var + 2 * var ** 2) / n)
