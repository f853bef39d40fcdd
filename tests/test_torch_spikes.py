"""The port's diffraction-spike overlay (imsim_tpu_torch.image.
diffraction_fft) held against the JAX package's: the host kernel
bit-equal, the FFT overlay within 1e-5 of max |out|, and the photon-shot
calibration statistically (different random streams)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imsim_tpu.image import diffraction_fft as JD
from imsim_tpu_torch.image import diffraction_fft as TD

torch.set_num_threads(1)

SHAPE = dict(spike_flux_fraction=0.025, profile_power=1.15, r_scale_px=2.7)


@pytest.mark.parametrize("kw", [
    dict(rot_smear_deg=0.1),
    dict(rot_smear_deg=0.5, alpha_deg=30.0),
    dict(rot_thetas_deg=(0.0, 0.3, 0.7, 1.2)),
])
def test_spike_kernel_bit_equal(kw):
    """n = 65 with an explicit fraction, power and scale: the same numpy
    code, the same float32 kernel; it sums to 1 (the delta keeps
    1 - fraction)."""
    want = JD.spike_kernel(622.0, 0.2, n=65, **SHAPE, **kw)
    got = TD.spike_kernel(622.0, 0.2, n=65, **SHAPE, **kw, device="cpu")
    assert got.dtype == np.float32 and got.shape == (65, 65)
    np.testing.assert_array_equal(got, want)
    assert abs(float(got.sum(dtype=np.float64)) - 1.0) < 1e-5
    assert got[32, 32] == pytest.approx(1 - SHAPE["spike_flux_fraction"],
                                        abs=1e-6)


def _frame(shape, rng):
    img = rng.uniform(0, 5e4, shape).astype(np.float32)
    # a few saturated cores, one at the edge
    for y, x in ((10, 12), (35, 3), (2, 30)):
        img[..., y, x] = 2e6
        img[..., y + 1, x] = 8e5
    return img


@pytest.mark.parametrize("shape", [(48, 56), (3, 40, 44)])
def test_apply_spikes_matches_jax(shape):
    """One frame and a batch of stamps (the FFT pair over the last two
    axes): within 1e-5 of max |out|."""
    kern = JD.spike_kernel(622.0, 0.2, rot_smear_deg=0.1, n=65, **SHAPE)
    img = _frame(shape, np.random.default_rng(len(shape)))
    want = np.asarray(JD.apply_spikes(jnp.asarray(img), jnp.asarray(kern),
                                      jnp.float32(1e5)))
    got = TD.apply_spikes(torch.as_tensor(img), kern, 1e5).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # below saturation nothing moves but what the spikes bring in
    assert (got >= np.minimum(img, 1e5) - 1e-2 * np.abs(want).max()).all()


def test_apply_spikes_conserves_charge_away_from_the_edges():
    """A saturated core in the middle of a frame wide enough for the
    whole kernel: the frame's sum is unchanged (to float32 FFT
    rounding), and the excess sits on the four arms."""
    kern = TD.spike_kernel(622.0, 0.2, rot_smear_deg=0.1, n=65,
                           device="cpu", **SHAPE)
    img = torch.zeros((200, 200))
    img[100, 100] = 5e6
    out = TD.apply_spikes(img, kern, 1e5)
    assert abs(float(out.sum(dtype=torch.float64)) - 5e6) < 5e6 * 1e-5
    excess = 5e6 - 1e5
    arms = out.clone()
    arms[100, 100] -= 1e5 + excess * (1 - SHAPE["spike_flux_fraction"])
    assert float(arms.sum()) == pytest.approx(
        excess * SHAPE["spike_flux_fraction"], rel=1e-3)
    # 45 degree arms: the diagonal holds far more than the axes
    assert float(out[120, 120]) > 100 * float(out[100, 120]) + 1e-3


def test_calibrate_spike_profile_matches_jax_statistically():
    """2^16 photons each: the spike fraction P(|kick| > 2 px) within 5
    sigma of the difference of two binomial estimates; the fitted shape
    is finite and positive."""
    n = 1 << 16
    want = JD.calibrate_spike_profile(622.0, 0.2, n_phot=n, seed=3)
    got = TD.calibrate_spike_profile(622.0, 0.2, n_phot=n, seed=3,
                                     device="cpu")
    p = want["fraction"]
    sigma = np.sqrt(2 * p * (1 - p) / n)
    assert 0.0 < p < 0.5
    assert abs(got["fraction"] - p) <= 5 * sigma, (got, want, sigma)
    assert got["r_scale_px"] > 0 and np.isfinite(got["power"])
    # the calibrated kernel carries the calibrated fraction
    kern = TD.spike_kernel(622.0, 0.2, n=65, rot_smear_deg=0.1,
                           device="cpu")
    cal = TD.calibrate_spike_profile(622.0, 0.2, device="cpu")
    assert kern[32, 32] == pytest.approx(1 - cal["fraction"], abs=1e-6)
