"""The amounts that `correct` compares, on synthetic frames: a sound
charge and sky read near 0, and each reads about 0.1 with the charge or
the frame scaled by 0.9; the control's bfloat16 tally and frame fail."""
import numpy as np
import pytest

from portbench.reference import compare

NY, NX = 1024, 1152
CCFG = {"tile": 128, "bright_clear": 100, "fft_box": 120}
SCFG = {"tile": 64, "clip": 8}


def _scene(seed=5):
    """(image, x, y, flux, bright): Poisson photons of Gaussian objects
    uniform over the frame and a band of 100 px around it, two bright
    ones inside."""
    rng = np.random.default_rng(seed)
    n = 3000
    x = rng.uniform(-100, NX + 100, n)
    y = rng.uniform(-100, NY + 100, n)
    flux = 10 ** rng.uniform(2.0, 3.5, n)
    bright = np.zeros(n, bool)
    x[:2], y[:2], flux[:2], bright[:2] = (300, 800), (300, 600), 2e6, True
    image = np.zeros((NY, NX))
    for xi, yi, f in zip(x, y, rng.poisson(flux)):
        px = rng.normal(xi, 1.5, f)
        py = rng.normal(yi, 1.5, f)
        ix, iy = np.round(px).astype(int), np.round(py).astype(int)
        ok = (ix >= 0) & (ix < NX) & (iy >= 0) & (iy < NY)
        np.add.at(image, (iy[ok], ix[ok]), 1.0)
    return image.astype(np.float32), x, y, flux, bright


def _sky(seed=6, level=1225.0):
    rng = np.random.default_rng(seed)
    sky = np.round(level + np.sqrt(level) * rng.standard_normal((NY, NX)))
    sky[100, 100:110] += 5000.0          # a cosmic ray
    return sky


@pytest.fixture(scope="module")
def scene():
    return _scene()


def test_sound_charge_reads_near_zero_and_scaled_near_a_tenth(scene):
    image, x, y, flux, bright = scene
    sound = compare.charge_rel(image, x, y, flux, bright, CCFG)
    scaled = compare.charge_rel(image * 0.9, x, y, flux, bright, CCFG)
    assert sound < 0.02
    assert abs(scaled - 0.1) < 0.03
    fft = compare.fft_charge_rel(image, x, y, flux, bright, CCFG)
    fft_scaled = compare.fft_charge_rel(image * 0.9, x, y, flux, bright,
                                        CCFG)
    assert fft < 0.01 and abs(fft_scaled - 0.1) < 0.01
    # the control's bfloat16 tally stalls the bright stars' cores
    stalled = compare.bf16(np.minimum(image, compare.BF16_TALLY_STALL))
    assert compare.fft_charge_rel(stalled, x, y, flux, bright, CCFG) > 0.5


def test_fft_charge_is_absent_without_a_bright_box_in_frame(scene):
    image, x, y, flux, _ = scene
    assert compare.fft_charge_rel(image, x, y, flux,
                                  np.zeros(len(x), bool), CCFG) is None


def test_sky_chi2_reads_the_noise_against_its_level():
    sky = _sky()
    assert compare.sky_chi2(sky, SCFG) < 2e-3
    assert abs(compare.sky_chi2(sky * 0.9, SCFG) - 0.1) < 0.01
    # no noise: chi2 / pixel is the rounding's alone
    assert compare.sky_chi2(np.full((NY, NX), 1225.0), SCFG) > 0.99
    # the frame held in bfloat16 (spacing 8 above 1024)
    assert compare.sky_chi2(compare.bf16(sky), SCFG) > 3e-3
