"""The port's readout chain (imsim_tpu_torch.electronics.readout) held
against the JAX package's (imsim_tpu.electronics.readout).

Host CTE tables: bit-equal.  Device stages on the same inputs: the CTE
bands, segmentation and the zero-noise chain within 1e-6 of the full
well on frames with no saturated pixel.  The bleed's cases are those of
tests/test_readout.py.  On saturated frames the walk's float32 running
capacity sum (a cumsum over up to 2H visit steps) rounds differently in
the two packages; the bar there is that sum's rounding, 2H float32 ulps
of the full well per pixel (BLEED_BAR), which moves where a trail ends
by a fraction of one electron."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imsim_tpu.electronics import readout as JR
from imsim_tpu.electronics.camera import VENDOR_SPECS as J_SPECS
from imsim_tpu.electronics.camera import get_camera
from imsim_tpu_torch import convert as CV
from imsim_tpu_torch.electronics import readout as TR
from imsim_tpu_torch.electronics.camera import VENDOR_SPECS
from imsim_tpu_torch.utils.rng import stream

torch.set_num_threads(1)

FW = 1000.0


def BLEED_BAR(H, fw=FW):
    """The running capacity sum's rounding: 2H float32 ulps of fw."""
    return 2 * H * float(np.spacing(np.float32(fw)))


def test_vendor_specs_and_cte_tables_bit_equal():
    assert VENDOR_SPECS == J_SPECS
    np.testing.assert_array_equal(TR.cte_matrix(80, 1e-4),
                                  JR.cte_matrix(80, 1e-4))
    for npix, cti in ((2048, 1e-6), (576, 1e-6), (1000, 5e-4), (300, 0.0)):
        np.testing.assert_array_equal(TR.cte_bands(npix, cti),
                                      JR.cte_bands(npix, cti))


@pytest.mark.parametrize("axis", [1, 2])
def test_apply_cte_bands_matches_jax(axis):
    rng = np.random.default_rng(axis)
    x = rng.uniform(0, 1e5, (3, 120, 90)).astype(np.float32)
    bands = TR.cte_bands(x.shape[axis], 5e-4).astype(np.float32)
    want = np.asarray(JR.apply_cte_bands(jnp.asarray(x), jnp.asarray(bands),
                                         axis))
    got = TR.apply_cte_bands(torch.as_tensor(x), torch.as_tensor(bands),
                             axis).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * 1e5)


def _bleed_cases():
    """tests/test_readout.py's geometries."""
    rng = np.random.default_rng(3)
    cases = []
    img = np.zeros((100, 5)); img[40:45, 2] = 2000.0
    cases.append(("single run", img, False))
    img = np.zeros((100, 5)); img[40:45, 2] = 3000.0; img[30:40, 2] = 950.0
    cases.append(("asym nearly-full below", img, False))
    img = np.zeros((100, 5)); img[1:4, 2] = 50000.0
    cases.append(("bottom escape", img, False))
    img = np.zeros((100, 5)); img[20:23, 2] = 50000.0; img[30:33, 2] = 5000.0
    cases.append(("merging trails", img, False))
    img = np.zeros((100, 5)); img[90:99, 2] = 30000.0
    cases.append(("top clip", img, False))
    img = np.zeros((64, 6)); img[10, 1] = 1.5e4; img[30, 1] = 2e3
    img[50, 1] = 9e3; img[5:8, 4] = 6e4
    cases.append(("three runs in a column", img, False))
    img = np.full((64, 3), 990.0); img[20, 1] = 4e4; img[23, 1] = 1500.0
    cases.append(("negative capacity neighbours", img, True))
    for t in range(4):
        img = rng.uniform(0, 1200, (64, 8))
        img[rng.integers(5, 55), rng.integers(0, 8)] = rng.uniform(2e3, 8e4)
        img[rng.integers(5, 55), rng.integers(0, 8)] = rng.uniform(2e3, 8e4)
        cases.append((f"fuzz{t}", img, bool(t % 2)))
    return cases


@pytest.mark.parametrize("case", _bleed_cases(), ids=lambda c: c[0])
def test_bleed_image_matches_jax(case):
    name, img, midline = case
    img = img.astype(np.float32)
    want = np.asarray(JR.bleed_image(jnp.asarray(img), FW,
                                     midline_stop=midline))
    got = TR.bleed_image(torch.as_tensor(img), FW, midline).numpy()
    H = img.shape[0] // (2 if midline else 1)
    assert np.abs(got - want).max() <= BLEED_BAR(H), name
    assert got.max() <= FW
    # charge: conserved unless it escaped off the bottom edge
    assert got.sum() <= img.sum() * (1 + 1e-6)


def test_bleed_image_leaves_unsaturated_frames_alone():
    img = torch.rand((50, 20)) * FW
    assert torch.equal(TR.bleed_image(img, FW, True), img)


@pytest.mark.parametrize("vendor", ["E2V", "ITL", "ITL_WF"])
def test_segment_round_trip_and_jax(vendor):
    spec = VENDOR_SPECS[vendor]
    ny, nx = spec["ny"], spec["nx"]
    img = np.random.default_rng(0).normal(size=(ny, nx)).astype(np.float32)
    amps = TR.segment_image(torch.as_tensor(img), vendor)
    n_amps = 8 if vendor == "ITL_WF" else 16
    assert amps.shape == (n_amps, spec["amp_ny"], spec["amp_nx"])
    np.testing.assert_array_equal(
        amps.numpy(), np.asarray(JR.segment_image(jnp.asarray(img), vendor)))
    back = TR.unsegment_image(amps, vendor, ny, nx).numpy()
    np.testing.assert_array_equal(back, np.asarray(JR.unsegment_image(
        jnp.asarray(amps.numpy()), vendor, ny, nx)))
    if vendor != "ITL_WF":
        np.testing.assert_array_equal(back, img)


@pytest.fixture(scope="module")
def e2v():
    """R22_S11's JAX CcdReadout and the port's, from the same numbers
    (dark current 0 and read noise 0: the chain is deterministic)."""
    ccd = get_camera("LsstCamSim")["R22_S11"]
    jro = JR.CcdReadout(ccd, dark_current=0.0, read_noise=0.0)
    tro = TR.CcdReadout("E2V", np.asarray(jro.gains),
                        np.asarray(jro.read_noises),
                        np.asarray(jro.bias_levels), np.asarray(jro.xtalk),
                        jro.full_well, dark_current=0.0, device="cpu")
    return jro, tro


def _chain(jro, tro, img):
    spec = VENDOR_SPECS["E2V"]
    want = np.asarray(JR.readout_chain(
        jax.random.PRNGKey(0), jnp.asarray(img), jro.gains, jro.xtalk,
        jro.bias_levels, jro.read_noises, jro.pcte, jro.scte, "E2V",
        jro.full_well, spec["midline_bleed_stop"], 0.0, 30.0, 2.0))
    got = tro.chain(stream(0, "readout", device="cpu"),
                    torch.as_tensor(img)).numpy()
    return got, want


def test_readout_chain_matches_jax_without_noise(e2v):
    """An unsaturated eimage through bleed (nothing to do), segmentation,
    gains, crosstalk, embed and CTE: within 1e-6 of the full well."""
    jro, tro = e2v
    assert np.asarray(jro.read_noises).max() == 0.0
    img = np.random.default_rng(1).uniform(500, 9e4, (4004, 4096)).astype(
        np.float32)
    got, want = _chain(jro, tro, img)
    assert got.shape == want.shape == (16, 2048, 576)
    assert np.abs(got - want).max() <= 1e-6 * jro.full_well
    np.testing.assert_array_equal(tro.run(stream(0, "r", device="cpu"),
                                          torch.as_tensor(img)).numpy(),
                                  np.round(got).astype(np.int32))


def test_readout_chain_saturated_frame_matches_jax(e2v):
    """Saturated columns on both halves (the E2V midline stop) and one at
    the bottom edge: within the bleed's rounding bar, in ADU."""
    jro, tro = e2v
    img = np.random.default_rng(2).uniform(500, 2e3, (4004, 4096)).astype(
        np.float32)
    img[1000:1003, 700] = 2e6
    img[2500:2510, 3000] = 1.5e6
    img[1, 20] = 5e6
    got, want = _chain(jro, tro, img)
    bar = BLEED_BAR(2002, jro.full_well) / float(np.asarray(jro.gains).min())
    assert np.abs(got - want).max() <= bar + 1e-6 * jro.full_well


def test_ccd_readout_bias_gain_and_noise():
    """The bench state's readout (convert.load_ccd_state): a flat 1,700
    e- frame reads 1700 / gain + bias in the data section, the bias in
    the parallel overscan with the read noise's scatter (as
    tests/test_readout.py checks the JAX chain)."""
    st = CV.load_ccd_state(device="cpu")
    ro = st.readout
    spec = VENDOR_SPECS[ro.vendor]
    img = torch.full((st.ny, st.nx), 1700.0)
    raw = ro.run(stream(3, "readout", device="cpu"), img).numpy()
    assert raw.shape == (16, 2048, 576) and raw.dtype == np.int32
    pre, anx, any_ = spec["prescan"], spec["amp_nx"], spec["amp_ny"]
    for k in range(16):
        gain = float(ro.gains[k])
        bias = float(ro.bias_levels[k])
        rn = float(ro.read_noises[k])
        data = raw[k, :any_, pre:pre + anx]
        assert abs(data.mean() - (1700.0 / gain + bias)) < 1.5
        oscan = raw[k, any_:, :]
        assert abs(oscan.mean() - bias) < 1.0
        assert abs(oscan.std() - rn) < 0.3 * rn + 0.3
