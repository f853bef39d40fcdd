"""The port's cosmic rays (imsim_tpu_torch.image.cosmic_rays) against
the JAX package's imsim_tpu.image.cosmic_rays: the synthesized footprint
bank and the painted image are bit-equal (host numpy in the same
default_rng order; each hit a float64 add rounded to float32, as numpy's
add.at on a float32 frame)."""
import numpy as np
import pytest
import torch

from imsim_tpu.image import cosmic_rays as JC
from imsim_tpu_torch.image import cosmic_rays as TC

torch.set_num_threads(1)


@pytest.mark.parametrize("n,seed", [(1000, 2017), (300, 5)])
def test_footprint_bank_bit_equal(n, seed):
    j = JC.CosmicRayCatalog.synthesize(n, seed)
    t = TC.CosmicRayCatalog.synthesize(n, seed)
    assert len(t) == len(j) == n
    for a, b in zip(t.footprints, j.footprints):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    assert TC.get_default_catalog() is TC.get_default_catalog()
    assert (TC.CR_RATE_DEFAULT, TC.PIXEL_CM) == (JC.CR_RATE_DEFAULT,
                                                 JC.PIXEL_CM)


@pytest.mark.parametrize("shape,exptime,rate,seed", [
    ((400, 300), 30.0, 5.0, 11),
    # a dense run: ~5,800 CRs on the frame, many pixels hit several times
    ((256, 256), 30.0, 300.0, 3)])
def test_painted_image_bit_equal(shape, exptime, rate, seed):
    """On a sky-like float32 frame: the same hits, and the same image
    bit for bit (repeated hits on a pixel included)."""
    base = np.random.default_rng(0).normal(700, 30, shape).astype(np.float32)
    want = JC.paint_cosmic_rays(base.copy(), exptime, seed, ccd_rate=rate)
    got = TC.paint_cosmic_rays(torch.as_tensor(base.copy()), exptime, seed,
                               ccd_rate=rate).numpy()
    np.testing.assert_array_equal(got, want)
    pix, e = TC.cosmic_ray_hits(shape, exptime, seed, ccd_rate=rate)
    assert len(pix) > 0
    n_hits = np.bincount(pix, minlength=base.size)
    if rate > 1:
        assert n_hits.max() >= 3
    # the painted charge is the hits' in-frame sum
    added = got.astype(np.float64) - base
    assert abs(added.sum() - e.sum()) <= 1e-6 * e.sum()
    assert (added.ravel()[n_hits == 0] == 0).all()


def test_no_cosmic_rays_leaves_the_image():
    img = torch.full((64, 64), 5.0)
    out = TC.paint_cosmic_rays(img, 30.0, 1, ccd_rate=0.0)
    assert out is img and bool((out == 5.0).all())
