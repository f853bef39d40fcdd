"""The port's flats (imsim_tpu_torch.image.flat) against the JAX
package's imsim_tpu.image.flat: one pixel-area iteration with the JAX
package's normal draws injected (1e-6 relative), and whole flats at the
JAX tests' own bars (tests/test_flat_skycat.py), since the two packages
draw different numbers."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imsim_tpu.image import flat as JF
from imsim_tpu.sensor.silicon import SiliconParams as JSilicon
from imsim_tpu.sensor.treerings import TreeRings
from imsim_tpu_torch import convert as CV
from imsim_tpu_torch.image import flat as TF
from imsim_tpu_torch.sensor.silicon import SiliconParams

torch.set_num_threads(1)


@pytest.mark.parametrize("strength", [0.0, 0.4, 1.1])
def test_flat_iteration_matches_jax(strength):
    """One iteration on a charged 96 x 130 frame: the K3 displacement
    field (its plain twin), the divergence area factor, lam x area +
    sqrt(lam x area) N(0, 1) clipped at 0, with the JAX package's normal
    draws: 1e-6 of max |image| (the stencil's f32 tap sums round
    differently in the last place; the image is ~4e4)."""
    rng = np.random.default_rng(3)
    img = rng.uniform(30_000, 50_000, (96, 130)).astype(np.float32)
    jsil = JSilicon.make(bf_strength=strength)
    key = jax.random.PRNGKey(7)
    want = np.asarray(JF._flat_iteration(key, jnp.asarray(img),
                                         jnp.float32(1000.0), jsil))
    noise = np.array(jax.random.normal(key, img.shape))
    got = TF._flat_iteration(None, torch.as_tensor(img), 1000.0,
                             CV.silicon_from_numpy(jsil),
                             noise=torch.as_tensor(noise)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_build_flat_brighter_fatter_ptc():
    """tests/test_flat_skycat.py:12-30 on the port: BF pulls var/mean
    below 1 and conserves the mean; without BF the flat stays
    Poisson."""
    cfg = TF.FlatConfig(counts_per_pixel=40_000.0, counts_per_iter=2000.0,
                        xsize=256, ysize=256)
    st = TF.flat_statistics(build := TF.build_flat(
        3, cfg, SiliconParams.make(bf_strength=1.1), device="cpu"))
    assert build.shape == (256, 256) and build.dtype == torch.float32
    assert abs(st["mean"] - 40_000.0) < 200.0
    assert st["var_over_mean"] < 0.97, st
    st0 = TF.flat_statistics(TF.build_flat(
        3, cfg, SiliconParams.make(bf_strength=0.0), device="cpu"))
    assert abs(st0["var_over_mean"] - 1.0) < 0.03, st0


def test_build_flat_matches_jax_statistics():
    """The default silicon at the runner's 80,000 e-/px in 1,000-count
    iterations on a 256 x 256 corner: the port's and the JAX package's
    mean agree within 5 standard errors of the mean (sqrt(var / n_pix))
    and their var / mean within 0.05 (each var / mean has a standard
    error sqrt(2 / n_pix) = 0.006; 0.05 leaves room for the BF
    correlations between neighbours).  Smaller frames are not Poisson-
    like at all: the zero-padded stencil pushes charge at the frame's
    edge, and the edge pattern's share of the variance grows as the
    frame shrinks (both packages give var / mean 1.05 at 160 x 160)."""
    cfg = TF.FlatConfig(xsize=256, ysize=256)
    t = TF.flat_statistics(TF.build_flat(5, cfg, device="cpu"))
    j = JF.flat_statistics(JF.build_flat(5, JF.FlatConfig(xsize=256,
                                                          ysize=256)))
    n_pix = 240 * 240
    assert abs(t["mean"] - j["mean"]) <= 5 * np.sqrt(2 * j["var"] / n_pix)
    assert abs(t["var_over_mean"] - j["var_over_mean"]) <= 0.05, (t, j)
    assert t["var_over_mean"] < 0.97 and abs(t["mean"] - 80_000) < 400


def test_flat_statistics_matches_jax():
    img = np.random.default_rng(2).gamma(5.0, 100.0, (64, 80)).astype(
        np.float32)
    t = TF.flat_statistics(torch.as_tensor(img))
    j = JF.flat_statistics(img)
    for k in j:
        assert t[k] == pytest.approx(j[k], rel=1e-12)


def test_photon_flat_plan_matches_jax_sub_batches():
    """The 16,777,216-photon sub-batch cap: the runner's default frame
    at 1,000 e-/px per iteration takes 978 sub-batches per iteration; the
    card's cut (50 e-/px, one iteration) 49."""
    assert TF.PHOTON_CAP == 16_777_216
    assert TF.photon_flat_plan(TF.FlatConfig()) == (80, 978, 16_769_309)
    cut = TF.FlatConfig(counts_per_pixel=50.0, counts_per_iter=50.0)
    n_iter, n_sub, per = TF.photon_flat_plan(cut)
    assert (n_iter, n_sub) == (1, 49) and n_sub * per >= 50 * 4096 * 4004


def test_build_flat_photons_sed_path():
    """tests/test_flat_skycat.py:209-229 on the port: an optical SED
    lands every photon (mean within 15 e- of 1000, var/mean within 0.06
    of 1), a deep-converting NIR SED loses most of them."""
    cfg = TF.FlatConfig(counts_per_pixel=1000.0, counts_per_iter=250.0,
                        xsize=96, ysize=96)
    params = SiliconParams.make(bf_strength=0.0)
    st = TF.flat_statistics(TF.build_flat_photons(
        2, cfg, np.full(96, 620.0, np.float32), params, device="cpu"))
    assert abs(st["mean"] - 1000.0) < 15.0, st
    assert abs(st["var_over_mean"] - 1.0) < 0.06, st
    st_n = TF.flat_statistics(TF.build_flat_photons(
        2, cfg, np.full(96, 1050.0, np.float32), params, device="cpu"))
    assert st_n["mean"] < 0.5 * st["mean"], st_n


def test_build_flat_photons_matches_jax_with_tree_rings():
    """R22_S11's silicon (default BF, folded tree rings) and a 552-691 nm
    illumination, 200 e-/px in 100-count iterations on 128 x 128: mean
    within 5 standard errors of the JAX package's (every photon converts
    at these wavelengths), var / mean within 0.06 of 1 and of the JAX
    package's."""
    cfg = TF.FlatConfig(counts_per_pixel=200.0, counts_per_iter=100.0,
                        xsize=128, ysize=128)
    wl = np.linspace(552.0, 691.0, 96).astype(np.float32)
    jsil = JSilicon.make(treering_model=TreeRings().get("R22_S11"))
    t = TF.flat_statistics(TF.build_flat_photons(
        4, cfg, wl, CV.silicon_from_numpy(jsil), device="cpu"))
    j = JF.flat_statistics(JF.build_flat_photons(
        4, JF.FlatConfig(counts_per_pixel=200.0, counts_per_iter=100.0,
                         xsize=128, ysize=128), wl, jsil))
    n_pix = 112 * 112
    assert abs(t["mean"] - j["mean"]) <= 5 * np.sqrt(2 * j["var"] / n_pix)
    assert abs(t["mean"] - 200.0) < 0.015 * 200.0
    assert abs(t["var_over_mean"] - 1.0) < 0.06
    assert abs(t["var_over_mean"] - j["var_over_mean"]) < 0.06
