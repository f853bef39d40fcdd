"""K3's plain twin and the silicon sensor stages against the JAX
package: the BF stencil (_displacement_slices and the Pallas
stencil_pair in interpret mode), the tree-ring field, the continuity
update and accumulate_silicon on fixed, pre-displaced photons."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imsim_tpu.ops.stencil import stencil_pair as j_stencil
from imsim_tpu.photons.batch import PhotonBatch as JBatch
from imsim_tpu.sensor import silicon as JS
from imsim_tpu.sensor.treerings import TreeRings
from imsim_tpu_torch import convert as CV
from imsim_tpu_torch.ops import stencil as TST
from imsim_tpu_torch.photons.batch import PhotonBatch as TBatch
from imsim_tpu_torch.sensor import silicon as TS

torch.set_num_threads(1)

H, W = 200, 264   # not tile-aligned on purpose


@pytest.fixture(scope="module")
def sil():
    j = JS.SiliconParams.make(treering_model=TreeRings().get("R22_S11"))
    return j, CV.silicon_from_numpy(j)


def _taps(j):
    Kp = jnp.pad(j.bf_kernel, 1)
    return (0.5 * (Kp[1:-1, 2:] - Kp[1:-1, :-2]),
            0.5 * (Kp[2:, 1:-1] - Kp[:-2, 1:-1]))


def test_stencil_pair_plain_matches_jax(sil):
    """Plain K3 == _displacement_slices and == the Pallas kernel
    (interpret mode) on a non-aligned frame: same f32 tap order, so
    1e-5 of max |out| covers the FMA-contraction differences."""
    jsil, tsil = sil
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1e5, (H, W)).astype(np.float32)
    dkx, dky = _taps(jsil)
    got = TST.stencil_pair(torch.as_tensor(img), *TS.bf_taps(tsil))
    for want in (JS._displacement_slices(jnp.asarray(img), dkx, dky),
                 j_stencil(jnp.asarray(img), dkx, dky, interpret=True)):
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    # the port's taps are the JAX package's central differences
    for a, b in zip(TS.bf_taps(tsil), (dkx, dky)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_tree_ring_field_matches_jax(sil):
    """Coarse-grid + bilinear tree-ring field, same stride: 1e-4 of the
    field's max.  The ring radius r ~ 6000 px is rounded differently by
    one f32 ulp (5e-4 px: XLA contracts rx^2 + ry^2 into an FMA), which
    moves the phase of a 100 px-period sinusoid by ~3e-5 rad."""
    jsil, tsil = sil
    assert TS.tree_ring_step(tsil) == JS.tree_ring_step(jsil)
    for step in (None, 1):
        want = JS.tree_ring_field(jsil, (H, W), step=step)
        got = TS.tree_ring_field(tsil, (H, W), "cpu", step=step)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def test_bf_redistribute_and_absorption_match_jax():
    rng = np.random.default_rng(5)
    q, dx, dy = (rng.uniform(0, 1, (H, W)).astype(np.float32)
                 for _ in range(3))
    want = np.asarray(JS.bf_redistribute(*map(jnp.asarray, (q, dx, dy))))
    got = TS.bf_redistribute(*map(torch.as_tensor, (q, dx, dy))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    wl = np.linspace(300, 1100, 4001).astype(np.float32)
    np.testing.assert_allclose(
        TS.absorption_length_poly(torch.as_tensor(wl)).numpy(),
        np.asarray(JS.absorption_length_poly(jnp.asarray(wl))), rtol=1e-5)
    args = [rng.uniform(1e-7, 1, 5000), rng.normal(size=5000),
            rng.normal(size=5000), rng.uniform(0, 200, 5000),
            rng.uniform(0, 200, 5000), rng.normal(0, 0.1, 5000),
            rng.normal(0, 0.1, 5000), np.ones(5000),
            rng.uniform(0.5, 200, 5000)]
    args = [np.asarray(a, np.float32) for a in args]
    want = JS.depth_diffusion_displace(*map(jnp.asarray, args),
                                       100.0, 10.0, 4.0)
    got = TS.depth_diffusion_displace(*map(torch.as_tensor, args),
                                      100.0, 10.0, 4.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_accumulate_silicon_matches_jax(sil):
    """accumulate_silicon on fixed, pre-displaced photons is
    deterministic: 4 BF chunks + the folded tree-ring field agree with
    the JAX package to 1e-5 of the image scale (scatter-add order and
    f32 stencil rounding)."""
    jsil, tsil = sil
    rng = np.random.default_rng(9)
    n = 40_000
    # two bright spots + a flat background, some photons off-frame
    cx = rng.choice([60.0, 180.0], n)
    x = np.where(rng.uniform(size=n) < 0.8, cx + rng.normal(0, 2, n),
                 rng.uniform(-10, W + 10, n)).astype(np.float32)
    y = np.where(rng.uniform(size=n) < 0.8, 100 + rng.normal(0, 2, n),
                 rng.uniform(-10, H + 10, n)).astype(np.float32)
    flux = np.full(n, 50.0, np.float32)   # BF-relevant charge levels
    z = np.zeros(n, np.float32)
    jph = JBatch(x=jnp.asarray(x), y=jnp.asarray(y), flux=jnp.asarray(flux),
                 wavelength=jnp.asarray(z + 620), dxdz=jnp.asarray(z),
                 dydz=jnp.asarray(z), pupil_u=jnp.asarray(z),
                 pupil_v=jnp.asarray(z), time=jnp.asarray(z))
    T = torch.as_tensor
    tph = TBatch(x=T(x), y=T(y), flux=T(flux), wavelength=T(z + 620),
                 dxdz=T(z), dydz=T(z), pupil_u=T(z), pupil_v=T(z), time=T(z))
    jtr = JS.tree_ring_field(jsil, (H, W))
    want = np.asarray(JS.accumulate_silicon(
        jax.random.PRNGKey(0), jph, jnp.zeros((H, W), jnp.float32), jsil,
        nsub=4, tr_field=jtr, pre_displaced=True))
    tally = {}
    got = TS.accumulate_silicon(
        tph, torch.zeros((H, W)), tsil, nsub=4,
        tr_field=TS.tree_ring_field(tsil, (H, W), "cpu"),
        tally=tally).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # charge conservation: image sum == in-frame flux binned
    assert abs(got.sum(dtype=np.float64) - float(tally["in_frame"])) \
        <= 1e-5 * got.sum()
