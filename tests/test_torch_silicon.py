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
        tally=tally, pre_displaced=True).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # charge conservation: image sum == in-frame flux binned
    assert abs(got.sum(dtype=np.float64) - float(tally["in_frame"])) \
        <= 1e-5 * got.sum()


def test_silicon_host_tables_bit_equal():
    """absorption_length_table, default_bf_kernel and SiliconParams.make
    are copies of the JAX package's host code: bit-equal."""
    ja, ta = JS.absorption_length_table(), TS.absorption_length_table()
    assert (ja.x0, ja.dx) == (ta.x0, ta.dx)
    np.testing.assert_array_equal(ta.y, np.asarray(ja.y))
    for kw in ({}, dict(radius=3, strength=1.1), dict(strength=0.0)):
        np.testing.assert_array_equal(TS.default_bf_kernel(**kw),
                                      JS.default_bf_kernel(**kw))
    model = TreeRings().get("R22_S11")
    for kw in ({}, dict(bf_strength=1.1, diffusion_um=3.0),
               dict(treering_model=model),
               dict(treering_profile=np.linspace(0, 0.1, 512))):
        j, t = JS.SiliconParams.make(**kw), TS.SiliconParams.make(**kw)
        for name in ("bf_kernel", "abs_y", "treering_y", "tr_waves",
                     "tr_env"):
            a = getattr(j, name)
            b = getattr(t, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(b, np.asarray(a), name)
        assert t.treering_center == tuple(
            float(v) for v in np.asarray(j.treering_center))
        assert (t.tr_active, t.thickness_um, t.diffusion_um, t.pixel_um) == (
            j.tr_active, j.thickness_um, j.diffusion_um, j.pixel_um)
    # the converter carries the tables (the bench state has none: it
    # takes the port's own absorption table)
    tc = CV.silicon_from_numpy(JS.SiliconParams.make(treering_model=model))
    np.testing.assert_array_equal(tc.abs_y, ta.y)


def _photons(rng, n, T, with_labs):
    x = rng.uniform(-5, W + 5, n).astype(np.float32)
    y = rng.uniform(-5, H + 5, n).astype(np.float32)
    cols = dict(x=x, y=y, flux=np.ones(n, np.float32),
                wavelength=rng.uniform(400, 1050, n).astype(np.float32),
                dxdz=rng.normal(0, 0.2, n).astype(np.float32),
                dydz=rng.normal(0, 0.2, n).astype(np.float32),
                pupil_u=np.zeros(n, np.float32),
                pupil_v=np.zeros(n, np.float32), time=np.zeros(n, np.float32))
    if with_labs:
        cols["abs_len"] = rng.uniform(0.5, 300, n).astype(np.float32)
    return JBatch(**{k: jnp.asarray(v) for k, v in cols.items()}), \
        TBatch(**{k: T(v) for k, v in cols.items()})


@pytest.mark.parametrize("rings", ["waves", "table", "off"])
@pytest.mark.parametrize("bf", [False, True])
def test_apply_silicon_displacements_matches_jax(sil, rings, bf):
    """The deterministic part with the JAX package's draws injected:
    depth (photons deeper than the device lost), travel, diffusion, the
    per-photon tree rings (analytic waves or the tabulated profile) and
    the BF gather.  Displacements to 1e-6 of their largest plus two f32
    ulps of the frame coordinate (the final adds round at the position's
    scale); flux exactly."""
    jsil, tsil = sil
    if rings == "table":
        jsil = JS.SiliconParams.make(treering_center=(-300.0, 150.0),
                                     treering_profile=0.2 * np.sin(
                                         np.linspace(0, 60, 2048)))
        tsil = CV.silicon_from_numpy(jsil)
    rng = np.random.default_rng(21)
    n = 50_000
    T = torch.as_tensor
    jph, tph = _photons(rng, n, T, with_labs=(rings == "waves"))
    disp = None
    if bf:
        disp = [rng.normal(0, 0.05, (H, W)).astype(np.float32)
                for _ in range(2)]
    key = jax.random.PRNGKey(4)
    want = JS.apply_silicon_displacements(
        key, jph, jsil, *(disp or (None, None)), treerings=rings != "off")
    k_z, k_d = jax.random.split(key)
    u = np.array(jax.random.uniform(k_z, (n,), minval=1e-7, maxval=1.0))
    g = np.array(jax.random.normal(k_d, (n, 2)))
    got = TS.apply_silicon_displacements(
        tph, tsil, (T(u), T(g[:, 0].copy()), T(g[:, 1].copy())),
        disp=None if disp is None else tuple(map(T, disp)),
        treerings=rings != "off")
    np.testing.assert_array_equal(got.flux.numpy(), np.asarray(want.flux))
    assert 0 < float(got.flux.sum()) < n      # some photons pass through
    for name in ("x", "y"):
        x0 = np.asarray(getattr(jph, name))
        w = np.asarray(getattr(want, name))
        d = getattr(got, name).numpy() - w
        bar = 1e-6 * np.abs(w - x0).max() + 2 * np.spacing(
            np.float32(np.abs(w).max()))
        assert np.abs(d).max() <= bar, (name, np.abs(d).max(), bar)


def _spot_photons(rng, n, T):
    """Two bright spots on a flat background, 620 nm (every photon
    converts in the 100 um device)."""
    cx = rng.choice([60.0, 180.0], n)
    spot = rng.uniform(size=n) < 0.8
    x = np.where(spot, cx + rng.normal(0, 1.5, n),
                 rng.uniform(-10, W + 10, n)).astype(np.float32)
    y = np.where(spot, 100 + rng.normal(0, 1.5, n),
                 rng.uniform(-10, H + 10, n)).astype(np.float32)
    z = np.zeros(n, np.float32)
    cols = dict(x=x, y=y, flux=np.full(n, 40.0, np.float32),
                wavelength=z + 620, dxdz=z, dydz=z, pupil_u=z, pupil_v=z,
                time=z)
    return JBatch(**{k: jnp.asarray(v) for k, v in cols.items()}), \
        TBatch(**{k: T(v) for k, v in cols.items()})


def _spot_moments(img, cx, r=8):
    box = img[100 - r:100 + r + 1, int(cx) - r:int(cx) + r + 1].astype(
        np.float64)
    yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
    w = box.sum()
    mx, my = (box * xx).sum() / w, (box * yy).sum() / w
    return mx, my, (box * ((xx - mx) ** 2 + (yy - my) ** 2)).sum() / w, w


@pytest.mark.parametrize("bf_mode", ["image", "photon"])
def test_accumulate_silicon_displaced_per_chunk_matches_jax(sil, bf_mode):
    """accumulate_silicon(pre_displaced=False) in both BF modes against
    the JAX package's: different draws, so statistically.  The image
    mode conserves the in-frame charge exactly (tally); the totals agree
    within 3 sqrt(photons) x 40 e- + 0.5% (edge losses); each spot's
    (16,000 photons) centroid and second moment <r^2> within 3 standard
    errors of the difference: sqrt(<r^2> / N) per coordinate and
    <r^2> sqrt(2 / N) (<r^2> of a 2-D Gaussian is exponential)."""
    jsil, tsil = sil
    rng = np.random.default_rng(9)
    n = 40_000
    T = torch.as_tensor
    jph, tph = _spot_photons(rng, n, T)
    jtr = JS.tree_ring_field(jsil, (H, W))
    ttr = TS.tree_ring_field(tsil, (H, W), "cpu")
    want = np.asarray(JS.accumulate_silicon(
        jax.random.PRNGKey(1), jph, jnp.zeros((H, W), jnp.float32), jsil,
        nsub=4, bf_mode=bf_mode, tr_field=jtr), np.float64)
    tally = {}
    image = torch.zeros((H, W))
    got = TS.accumulate_silicon(
        tph, image, tsil, nsub=4, tr_field=ttr, tally=tally,
        bf_mode=bf_mode, gen=torch.Generator().manual_seed(1)).numpy()
    got = got.astype(np.float64)
    assert float(image.abs().sum()) == 0.0    # the input is not written
    if bf_mode == "image":
        assert abs(got.sum() - float(tally["in_frame"])) <= 1e-5 * got.sum()
    assert abs(got.sum() - want.sum()) \
        <= 3 * 40 * np.sqrt(n) + 0.005 * want.sum()
    n_spot = 0.4 * n
    for cx in (60.0, 180.0):
        a, b = _spot_moments(got, cx), _spot_moments(want, cx)
        sig_c = np.sqrt(b[2] / n_spot)
        assert abs(a[0] - b[0]) <= 3 * sig_c and abs(a[1] - b[1]) <= 3 * sig_c
        assert abs(a[2] / b[2] - 1) <= 3 * np.sqrt(2 / n_spot), (a, b)


def test_accumulate_silicon_checks_its_mode():
    ph = TBatch(*[torch.zeros(8)] * 9)
    sil = TS.SiliconParams.make()
    img = torch.zeros((16, 16))
    with pytest.raises(ValueError, match="pre_displaced"):
        TS.accumulate_silicon(ph, img, sil, pre_displaced=True,
                              bf_mode="photon")
    with pytest.raises(ValueError, match="gen"):
        TS.accumulate_silicon(ph, img, sil)
    with pytest.raises(ValueError, match="bf_mode"):
        TS.accumulate_silicon(ph, img, sil, bf_mode="pixel",
                              gen=torch.Generator())
