"""K1's plain twin and the pooled bookkeeping around it against the JAX
package: scan_slot_prefix (Pallas, interpret mode), materialize_rows,
the photon->object map, and the batch sizing (align_batch, slot_blkq,
pooled_plan, pick_nbatch, member_offsets)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imsim_tpu.image import photon_pooling as JPP
from imsim_tpu.ops import scanrows as JSR
from imsim_tpu_torch.image import photon_pooling as TPP
from imsim_tpu_torch.ops import scanrows as TSR

torch.set_num_threads(1)

LAYOUTS = ((1, 1), (2, 2), (4, 1), (4, 4))


def _deltas_case(pair, share, b, mp=1024, C=6, nb=3, seed=11):
    """Random per-object counts (with empty objects and one object
    spanning many lanes) and the slot-layout delta scatter of batch b,
    built in numpy exactly as materialize_rows_T scatters it."""
    rng = np.random.default_rng(seed)
    pe = pair * share
    bs = pe * mp
    counts = rng.integers(0, 9, 4096)
    counts[7] = 0
    counts[100] = 2000
    cum = np.cumsum(counts).astype(np.int32)
    params = (rng.normal(size=(4096, C)) * 0.01).astype(np.float32)
    starts = np.concatenate([[0], cum[:-1]])
    j0 = np.maximum(-((b - starts) // nb), 0)
    deltasT = (params - np.concatenate(
        [np.zeros((1, C), np.float32), params[:-1]])).T
    keep = j0 // pe < mp
    mu = j0[keep] % pe
    beta = (mu % pair) * share + (mu // pair)
    d = np.zeros((C, pe, mp), np.float32)
    np.add.at(d, (slice(None), beta, j0[keep] // pe), deltasT[:, keep])
    return d, params, cum, nb, bs


@pytest.mark.parametrize("pair,share", LAYOUTS)
def test_scan_slot_prefix_plain_matches_pallas(pair, share):
    """Plain twin == the Pallas kernel (interpret mode) on the same
    deltas, both f32 prefix sums over <= 4096 objects: 2e-6 absolute on
    0.01-scale parameters (the JAX package's own bar)."""
    for b in (0, 2):
        d, *_ = _deltas_case(pair, share, b)
        want = np.asarray(JSR.scan_slot_prefix(
            jnp.asarray(d), pair, share, blkq=256, interpret=True))
        got = TSR.scan_slot_prefix(torch.as_tensor(d), pair, share).numpy()
        assert np.abs(got - want).max() < 2e-6


@pytest.mark.parametrize("pair,share", LAYOUTS)
def test_materialize_rows_T_matches_jax(pair, share):
    """The port's scatter + K1 rows == JAX materialize_rows(...).T, and
    the port's plain materialize_rows == the JAX one."""
    for b in (0, 2):
        _, params, cum, nb, bs = _deltas_case(pair, share, b)
        want = np.asarray(JPP.materialize_rows(
            jnp.asarray(params), jnp.asarray(cum), jnp.int32(b), nb, bs,
            pair, share))
        P, Cm = torch.as_tensor(params), torch.as_tensor(cum)
        got_T = TPP.materialize_rows_T(P, Cm, b, nb, bs, pair, share)
        got = TPP.materialize_rows(P, Cm, b, nb, bs, pair, share)
        assert np.abs(got_T.numpy().T - want).max() < 2e-6
        assert np.abs(got.numpy() - want).max() < 2e-6


@pytest.mark.parametrize("pair,share", LAYOUTS)
def test_obj_map_matches_jax(pair, share):
    """build_obj_map / batch_from_obj_map: identical photon->object
    assignment and alive masks."""
    _, _, cum, nb, bs = _deltas_case(pair, share, 0, mp=512)
    total = int(min(cum[-1], bs * nb - 5))
    jmap = JPP.build_obj_map(jnp.asarray(cum), jnp.int32(total), nb, bs,
                             pair, share)
    tmap = TPP.build_obj_map(torch.as_tensor(cum), total, nb, bs, pair,
                             share)
    assert (tmap.numpy() == np.asarray(jmap)).all()
    for b in range(nb):
        jo, jw = JPP.batch_from_obj_map(jmap, jnp.int32(total), b, nb, bs,
                                        pair, share)
        to, tw = TPP.batch_from_obj_map(tmap, total, b, nb, bs, pair, share)
        assert (to.numpy() == np.asarray(jo)).all()
        assert (tw.numpy() == np.asarray(jw)).all()


def test_batch_sizing_matches_jax():
    """align_batch, slot_blkq, member_offsets, pick_nbatch and
    pooled_plan are copies: equal to the JAX functions."""
    for pe in (1, 2, 4, 16, 32, 64):
        assert TSR.slot_blkq(pe) == JSR.slot_blkq(pe)
    for bs in (50_000, 262_160, 1_112_352, 18_666_672, 1 << 20):
        for pair, share in ((1, 1), (4, 1), (4, 4), (4, 8)):
            assert TSR.align_batch(bs, pair, share) == \
                JSR.align_batch(bs, pair, share)
    for pair, share in ((1, 1), (2, 3), (4, 4)):
        assert (TPP.member_offsets(pair, share)
                == JPP.member_offsets(pair, share)).all()
        assert TSR.beta_order(pair, share) == tuple(
            (mu % pair) * share + (mu // pair) for mu in range(pair * share))

    from imsim_tpu.image.scene import SceneHost as JHost

    rng = np.random.default_rng(3)
    for total_scale, nbatch in ((1e5, 4), (7.2e7, 6), (3e3, 8)):
        n = 300
        flux = np.round(rng.uniform(0, 2, n) * total_scale / n)
        scene = type("S", (), {"n": 512})()
        jhost = JHost(scene=scene, flux=flux, nominal_flux=flux, n_objects=n)
        modes = np.where(rng.uniform(size=n) < 0.1, JPP.FFT, JPP.PHOT)
        jcfg = JPP.PoolingConfig(nbatch=nbatch, batch_size=30_000_000,
                                 pupil_pairing=4, screen_share=4)
        tcfg = TPP.PoolingConfig(nbatch=nbatch, batch_size=30_000_000,
                                 pupil_pairing=4, screen_share=4)
        jc, jt, jnb, jbs = JPP.pooled_plan(jhost, modes, jcfg)
        tc, tt, tnb, tbs = TPP.pooled_plan(jhost, modes, tcfg)
        assert (jc == tc).all() and (jt, jnb, jbs) == (tt, tnb, tbs)
        assert TPP.pick_nbatch(jt, tcfg) == JPP.pick_nbatch(jt, jcfg)


def test_scan_slot_prefix_rejects_bad_layout():
    d = torch.zeros((2, 4, 8))
    with pytest.raises(ValueError):
        TSR.scan_slot_prefix(d, 4, 4)
