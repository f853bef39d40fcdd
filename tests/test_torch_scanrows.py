"""K1's plain twin and the pooled bookkeeping around it against the JAX
package: scan_slot_prefix (Pallas, interpret mode), materialize_rows,
the photon->object map, and the batch sizing (align_batch, slot_blkq,
pooled_plan, pick_nbatch, member_offsets); and the serial look-back
that K1 and K4 rest on (csrc/scanrows.cu), replayed in numpy float32."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

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


# the look-back window of csrc/scanrows.cu (one warp's lanes)
LOOKBACK_WINDOW = 32


def _chained_prefixes(aggs):
    """The chained scan of the tiles' aggregates: P_i = fl(P_{i-1} + a_i),
    P_{-1} = 0, in float32."""
    out = np.empty_like(aggs)
    acc = np.float32(0.0)
    for i, a in enumerate(aggs):
        acc = np.float32(acc + a)
        out[i] = acc
    return out


def _replay_lookback(aggs, pick):
    """Replay csrc/scanrows.cu's look-back over the tiles of one row in an
    order that `pick(n)` (an index below n) chooses step by step: each step
    either publishes a waiting tile's aggregate or completes the look-back
    of a tile whose window holds an inclusive prefix P_j with every tile
    after j published.  Completing folds serially, oldest first:
    excl = fl(...fl(P_j + a_{j+1})... + a_{i-1}), P_i = fl(excl + a_i).
    Returns the published prefixes."""
    n = len(aggs)
    flag = np.zeros(n, np.int8)         # 0 none, 1 aggregate, 2 prefix
    word = np.zeros(n, np.float32)
    while (flag < 2).any():
        ready = []
        for i in range(n):
            if flag[i] == 0 and i > 0:
                ready.append(("aggregate", i, None))
            if flag[i] == 2 or (i > 0 and flag[i] == 0):
                continue
            lo = max(i - LOOKBACK_WINDOW, 0)
            near = [j for j in range(i - 1, lo - 1, -1) if flag[j] == 2]
            if i == 0:
                ready.append(("prefix", 0, None))
            elif near and (flag[near[0] + 1:i] > 0).all():
                ready.append(("prefix", i, near[0]))
        kind, i, j = ready[pick(len(ready))]
        if kind == "aggregate":
            flag[i], word[i] = 1, aggs[i]
            continue
        excl = np.float32(0.0)
        if j is not None:
            excl = word[j]
            for k in range(j + 1, i):
                excl = np.float32(excl + word[k])
        flag[i], word[i] = 2, np.float32(excl + aggs[i])
    return word


@settings(max_examples=150, deadline=None, database=None)
@given(aggs=st.lists(st.floats(width=32, allow_nan=False,
                               allow_infinity=False),
                     min_size=1, max_size=90),
       data=st.data())
def test_serial_lookback_gives_the_chained_scans_bits(aggs, data):
    """Whichever predecessors have published their inclusive prefix when
    a tile looks back, folding serially from the nearest one gives every
    tile the chained scan's prefix bit for bit, so K1's (and K4's) output
    cannot depend on the order in which tiles ran."""
    aggs = np.asarray(aggs, np.float32)
    got = _replay_lookback(
        aggs, lambda n: data.draw(st.integers(0, n - 1)))
    want = _chained_prefixes(aggs)
    assert (got.view(np.uint32) == want.view(np.uint32)).all()

