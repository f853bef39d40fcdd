"""K4 and P1-P7 (the kernels of the on-chip probes) and the probe_rows
formulations: the port's plain twins against the JAX package and the JAX
probes, on the same seeded numpy inputs.

The Pallas probe bodies run as the JAX package's own tests run its
kernels on the CPU: each wrapped in a pallas_call with interpret=True and
the probe's specs, here over grid=(2,) (the first two row tiles of the
4096-wide frame)."""
import importlib.util
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from imsim_tpu.ops import scanrows as JSR
from imsim_tpu_torch.benchmarks import probe_pallas as TPA
from imsim_tpu_torch.benchmarks import probe_rows as TPR
from imsim_tpu_torch.ops import probes as TP
from imsim_tpu_torch.ops import scanrows as TSR

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the probes' stencil bodies sum k^2 = 81 f32 products in the same order
# as the twins; XLA on the CPU may contract a multiply-add into an FMA,
# one rounding less per tap: 81 * 2^-24 < 5e-6 of max |out|
STENCIL_REL = 5e-6


# ---- K4 ---------------------------------------------------------------------

def test_scan_lanes_plain_matches_pallas():
    """scan_lanes on (24, 4096): the port (plain twin on the CPU) against
    the Pallas kernel in interpret mode with block 1024.  f32 prefix sums
    of 0.01-scale deltas, 1000 nonzero per row in another summation
    order: 2e-6 absolute (the bar of K1's parity test)."""
    rng = np.random.default_rng(5)
    x = np.zeros((24, 4096), np.float32)
    cols = rng.integers(0, 4096, 1000)
    x[:, cols] = 0.01 * rng.normal(size=(24, 1000))
    want = np.asarray(JSR.scan_lanes(jnp.asarray(x), block=1024,
                                     interpret=True))
    got = TSR.scan_lanes(torch.as_tensor(x), block=1024).numpy()
    assert np.abs(got - want).max() < 2e-6
    assert np.abs(TSR.scan_lanes_plain(torch.as_tensor(x)).numpy()
                  - want).max() < 2e-6


def test_scan_lanes_rejects_ragged_rows_in_both_packages():
    x = np.zeros((3, 1000), np.float32)
    with pytest.raises(ValueError):
        JSR.scan_lanes(jnp.asarray(x), block=256, interpret=True)
    with pytest.raises(ValueError):
        TSR.scan_lanes(torch.as_tensor(x), block=256)
    with pytest.raises(ValueError):
        TSR.scan_lanes(torch.zeros(1024), block=256)


# ---- P1-P7 ------------------------------------------------------------------

def _load_probe(name):
    """A JAX probe module from benchmarks/ (it builds its 4096^2 frame at
    import)."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_probes():
    pa, pb = _load_probe("probe_pallas"), _load_probe("probe_pallas2")
    # body ke passes negative shifts to pltpu.roll, which this JAX
    # refuses at trace time; the same rotation by a non-negative shift
    roll = pltpu.roll
    pb.pltpu = types.SimpleNamespace(**{
        **vars(pltpu),
        "roll": lambda x, s, axis: roll(x, s % x.shape[axis], axis)})
    return pa, pb


@pytest.fixture(scope="module")
def frame(jax_probes):
    """The first two row tiles' worth of the probes' padded frame P
    (2 TH + k - 1, Wp), its image, and dkf (2, k*k), seeded."""
    pa, _ = jax_probes
    TH, W, k, R, Wp = pa.TH, pa.W, pa.k, pa.R, pa.Wp
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 1e5, (2 * TH + k - 1, W)).astype(np.float32)
    P = np.zeros((2 * TH + k - 1, Wp), np.float32)
    P[R:, R:R + W] = img[:2 * TH + k - 1 - R]
    dkf = rng.normal(size=(2, k * k)).astype(np.float32)
    return img[:2 * TH], P, dkf


def _pallas(pa, body, nout, smem=True, copy=False):
    """`body` in a pallas_call with the probe's specs over grid=(2,)."""
    TH, W, k, Wp = pa.TH, pa.W, pa.k, pa.Wp
    out_spec = pl.BlockSpec((TH, W), lambda t: (t, 0),
                            memory_space=pltpu.VMEM)
    out_shape = jax.ShapeDtypeStruct((2 * TH, W), jnp.float32)
    if copy:
        return pl.pallas_call(body, grid=(2,), in_specs=[out_spec],
                              out_specs=out_spec, out_shape=out_shape,
                              interpret=True)
    return pl.pallas_call(
        body, grid=(2,),
        in_specs=([pl.BlockSpec(memory_space=pltpu.SMEM)] if smem else [])
        + [pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=[out_spec] * nout if nout > 1 else out_spec,
        out_shape=[out_shape] * nout if nout > 1 else out_shape,
        scratch_shapes=[pltpu.VMEM((TH + k - 1, Wp), jnp.float32),
                        pltpu.SemaphoreType.DMA(())],
        interpret=True)


def _close(got, want, rel):
    got = got if isinstance(got, tuple) else (got,)
    want = [np.asarray(w) for w in (want if isinstance(want, (list, tuple))
                                    else (want,))]
    assert len(got) == len(want)
    scale = max(np.abs(w).max() for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= rel * scale


def test_p1_copy(jax_probes, frame):
    pa, _ = jax_probes
    img, _, _ = frame
    want = _pallas(pa, pa.copy_kernel, 1, copy=True)(jnp.asarray(img))
    _close(TP.probe_copy2(torch.as_tensor(img)), want, 0.0)


@pytest.mark.parametrize("name,body", [("p2", "dma_kernel"),
                                       ("p3", "smem_kernel"),
                                       ("p4", "sten1_kernel"),
                                       ("p5", "sten2_kernel")])
def test_p2_to_p5(jax_probes, frame, name, body):
    """P2, P3 exact (a copy; one product); P4, P5 within STENCIL_REL."""
    pa, _ = jax_probes
    _, P, dkf = frame
    Pt, dt = torch.as_tensor(P), torch.as_tensor(dkf)
    if name == "p2":
        want = _pallas(pa, pa.dma_kernel, 1, smem=False)(jnp.asarray(P))
        got = TP.probe_window(Pt, pa.k, pa.W)
    else:
        nout = 2 if name == "p5" else 1
        want = _pallas(pa, getattr(pa, body), nout)(jnp.asarray(dkf),
                                                     jnp.asarray(P))
        fn = dict(p3=TP.probe_window_tap, p4=TP.probe_stencil1,
                  p5=TP.probe_stencil2)[name]
        got = fn(dt, Pt, pa.W)
    _close(got, want, 0.0 if name in ("p2", "p3") else STENCIL_REL)


@pytest.mark.parametrize("body", TP.MK_BODIES + TP.MK2_BODIES)
def test_p6_p7_bodies(jax_probes, frame, body):
    """Each probe_pallas2 body (ka..kh: P6, one output; ki, kh2, kh3:
    P7, two) against the port: a, b exact, the rest within STENCIL_REL."""
    _, pb = jax_probes
    _, P, dkf = frame
    nout = 2 if body in TP.MK2_BODIES else 1
    want = _pallas(pb, getattr(pb, f"k{body}"), nout)(jnp.asarray(dkf),
                                                      jnp.asarray(P))
    fn = TP.probe_mk2 if nout == 2 else TP.probe_mk
    got = fn(body, torch.as_tensor(dkf), torch.as_tensor(P), pb.W)
    _close(got, want, 0.0 if body in ("a", "b") else STENCIL_REL)


# the bodies csrc/probes.cu sends to its vector copy kernel (one tap, one
# output), with the JAX probe (0: probe_pallas, 1: probe_pallas2) and
# body that compute them
ONE_TAP = {"p2": (0, "dma_kernel"), "p3": (0, "smem_kernel"),
           "a": (1, "ka"), "b": (1, "kb")}


def test_other_bodies_have_several_taps():
    """Every body but the one-tap ones takes the window-tap kernel."""
    for body in ("p4", "p5") + TP.MK_BODIES + TP.MK2_BODIES:
        if body in ONE_TAP:
            continue
        groups, _ = TP.body_taps(body, 9)
        assert sum(len(g) for g in groups) > 1, body


# every other body and the pattern kernel of csrc/probes.cu it takes
PATTERN_OF = {"p4": "full", "p5": "full", "c": "row", "d": "column",
              "e": "full", "f": "full", "g": "full", "h": "full",
              "i": "full", "h2": "full", "h3": "full"}


@pytest.mark.parametrize("k", [3, 5, 9])
@pytest.mark.parametrize("body", list(PATTERN_OF))
def test_body_pattern_weights_are_the_body_taps(body, k):
    """A body's pattern and canonical weights hold the body's own taps:
    for each output, the multiset {(di, dj, dkf[o, t])} of body_taps,
    so the kernel sums the same products (distinct random weights, so a
    misplaced one shows)."""
    rng = np.random.default_rng(k)
    dkf = rng.normal(size=(2, k * k)).astype(np.float32)
    groups, nout = TP.body_taps(body, k)
    pattern, weights = TP.body_pattern(body, dkf, k)
    assert pattern == PATTERN_OF[body]
    canon = TP.pattern_taps(pattern, k)
    assert weights.shape == (nout, len(canon))
    for o in range(nout):
        want = sorted((di, dj, float(dkf[o, t]))
                      for g in groups for di, dj, t in g)
        got = sorted((di, dj, float(wt))
                     for (di, dj), wt in zip(canon, weights[o]))
        assert got == want


@pytest.mark.parametrize("k", [3, 5, 9])
@pytest.mark.parametrize("body", list(PATTERN_OF))
def test_canonical_order_sum_matches_plain_twin(body, k):
    """The shifted-slice sum in the pattern's canonical order (what the
    pattern kernel computes; window_pattern_plain) equals the body's
    plain twin, which sums in the body's own order, within 1e-5 of max
    |out|: k^2 float32 terms in another order."""
    rng = np.random.default_rng(100 + k)
    h, w = 37, 50
    P = torch.as_tensor(rng.uniform(0, 1e5, (h + k - 1, w + k + 5))
                        .astype(np.float32))
    dkf = rng.normal(size=(2, k * k)).astype(np.float32)
    pattern, weights = TP.body_pattern(body, dkf, k)
    got = TP.window_pattern_plain(pattern, weights, P, k, w)
    want = TP.window_plain(body, torch.as_tensor(dkf), P, k, w)
    assert len(got) == len(want)
    scale = max(float(b.abs().max()) for b in want)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    assert err <= 1e-5 * scale


@pytest.mark.parametrize("taps,k", [
    ([(0, 0, 0), (0, 1, 1)], 9),                         # two taps
    ([(0, j, j) for j in range(8)], 9),                  # a row short of one
    ([(1, j, j) for j in range(9)], 9),                  # row 1, not row 0
    ([(i, 3, i) for i in range(9)], 9),                  # column 3, not R
    ([(0, j, j) for j in range(9)] + [(0, 0, 0)], 9),    # a repeated tap
    ([(0, j, None) for j in range(9)], 9),               # unweighted taps
    ([(i, j, 2 * i + j) for i in range(2) for j in range(2)], 2),  # even k
    ([(1, 1, 0)], 1),                                    # one tap
])
def test_tap_pattern_refuses_other_tap_lists(taps, k):
    """A tap list that is no pattern's is refused (there is no runtime
    tap-list kernel to take it)."""
    with pytest.raises(ValueError):
        TP.tap_pattern(taps, k)


@pytest.mark.parametrize("body", list(ONE_TAP))
def test_one_tap_bodies_bitwise(jax_probes, frame, body):
    """A one-tap body has one tap and one output (what sends it to the
    copy kernel), and its plain twin equals the JAX body bitwise: zeros
    inside the window and, for P3, a negative and a zero weight, so a
    -0 / +0 slip shows (a float comparison would not see it)."""
    groups, nout = TP.body_taps(body, 9)
    assert sum(len(g) for g in groups) == 1 and nout == 1
    which, name = ONE_TAP[body]
    reads_dk = body != "p2"
    mod = jax_probes[which]
    _, P, dkf = frame
    P = P.copy()
    R = mod.R
    P[R + 3, R:R + 300] = 0.0
    P[R + 5, R + 7:R + 90] = -0.0
    P[2, 1:200] = -0.0
    weights = (-abs(float(dkf[0, 0])), 0.0) if body == "p3" else (None,)
    for w00 in weights:
        dk = dkf.copy()
        if w00 is not None:
            dk[0, 0] = w00
        call = _pallas(mod, getattr(mod, name), 1, smem=reads_dk)
        want = np.asarray(call(jnp.asarray(dk), jnp.asarray(P)) if reads_dk
                          else call(jnp.asarray(P)))
        Pt, dt = torch.as_tensor(P), torch.as_tensor(dk)
        if body == "p2":
            got = TP.probe_window(Pt, mod.k, mod.W)
        elif body == "p3":
            got = TP.probe_window_tap(dt, Pt, mod.W)
        else:
            got = TP.probe_mk(body, dt, Pt, mod.W)
        assert got.shape == want.shape
        assert np.array_equal(got.numpy().view(np.int32),
                              want.view(np.int32)), (body, w00)


def test_probe_frame_matches_jax_probe(jax_probes):
    """make_frame builds the JAX probes' img, P and dkf
    (probe_pallas.py:35-40) at the same size."""
    pa, _ = jax_probes
    img, P, dkf = TPA.make_frame("cpu", pa.H, pa.W, pa.k, pa.TH)
    assert np.array_equal(img.numpy(), np.asarray(pa.img))
    assert np.array_equal(P.numpy(), np.asarray(pa.P))
    assert np.array_equal(dkf.numpy(), np.asarray(pa.dkflat))
    assert TP.frame_width(P, pa.k) == pa.W


# ---- probe_rows -------------------------------------------------------------

N, C, N_OBJ, NB = 65_536, 24, 512, 6


@pytest.fixture(scope="module")
def rows_data():
    return TPR.make_data("cpu", N, C, N_OBJ, NB)


def _jax_cases(params, starts):
    """The JAX probe's cases (benchmarks/probe_rows.py:58-167), rebuilt in
    jnp with the batch b and the uniform draw u given instead of drawn
    from a key; the Pallas scans in interpret mode."""
    deltas = params - jnp.concatenate([jnp.zeros((1, C), jnp.float32),
                                       params[:-1]])
    dT = deltas.T
    mp = N // 16

    def j0_of(b):
        return jnp.maximum(-((b - starts) // NB), 0).astype(jnp.int32)

    def lanes(x):
        return JSR.scan_lanes(x, block=1024, interpret=True)

    def relayout(rows):
        return rows.reshape(C, mp, 4, 4).transpose(0, 3, 2, 1).reshape(C, N)

    def sc_nc(b):
        return jnp.zeros((N, C), jnp.float32).at[j0_of(b)].add(
            deltas, mode="drop")

    def sc_cn(b):
        return jnp.zeros((C, N), jnp.float32).at[:, j0_of(b)].add(
            dT, mode="drop", indices_are_sorted=True)

    def first_cn(u):
        return jnp.zeros((C, N), jnp.float32).at[:, 0].add(dT[:, 0] + u)

    def slot(b):
        pair = share = 4
        pe = 16
        j0 = j0_of(b)
        mu = j0 % pe
        beta = (mu % pair) * share + (mu // pair)
        d = jnp.zeros((C, pe, mp), jnp.float32).at[:, beta, j0 // pe].add(
            dT, mode="drop")
        return JSR.scan_slot_prefix(d, pair, share, interpret=True)

    return {
        "scatter (N,C)": lambda b, u: sc_nc(b),
        "scatter (N,C) sorted-hint": lambda b, u: sc_nc(b),
        "scatter (C,N) sorted-hint": lambda b, u: sc_cn(b),
        "cumsum axis0 (N,C)": lambda b, u: jnp.cumsum(
            jnp.zeros((N, C), jnp.float32).at[0].add(deltas[0] + u), axis=0),
        "cumsum axis1 (C,N)": lambda b, u: jnp.cumsum(first_cn(u), axis=1),
        "K4 scan (C,N)": lambda b, u: lanes(first_cn(u)),
        "relayout pe=16 (C,N)": lambda b, u: relayout(
            jnp.broadcast_to(dT[:, :1] + u[0], (C, N))),
        "FULL current (N,C)": lambda b, u: jnp.cumsum(sc_nc(b), axis=0)
        .reshape(mp, 4, 4, C).transpose(2, 1, 0, 3).reshape(N, C),
        "FULL transposed+K4": lambda b, u: relayout(lanes(sc_cn(b))),
        "FULL transposed+cumsum": lambda b, u: relayout(
            jnp.cumsum(sc_cn(b), axis=1)),
        "FULL transposed no-scan": lambda b, u: relayout(sc_cn(b)),
        "FULL transposed no-relayout": lambda b, u: lanes(sc_cn(b)),
        "FULL slot-plane kernel (K1)": lambda b, u: slot(b),
    }


def _undo_relayout(x):
    """Inverse of relayout_cn: x[c, a2*4*mp + a1*mp + m] back to
    [c, 16*m + 4*a1 + a2]."""
    c, n = x.shape
    return x.reshape(c, 4, 4, n // 16).permute(0, 3, 2, 1).reshape(c, n)


def _rows_of(name, out):
    """(C, N) per-photon rows from a case output, or None where the case
    holds no rows of this batch (its input is the first row alone)."""
    if name.startswith(("cumsum", "K4 scan", "relayout")):
        return None
    if name == "FULL slot-plane kernel (K1)":
        order = list(TSR.beta_order(4, 4))
        return out[:, order, :].transpose(1, 2).reshape(C, N)
    x = out.T if "(N,C)" in name else out
    if "FULL" in name and "no-relayout" not in name:
        if "(N,C)" in name:
            x = _undo_relayout(out.T.contiguous())
        else:
            x = _undo_relayout(out)
    if name.startswith("scatter") or name == "FULL transposed no-scan":
        x = torch.cumsum(x, dim=1)
    return x


def test_rows_data_matches_jax_probe():
    """make_data draws the JAX probe's params and counts
    (probe_rows.py:36-40) from default_rng(0)."""
    rng = np.random.default_rng(0)
    params = np.asarray(jnp.asarray(rng.normal(size=(N_OBJ, C)),
                                    jnp.float32))
    counts = rng.multinomial(N - N_OBJ, np.ones(N_OBJ) / N_OBJ) + 1
    cum = np.cumsum(counts).astype(np.int32)
    d = TPR.make_data("cpu", N, C, N_OBJ, NB)
    assert np.array_equal(d.params.numpy(), params)
    assert np.array_equal(d.starts.numpy()[1:], cum[:-1])
    assert d.starts[0] == 0


@pytest.mark.parametrize("b", [0, 5])
def test_probe_rows_cases_match_jax_and_gather(rows_data, b):
    """Every probe_rows case (the fused one excepted: the JAX package has
    no scan_lanes_relayout) equals the JAX formulation on the same b and
    u, and where it holds this batch's rows they equal the direct gather
    params[object of photon].  f32 prefix sums over n_obj deltas in
    different orders: sqrt(n_obj) ulps of the parameters' scale."""
    params = jnp.asarray(rows_data.params.numpy())
    starts = jnp.asarray(rows_data.starts.numpy().astype(np.int32))
    jcases = _jax_cases(params, starts)
    u = np.random.default_rng(9).uniform(size=C).astype(np.float32)
    ut = torch.as_tensor(u)
    gather = TPR.gather_rows(rows_data, b).T
    scale = float(rows_data.params.abs().max()) + 1.0
    tol = np.sqrt(N_OBJ) * np.spacing(np.float32(scale))
    names = [name for name, _ in TPR.cases(rows_data)]
    assert names == list(jcases)
    for name, fn in TPR.cases(rows_data):
        out = fn(b, ut)
        want = np.asarray(jcases[name](b, jnp.asarray(u)))
        assert tuple(out.shape) == want.shape, name
        assert np.abs(out.numpy() - want).max() <= tol, name
        rows = _rows_of(name, out)
        if rows is None:
            # these cases scan the first row alone: every photon holds it
            first = rows_data.deltasT[:, :1] + (
                ut[0] if name.startswith("relayout") else ut[:, None])
            held = out if out.shape[0] == C else out.T
            assert float((held - first).abs().max()) <= tol, name
        else:
            assert float((rows - gather).abs().max()) <= tol, name
