"""The port's CUDA kernels against their plain twins at modest shapes.

These need an NVIDIA card (marker `cuda`); they skip elsewhere.  On the
card: python -m pytest tests/test_torch_cuda.py -q -p no:randomly
(chip_smoke.py runs the same comparisons at the main path's shapes)."""
import ctypes
import dataclasses
import functools

import numpy as np
import pytest
import torch

from imsim_tpu_torch.benchmarks import chain_random
from imsim_tpu_torch.benchmarks._util import conv2d_fp32
from imsim_tpu_torch.benchmarks.probe_pallas import make_frame
from imsim_tpu_torch.convert import load_ccd_state
from imsim_tpu_torch.ops import _build, probes, raychain, scanrows, stencil
from imsim_tpu_torch.sensor.silicon import bf_taps


@pytest.fixture
def cuda():
    # decided here, never at import time: every xdist worker must
    # collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pair,share,mp", [
    (1, 1, 5000), (4, 4, 70_001), (4, 8, 3000),
    # pe = 1, 2, 64: tiles of 16,384, 8,192 and 256 columns, ragged mp
    (1, 1, 100_003), (2, 1, 100_003), (8, 8, 100_003), (8, 8, 65_536)])
def test_scan_slot_prefix_kernel(cuda, pair, share, mp):
    """Any mp (ragged tail included) and any pe <= 64: f32 prefix sums of
    0.01-scale deltas, 2000 nonzero per column set -> 1e-5 absolute."""
    g = torch.Generator(device=cuda).manual_seed(1)
    pe = pair * share
    d = torch.zeros((7, pe, mp), device=cuda)
    idx = torch.randint(0, pe * mp, (2000,), generator=g, device=cuda)
    d.view(7, -1)[:, idx] = 0.01 * torch.randn((7, 2000), generator=g,
                                               device=cuda)
    n0 = _build.LAUNCHES["scan_slot_prefix"]
    got = scanrows.scan_slot_prefix(d, pair, share)
    want = scanrows.scan_slot_prefix_plain(d, pair, share)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["scan_slot_prefix"] == n0 + 1
    assert float((got - want).abs().max()) < 1e-5


def _slot_deltas(cuda, C, pair, share, mp, n_obj, seed):
    """d (C, pe, mp) with n_obj standard normal deltas a row, scattered
    over the row's slots."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    pe = pair * share
    d = torch.zeros((C, pe * mp), device=cuda)
    idx = torch.randint(0, pe * mp, (n_obj,), generator=g, device=cuda)
    d[:, idx] = torch.randn((C, n_obj), generator=g, device=cuda)
    return d.reshape(C, pe, mp)


def _slot_row_bar(want, n_obj):
    """sqrt(n_obj) float32 ulps of each row's scale."""
    return _row_bar(want.reshape(want.shape[0], -1), n_obj)


# K1's tile at pe = 16: 1,024 columns.  Long rows: 2,048 whole tiles, and
# 1,999 with a ragged, odd tail (mp % 4 != 0: the scalar path)
K1_TILE_16 = 1024
K1_LONG = (K1_TILE_16 * 2048, K1_TILE_16 * 1999 + 1235)


@pytest.mark.cuda
def test_scan_slot_prefix_repeats_bitwise(cuda):
    """The look-back folds its predecessors serially, oldest first, so K1
    repeats bit for bit: five calls back to back and two calls on two
    streams all equal the first call bitwise (on 100,000 normal deltas a
    row, whose sums round in every tile)."""
    d = _slot_deltas(cuda, 24, 4, 4, K1_TILE_16 * 700 + 64, 100_000, 5)
    first = scanrows.scan_slot_prefix(d, 4, 4)
    again = [scanrows.scan_slot_prefix(d, 4, 4) for _ in range(5)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            again.append(scanrows.scan_slot_prefix(d, 4, 4))
    for s in streams:
        torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    for i, out in enumerate(again):
        assert torch.equal(out, first), i


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 24])
@pytest.mark.parametrize("mp", K1_LONG)
def test_scan_slot_prefix_long_lookback_chain(cuda, C, mp):
    """K1 over rows of 2,000+ tiles (a long look-back chain): 2000
    standard normal deltas a row, each row within sqrt(2000) ulps of its
    scale of the plain twin, one launch."""
    d = _slot_deltas(cuda, C, 4, 4, mp, 2000, mp % 1000 + C)
    n0 = _build.LAUNCHES["scan_slot_prefix"]
    got = scanrows.scan_slot_prefix_cuda(d, 4, 4)
    want = scanrows.scan_slot_prefix_plain(d, 4, 4)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["scan_slot_prefix"] == n0 + 1
    gap = (got - want).reshape(C, -1).abs().amax(dim=1).cpu().numpy()
    assert (gap <= _slot_row_bar(want, 2000)).all(), gap


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 24])
@pytest.mark.parametrize("mp", [K1_TILE_16 * 500, K1_TILE_16 * 500 - 3])
def test_scan_slot_prefix_constant_exact(cuda, C, mp):
    """Constant rows of small integers over 500 tiles (whole, and a ragged
    odd tail): every partial sum is an integer below 2^24, exact in any
    order, so K1 equals the prefix in ordinal order bitwise."""
    pair, share = 4, 4
    pe = pair * share
    v = torch.arange(C, device=cuda, dtype=torch.float32) % 2 + 1
    d = v[:, None, None].expand(C, pe, mp).contiguous()
    got = scanrows.scan_slot_prefix_cuda(d, pair, share)
    beta = scanrows.beta_order(pair, share)
    mu = torch.empty(pe, device=cuda)
    mu[list(beta)] = torch.arange(pe, device=cuda, dtype=torch.float32)
    q = torch.arange(mp, device=cuda, dtype=torch.float32)
    want = v[:, None, None] * (pe * q[None, None, :] + mu[None, :, None]
                               + 1)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_scan_slot_prefix_refuses_wide_layouts(cuda):
    """pe > 64 raises before any launch."""
    d = torch.zeros((2, 65, 128), device=cuda)
    n0 = _build.LAUNCHES["scan_slot_prefix"]
    with pytest.raises(ValueError):
        scanrows.scan_slot_prefix(d, 65, 1)
    assert _build.LAUNCHES["scan_slot_prefix"] == n0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 9])
def test_stencil_pair_kernel(cuda, k):
    g = torch.Generator(device=cuda).manual_seed(2)
    img = torch.rand((301, 517), generator=g, device=cuda) * 1e5
    kx = torch.randn((k, k), generator=g, device=cuda) * 1e-6
    ky = torch.randn((k, k), generator=g, device=cuda) * 1e-6
    got = stencil.stencil_pair(img, kx, ky)
    want = stencil.stencil_pair_plain(img, kx, ky)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def _stencil_gap(got, want):
    return max(float((a - b).abs().max()) / float(b.abs().max())
               for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("k", stencil.CUDA_TAP_SIZES)
@pytest.mark.parametrize("H,W,offset", [
    (301, 517, 0),     # ragged 64 x 64 tiles, W % 4 != 0: scalar path
    (128, 192, 0),     # whole tiles, W % 4 == 0: 16-byte path
    (130, 4100, 0),    # W % 4 == 0, ragged tiles: 16-byte path
    (67, 260, 1),      # W % 4 == 0 but the base off 16 bytes: scalar
    (1, 777, 0),       # one row
    (523, 1, 0),       # one column
])
def test_stencil_pair_kernel_shapes(cuda, k, H, W, offset):
    """Every instantiated k on frames that are not whole tiles or rows
    of float4s, a 1-row and a 1-column frame: within 1e-5 of max |out|
    of the twin (the same (i, j) FMA order), one launch per call."""
    g = torch.Generator(device=cuda).manual_seed(k * 100 + H)
    buf = torch.rand(H * W + offset, generator=g, device=cuda) * 1e5
    img = buf[offset:].view(H, W)
    kx = torch.randn((k, k), generator=g, device=cuda).cpu() * 1e-6
    ky = torch.randn((k, k), generator=g, device=cuda).cpu() * 1e-6
    n0 = _build.LAUNCHES["stencil_pair"]
    got = stencil.stencil_pair(img, kx, ky)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["stencil_pair"] == n0 + 1
    assert _stencil_gap(got, stencil.stencil_pair_plain(img, kx, ky)) \
        <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 9, 11])
def test_stencil_pair_conv2d_yardstick(cuda, k):
    """The yardstick chip_smoke.py times beside K3 (one float32 conv2d,
    TF32 off, both tap sets as channels) computes the twin's function to
    1e-5 of max |out|, and leaves cuDNN's TF32 setting as it found it."""
    g = torch.Generator(device=cuda).manual_seed(k)
    img = torch.rand((301, 517), generator=g, device=cuda) * 1e5
    kx, ky = (torch.randn((k, k), generator=g, device=cuda) * 1e-6
              for _ in range(2))
    before = torch.backends.cudnn.allow_tf32
    out = conv2d_fp32(img[None, None], torch.stack([kx, ky])[:, None],
                      padding=k // 2)[0]
    assert torch.backends.cudnn.allow_tf32 == before
    assert _stencil_gap(out.unbind(0),
                        stencil.stencil_pair_plain(img, kx, ky)) <= 1e-5


@pytest.mark.cuda
def test_stencil_pair_bench_taps(cuda):
    st = load_ccd_state(device=cuda)
    img = torch.rand((4004, 4096), device=cuda) * 1e5
    dkx, dky = bf_taps(st.silicon)
    for a, b in zip(stencil.stencil_pair(img, dkx, dky),
                    stencil.stencil_pair_plain(img, dkx, dky)):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_field_to_sensor_kernel(cuda, fused):
    st = load_ccd_state(device=cuda)
    n = 1 << 20
    g = torch.Generator(device=cuda).manual_seed(3)
    u = lambda lo, hi: torch.rand(n, generator=g, device=cuda) * (hi - lo) \
        + lo  # noqa: E731
    r = torch.sqrt(u(2.558**2, 4.18**2))
    a = u(0, 2 * np.pi)
    args = (u(-0.0025, 0.0025), u(-0.0025, 0.0025), r * torch.cos(a),
            r * torch.sin(a), u(552, 691), u(0, 30),
            torch.ones(n, device=cuda),
            torch.randn(n, generator=g, device=cuda))
    kw = {}
    if fused:
        kw = dict(silicon=st.silicon,
                  si_draws=(u(1e-7, 1), torch.randn(n, generator=g,
                                                    device=cuda),
                            torch.randn(n, generator=g, device=cuda)))
    got = raychain.field_to_sensor(st.tel, st.ctx, *args, **kw)
    want = raychain.field_to_sensor_plain(st.tel, st.ctx, *args, **kw)
    torch.cuda.synchronize()
    gaps = raychain.chain_gaps(want, got, st.ctx, *args[2:6], args[7])
    assert raychain.gaps_ok(gaps, fused), gaps


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("off", [None, "apply_dcr", "apply_diffraction",
                                 "field_rotation"])
def test_field_to_sensor_kernel_forms(cuda, fused, off):
    """n = 1,000,003 (not a multiple of the block or of the photons per
    thread), each stage flag off in turn, both forms: within the chain's
    bar of the twin (ops/raychain.gaps_ok), one launch per call."""
    st = load_ccd_state(device=cuda)
    n = 1_000_003
    args, draws = chain_random.photons(n, 5, cuda)
    kw = dict(apply_dcr=True, apply_diffraction=True, field_rotation=True)
    if off:
        kw[off] = False
    if fused:
        kw.update(silicon=st.silicon, si_draws=draws)
    n0 = _build.LAUNCHES["field_to_sensor"]
    got = raychain.field_to_sensor(st.tel, st.ctx, *args, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["field_to_sensor"] == n0 + 1
    assert all(tuple(o.shape) == (n,) for o in got)
    want = raychain.field_to_sensor_plain(st.tel, st.ctx, *args, **kw)
    gaps = raychain.chain_gaps(
        want, got, st.ctx, *args[2:6], args[7],
        apply_diffraction=kw["apply_diffraction"],
        field_rotation=kw["field_rotation"])
    assert raychain.gaps_ok(gaps, fused), gaps


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 77, 129, 300])
def test_field_to_sensor_kernel_ragged_tail(cuda, n):
    """A batch shorter than a block, or ending inside one: each photon's
    outputs equal those of the same photon in a 4,096-photon batch
    (bitwise: the same thread and photon slot computes it), and nothing
    is written past n."""
    st = load_ccd_state(device=cuda)
    args, draws = chain_random.photons(4096, 6, cuda)
    kw = dict(silicon=st.silicon)
    big = raychain.field_to_sensor(st.tel, st.ctx, *args, **kw,
                                   si_draws=draws)
    small = raychain.field_to_sensor(
        st.tel, st.ctx, *(a[:n].contiguous() for a in args), **kw,
        si_draws=tuple(d[:n].contiguous() for d in draws))
    torch.cuda.synchronize()
    for a, b in zip(small, big):
        assert tuple(a.shape) == (n,)
        assert torch.equal(a.view(torch.int32), b[:n].view(torch.int32))


@pytest.mark.cuda
def test_field_to_sensor_random_photons_beyond_bar_only_at_ties(cuda):
    """The bench batch's 18.68 M photons drawn uniformly
    (benchmarks/chain_random), both forms: the kernel meets the chain's
    bar (ops/raychain.gaps_ok), which holds the photons at a tie between
    two spider edges to three of their kicks, so every photon past
    0.35 px away from the edges sits at such a tie."""
    for form, r in chain_random.main(cuda, log=lambda *_: None).items():
        assert r["ok"], (form, r)


@pytest.mark.cuda
def test_kernels_reject_bad_inputs(cuda):
    st = load_ccd_state(device=cuda)
    with pytest.raises(ValueError):
        stencil.stencil_pair(torch.zeros((8, 8), device=cuda,
                                         dtype=torch.float64),
                             *bf_taps(st.silicon))
    with pytest.raises(ValueError):
        scanrows.scan_slot_prefix(
            torch.zeros((2, 16, 8), device=cuda).transpose(0, 2)
            .contiguous().transpose(0, 2), 4, 4)
    ctx = dataclasses.replace(st.ctx)
    x = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError):
        raychain.field_to_sensor(st.tel, ctx, x, x, x, x, x, x, x,
                                 torch.zeros(7, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("C,N,block", [(3, 5000, 1000), (5, 3072, 1024),
                                       (24, 1 << 20, 16_384)])
def test_scan_lanes_kernel(cuda, C, N, block):
    """K4 at row lengths shorter than its 16,384-column tile (one ragged
    tile) and of whole tiles: f32 prefix sums of 0.01-scale deltas, 2000
    nonzero per row -> 1e-5 absolute."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.zeros((C, N), device=cuda)
    idx = torch.randint(0, N, (2000,), generator=g, device=cuda)
    x[:, idx] = 0.01 * torch.randn((C, 2000), generator=g, device=cuda)
    n0 = _build.LAUNCHES["scan_lanes"]
    got = scanrows.scan_lanes(x, block=block)
    want = scanrows.scan_lanes_plain(x)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["scan_lanes"] == n0 + 1
    assert float((got - want).abs().max()) < 1e-5
    with pytest.raises(ValueError):
        scanrows.scan_lanes(x[:, :N - 1].contiguous(), block=block)


# K4's tile: 16,384 columns.  Long rows: 2,048 whole tiles, and 2,000
# with a ragged, odd tail (N % 4 != 0: the scalar path)
K4_TILE = 16_384
LONG_ROWS = (K4_TILE * 2048, K4_TILE * 1999 + 1235)


def _row_bar(want, n_obj):
    """sqrt(n_obj) float32 ulps of each row's scale (probe_rows' bar)."""
    scale = want.abs().amax(dim=1).cpu().numpy().astype(np.float32)
    return np.sqrt(n_obj) * np.spacing(scale)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 24])
@pytest.mark.parametrize("N", LONG_ROWS)
def test_scan_lanes_long_lookback_chain(cuda, C, N):
    """K4 over rows of 2,000+ tiles (a long look-back chain): 2000
    standard normal deltas per row scattered over the row, each row
    within sqrt(2000) ulps of its scale of torch.cumsum."""
    g = torch.Generator(device=cuda).manual_seed(N % 1000 + C)
    x = torch.zeros((C, N), device=cuda)
    idx = torch.randint(0, N, (2000,), generator=g, device=cuda)
    x[:, idx] = torch.randn((C, 2000), generator=g, device=cuda)
    n0 = _build.LAUNCHES["scan_lanes"]
    got = scanrows.scan_lanes_cuda(x)
    want = scanrows.scan_lanes_plain(x)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["scan_lanes"] == n0 + 1
    gap = (got - want).abs().amax(dim=1).cpu().numpy()
    assert (gap <= _row_bar(want, 2000)).all(), gap


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 24])
@pytest.mark.parametrize("N", [K4_TILE * 1024, K4_TILE * 1024 - 3])
def test_scan_lanes_constant_rows_exact(cuda, C, N):
    """Constant rows of small integers over 1,024 tiles (whole, and a
    ragged odd tail): every partial sum is an integer of at most 2^24,
    exact in any order, so K4 equals the prefix bitwise."""
    x = (torch.arange(C, device=cuda, dtype=torch.float32)[:, None] % 2
         + 1).expand(C, N).contiguous()
    got = scanrows.scan_lanes_cuda(x)
    want = x[:, :1] * torch.arange(1, N + 1, device=cuda,
                                   dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_scan_lanes_back_to_back_and_two_streams(cuda):
    """Calls that overlap share no tile state: two calls back to back on
    one stream, then two on two streams, each on its own constant rows
    (exact prefixes), all equal to their prefixes bitwise."""
    C, N = 3, K4_TILE * 150 + 4
    xs = [torch.full((C, N), float(v), device=cuda) for v in (1, 2, 3, 4)]
    ramp = torch.arange(1, N + 1, device=cuda, dtype=torch.float32)
    got = [scanrows.scan_lanes_cuda(xs[0]), scanrows.scan_lanes_cuda(xs[1])]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s, x in zip(streams, xs[2:]):
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            got.append(scanrows.scan_lanes_cuda(x))
    torch.cuda.synchronize()
    for v, out in zip((1, 2, 3, 4), got):
        assert torch.equal(out, (v * ramp).expand(C, N)), v


@pytest.mark.cuda
def test_scan_lanes_repeats_bitwise(cuda):
    """K4 shares K1's serial look-back, so its bits repeat too: five
    calls back to back and one on a second stream equal the first."""
    x = torch.randn((24, K4_TILE * 300 + 8),
                    generator=torch.Generator(device=cuda).manual_seed(9),
                    device=cuda)
    first = scanrows.scan_lanes_cuda(x)
    again = [scanrows.scan_lanes_cuda(x) for _ in range(5)]
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        again.append(scanrows.scan_lanes_cuda(x))
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    for i, out in enumerate(again):
        assert torch.equal(out, first), i


def _outputs(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.cuda
@pytest.mark.parametrize("k,h,w,th", [(9, 256, 384, 128), (3, 200, 300, 8)])
def test_probe_kernels(cuda, k, h, w, th):
    """P1-P7 against their plain twins, on whole and ragged 64 x 64 tiles:
    the copies and one-tap windows exact, the stencils within 1e-5 of
    max |out| (f32 sums of k^2 terms in the same order, FMA-contracted),
    one launch on each kernel's own counter per call."""
    img, P, dkf = make_frame(cuda, h, w, k, th)
    runs = [
        ("probe_p1", 0.0, lambda: probes.probe_copy2(img),
         lambda: probes.probe_copy2_plain(img)),
        ("probe_p2", 0.0, lambda: probes.probe_window(P, k, w),
         lambda: probes.probe_window_plain(P, k, w)),
        ("probe_p3", 0.0, lambda: probes.probe_window_tap(dkf, P, w),
         lambda: probes.probe_window_tap_plain(dkf, P, w)),
        ("probe_p4", 1e-5, lambda: probes.probe_stencil1(dkf, P, w),
         lambda: probes.probe_stencil1_plain(dkf, P, w)),
        ("probe_p5", 1e-5, lambda: probes.probe_stencil2(dkf, P, w),
         lambda: probes.probe_stencil2_plain(dkf, P, w)),
    ]
    runs += [("probe_mk", 0.0 if b in ("a", "b") else 1e-5,
              functools.partial(probes.probe_mk, b, dkf, P, w),
              functools.partial(probes.probe_mk_plain, b, dkf, P, w))
             for b in probes.MK_BODIES]
    runs += [("probe_mk2", 1e-5,
              functools.partial(probes.probe_mk2, b, dkf, P, w),
              functools.partial(probes.probe_mk2_plain, b, dkf, P, w))
             for b in probes.MK2_BODIES]
    for name, rel, kern, plain in runs:
        n0 = _build.LAUNCHES[name]
        got = _outputs(kern())
        torch.cuda.synchronize()
        assert _build.LAUNCHES[name] == n0 + 1
        want = _outputs(plain())
        assert all(tuple(a.shape) == (h, w) for a in got)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        scale = max(float(b.abs().max()) for b in want)
        assert err <= rel * scale, (name, err, scale)


def _signed_frame(cuda, hp, wp, offset, seed):
    """P (hp, wp) of standard normals with exact zeros of both signs, a
    contiguous view `offset` floats into a larger buffer (offset 1: a
    base off 16-byte alignment)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=hp * wp).astype(np.float32)
    x[rng.random(hp * wp) < 0.05] = 0.0
    x[rng.random(hp * wp) < 0.05] = -0.0
    buf = torch.zeros(hp * wp + offset, device=cuda)
    buf[offset:] = torch.as_tensor(x, device=cuda)
    return buf[offset:].view(hp, wp)


@pytest.mark.cuda
@pytest.mark.parametrize("k,h,wp,w,offset", [
    (1, 64, 256, 200, 0),     # P2 source shift s = 0 (dj = 0)
    (3, 64, 256, 200, 0),     # s = 1 (dj = 1)
    (5, 64, 256, 200, 0),     # s = 2
    (7, 64, 256, 200, 0),     # s = 3
    (3, 50, 256, 201, 0),     # W % 4 != 0: out rows change alignment
    (3, 50, 259, 250, 0),     # Wp % 4 != 0: the shift changes per row
    (9, 50, 264, 250, 1),     # P's base not 16-byte aligned
    (3, 6, 9000, 8997, 0),    # rows of three work items
    (3, 4, 5, 3, 1),          # rows too short for a float4
])
def test_one_tap_windows_bitwise(cuda, k, h, wp, w, offset):
    """P2, P3 (negative and zero weight), P6 a and b through the vector
    copy kernel: bitwise equal to their plain twins (one rounding of
    w * P, so a zero keeps the twin's sign), one launch per call."""
    P = _signed_frame(cuda, h + k - 1, wp, offset, seed=k * 1000 + wp)
    assert (P.data_ptr() % 16 != 0) == (offset % 4 != 0)
    runs = [("probe_p2", lambda: probes.probe_window(P, k, w),
             lambda: probes.probe_window_plain(P, k, w))]
    for w00 in (-1.7, 0.0):
        dkf = torch.full((2, k * k), 0.5)
        dkf[0, 0] = w00
        runs.append(("probe_p3",
                     functools.partial(probes.probe_window_tap, dkf, P, w),
                     functools.partial(probes.probe_window_tap_plain, dkf,
                                       P, w)))
    if k > 1:   # bodies a and b read row 1 or column 1 of the window
        dkf = torch.ones((2, k * k))
        runs += [("probe_mk",
                  functools.partial(probes.probe_mk, b, dkf, P, w),
                  functools.partial(probes.probe_mk_plain, b, dkf, P, w))
                 for b in ("a", "b")]
    for name, kern, plain in runs:
        n0 = _build.LAUNCHES[name]
        got = kern()
        torch.cuda.synchronize()
        assert _build.LAUNCHES[name] == n0 + 1
        want = plain()
        assert tuple(got.shape) == (h, w)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            name


@pytest.mark.cuda
def test_probe_kernels_reject_bad_inputs(cuda):
    _, P, dkf = make_frame(cuda, 128, 128, 9, 128)
    with pytest.raises(ValueError):
        probes.probe_stencil1(dkf, P.double())
    with pytest.raises(ValueError):
        probes.probe_stencil1(dkf, P, w=P.shape[1])
    with pytest.raises(ValueError):
        probes.probe_mk("z", dkf, P)
    with pytest.raises(ValueError):
        probes.probe_copy2(torch.zeros(9, device=cuda)[1:])


def _pattern_weights(pattern, k, nout, seed):
    rng = np.random.default_rng(seed)
    n = len(probes.pattern_taps(pattern, k))
    return rng.normal(size=(nout, n)).astype(np.float32)


# frames (h, w, Wp, offset of P in floats): 16-byte loads and stores on
# ragged tiles; w % 4 != 0 (scalar stores); P at a 4-byte offset (scalar
# loads); Wp % 4 != 0; rows of two 1,024-column blocks; one output row
PATTERN_FRAMES = ((133, 200, 256, 0), (133, 203, 256, 0), (70, 200, 256, 1),
                  (70, 201, 213, 0), (20, 1500, 1512, 0), (1, 9, 24, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("nout", [1, 2])
@pytest.mark.parametrize("k", [3, 5, 7, 9, 11])
@pytest.mark.parametrize("pattern", probes.PATTERNS)
def test_window_pattern_kernels(cuda, pattern, k, nout):
    """Each pattern kernel (full, row, column) for every k and both
    output counts, on the frames above: within 1e-5 of max |out| of the
    canonical-order twin (the same FMA order), one launch per call."""
    wts = _pattern_weights(pattern, k, nout, seed=10 * k + nout)
    for h, w, wp, offset in PATTERN_FRAMES:
        P = _signed_frame(cuda, h + k - 1, wp, offset, seed=h + wp + k)
        n0 = _build.LAUNCHES["probe_mk"]
        got = probes.window_pattern_cuda("probe_mk", pattern, wts, P, k, w)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["probe_mk"] == n0 + 1
        want = probes.window_pattern_plain(pattern, wts, P, k, w)
        assert [tuple(a.shape) for a in got] == [(h, w)] * nout
        assert _stencil_gap(got, want) <= 1e-5, (h, w, wp, offset)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 9])
@pytest.mark.parametrize("body", ["h", "h2", "h3"])
def test_column_major_bodies_within_bar(cuda, body, k):
    """The column-major bodies are summed by the kernel in row-major
    order: still within 1e-5 of max |out| of their column-major twins."""
    _, P, dkf = make_frame(cuda, 128, 256, k, 128)
    kern, plain = ((probes.probe_mk, probes.probe_mk_plain) if body == "h"
                   else (probes.probe_mk2, probes.probe_mk2_plain))
    got = _outputs(kern(body, dkf, P, 256))
    want = _outputs(plain(body, dkf, P, 256))
    torch.cuda.synchronize()
    assert _stencil_gap(got, want) <= 1e-5


@pytest.mark.cuda
def test_window_taps_refuse_a_tap_list_of_no_pattern(cuda, monkeypatch):
    """A body whose taps are no pattern's is refused before any launch,
    and the C entry point refuses a pattern number it does not know."""
    _, P, dkf = make_frame(cuda, 128, 128, 9, 128)
    full = [(i, j, 9 * i + j) for i in range(9) for j in range(9)]
    monkeypatch.setattr(probes, "body_taps",
                        lambda body, k: ([full[:-1]], 1))
    n0 = _build.LAUNCHES["probe_p4"]
    with pytest.raises(ValueError):
        probes.probe_stencil1(dkf, P)
    assert _build.LAUNCHES["probe_p4"] == n0
    out = torch.empty((128, 128), device=cuda)
    w0 = np.ones(81, np.float32)
    fn = _build.library().imsim_window_taps
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    status = fn(P.data_ptr(), out.data_ptr(), out.data_ptr(), P.shape[0],
                P.shape[1], 128, 128, 9, len(probes.PATTERNS), 1,
                w0.ctypes.data, w0.ctypes.data, _build.stream_ptr(P))
    assert status != 0


# ---- the FFT branch, sky and readout: plain PyTorch on the card ----------
# The card runs the same torch code as the CPU: each stage's
# deterministic part on the card is held to its CPU run (float32 FFTs
# of two libraries: 1e-5 of max |out|).

def _psf_cheb():
    from imsim_tpu_torch.image import fft_render as F
    from imsim_tpu_torch.image.photon_pooling import (PoolingConfig,
                                                      make_psf_mtf)

    psf = make_psf_mtf(PoolingConfig(fft_sb_thresh=2e5, fwhm=0.7))
    cheb, k_max, _ = F.mtf_cheb(psf)
    return psf, cheb, float(np.float32(k_max))


def _test_kernel():
    from imsim_tpu_torch.image.diffraction_fft import spike_kernel

    return spike_kernel(622.0, 0.2, 45.0, 0.1, n=65,
                        spike_flux_fraction=0.03, profile_power=1.1,
                        r_scale_px=3.0, device="cpu")


def _rel_gap(got, want):
    return float((got.cpu() - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("spikes", [False, True])
def test_star_field_card_matches_cpu(cuda, spikes):
    from imsim_tpu_torch.image import fft_render as F

    _, cheb, k_max = _psf_cheb()
    rng = np.random.default_rng(12)
    H, W, pad, m = 600, 520, 128, (32 if spikes else 0)
    Npad = F.good_fft_size(max(H, W) + 2 * pad)
    flux = rng.uniform(1e6, 2e7, 9).astype(np.float32)
    x = rng.uniform(-pad, W + pad, 9).astype(np.float32)
    y = rng.uniform(-pad, H + pad, 9).astype(np.float32)
    kern = _test_kernel() if spikes else None
    out = {}
    for dev in (cuda, torch.device("cpu")):
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        out[dev.type] = F.star_field(cheb, k_max, t(flux), t(x), t(y), kern,
                                     175_000.0, Npad, H, W, pad, 0.2, m)
    assert _rel_gap(out["cuda"][0], out["cpu"][0]) <= 1e-5
    assert _rel_gap(out["cuda"][1], out["cpu"][1]) <= 1e-5


@pytest.mark.cuda
def test_galaxy_stamps_and_add_stamps_card_match_cpu(cuda):
    """render_fft_stamps with the galaxy MTF, a batched apply_spikes and
    add_stamps (corners across the edges)."""
    from imsim_tpu_torch.image import fft_render as F
    from imsim_tpu_torch.image.diffraction_fft import apply_spikes

    psf, _, _ = _psf_cheb()
    gt = F.sersic_mtf_table(1.5)
    rng = np.random.default_rng(13)
    B, N = 5, 256
    A = F.lens_matrix(rng.uniform(0.4, 1, B), rng.uniform(0, 3, B),
                      rng.normal(0, 0.05, B), rng.normal(0, 0.05, B),
                      1 + rng.normal(0, 0.03, B),
                      rng.uniform(0.3, 1.2, B)).astype(np.float32)
    x0 = np.array([-100, 50, 700, -256, 300])
    y0 = np.array([20, -50, 300, 400, 512])
    out = {}
    for dev in (cuda, torch.device("cpu")):
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        st = F.render_fft_stamps(
            t(psf.y).expand(B, -1), t(np.full(B, psf.dx)),
            t(np.full(B, 2e7)), t(np.ones(B)),
            t(np.zeros(B)), t(np.full(B, 0.3)), t(np.full(B, 0.7)), N, 0.2,
            gal_y=t(gt.y).expand(B, -1), gal_dx=float(gt.dx), gal_A=t(A))
        st = apply_spikes(torch.clamp(st, min=0.0), _test_kernel(), 1e5)
        img = F.add_stamps(torch.zeros((512, 768), device=dev), st, x0, y0)
        out[dev.type] = (st, img)
    assert _rel_gap(out["cuda"][0], out["cpu"][0]) <= 1e-5
    assert _rel_gap(out["cuda"][1], out["cpu"][1]) <= 1e-5


@pytest.mark.cuda
def test_sky_expectation_card_matches_cpu(cuda):
    from imsim_tpu_torch.image.ccd_render import sky_expectation

    st = load_ccd_state(device="cpu")
    args = ((st.ny, st.nx), st.sky_level, (1e-5, -2e-5, 1.0),
            st.vig_coarse, 0.2, st.vig_step)
    got = sky_expectation(*args, device=cuda)
    want = sky_expectation(*args, device="cpu")
    assert _rel_gap(got, want) <= 1e-6


@pytest.mark.cuda
def test_readout_card_matches_cpu_without_noise(cuda):
    """The bench CCD's readout with dark current 0 and read noise 0 on a
    frame with saturated columns on both halves and at the bottom edge:
    within the bleed's running-sum rounding (2H float32 ulps of the full
    well, over the smallest gain) plus 1e-6 of the full well."""
    from imsim_tpu_torch.electronics.readout import CcdReadout

    st = load_ccd_state(device="cpu")
    r = st.readout
    img = torch.rand((st.ny, st.nx), generator=torch.Generator()
                     .manual_seed(14)) * 2e3 + 500
    img[1000:1003, 700] = 2e6
    img[2500:2510, 3000] = 1.5e6
    img[1, 20] = 5e6
    out = {}
    for dev in (cuda, torch.device("cpu")):
        ro = CcdReadout(r.vendor, r.gains.numpy(), np.zeros(16),
                        r.bias_levels.numpy(), r.xtalk.numpy(), r.full_well,
                        dark_current=0.0, device=dev)
        out[dev.type] = ro.chain(torch.Generator(device=dev).manual_seed(0),
                                 img.to(dev))
    bar = 2 * 2002 * float(np.spacing(np.float32(r.full_well))) \
        / float(r.gains.min()) + 1e-6 * r.full_well
    assert float((out["cuda"].cpu() - out["cpu"]).abs().max()) <= bar


# ---- the analytic path, the silicon modes, flats and cosmic rays ---------

def _families_scene(dev, rng_seed=4):
    from imsim_tpu_torch.image import render as R
    from imsim_tpu_torch.image.scene import DeviceScene

    rng = np.random.default_rng(rng_seed)
    n = 40
    t = np.resize(np.array([R.POINT, R.SERSIC, R.KNOTS, R.STREAK,
                            R.FITSIMAGE], np.float32), n)
    p2 = rng.uniform(0.3, 1.0, n)
    p2[t == R.FITSIMAGE] = rng.integers(1, 3, int((t == R.FITSIMAGE).sum()))
    cols = [rng.uniform(50, 450, n), rng.uniform(50, 450, n), t,
            np.where(t == R.STREAK, 20.0, 0.6),
            np.where(t == R.KNOTS, 25.0, rng.uniform(0.5, 4, n)), p2,
            rng.uniform(0, np.pi, n), rng.normal(0, 0.03, n),
            rng.normal(0, 0.03, n), 1 + rng.normal(0, 0.03, n)]
    wl = np.sort(rng.uniform(500, 900, (n, 96)), axis=1)
    cloud = np.concatenate([np.zeros((1, 1024, 2)),
                            rng.normal(0, 0.8, (2, 1024, 2))])
    return DeviceScene.from_columns(*cols, wl_icdf=wl, aux_cloud=cloud,
                                    device=dev)


@pytest.mark.cuda
def test_shoot_card_matches_cpu(cuda):
    """render.shoot with host draws injected, every family: positions to
    1e-5 of the largest offset plus one f32 ulp of the frame
    coordinate, the gathered wavelength and absorption length to 1e-6."""
    from imsim_tpu_torch.image import photon_pooling as PP
    from imsim_tpu_torch.image import render as R

    st = load_ccd_state(device="cpu")
    n = 200_000
    obj = np.random.default_rng(1).integers(0, 40, n)
    draws = R.shoot_draws(torch.Generator().manual_seed(2), n,
                          R.ALL_FAMILIES)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        sc = _families_scene(dev)
        d = {k: v.to(dev) for k, v in draws.items() if k != "intrinsic"}
        d["intrinsic"] = {k: v.to(dev) for k, v in
                          draws["intrinsic"].items()}
        out[dev.type] = R.shoot(
            None, sc, torch.as_tensor(obj, device=dev),
            torch.ones(n, device=dev),
            PP.analytic_psf_tables(0.7, 0.3, dev),
            st.profiles, pixel_scale=0.2, draws=d)
    x0 = _families_scene("cpu").params[torch.as_tensor(obj), :2].numpy()
    for i, name in enumerate(("x", "y")):
        a = getattr(out["cuda"], name).cpu().numpy()
        b = getattr(out["cpu"], name).numpy()
        bar = 1e-5 * np.abs(b - x0[:, i]).max() + np.spacing(np.float32(512))
        assert np.abs(a - b).max() <= bar
    for name in ("wavelength", "abs_len", "pupil_u", "time"):
        assert _rel_gap(getattr(out["cuda"], name),
                        getattr(out["cpu"], name)) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("bf_mode", ["image", "photon"])
def test_accumulate_silicon_per_chunk_card(cuda, bf_mode):
    """The per-chunk displacement on the card: one K3 launch per chunk,
    the image mode's charge equal to the in-frame flux binned, and the
    deterministic part (draws injected) equal to the CPU's to 1e-5 of
    the largest displacement plus one ulp of the frame coordinate."""
    from imsim_tpu_torch.photons.batch import PhotonBatch
    from imsim_tpu_torch.sensor import silicon as S

    st = load_ccd_state(device="cpu")
    sil = st.silicon
    n, H, W = 400_000, 600, 700
    g = torch.Generator().manual_seed(3)
    cols = dict(x=torch.rand(n, generator=g) * W,
                y=torch.rand(n, generator=g) * H,
                flux=torch.ones(n) * 20,
                wavelength=550 + torch.rand(n, generator=g) * 400,
                dxdz=0.2 * torch.randn(n, generator=g),
                dydz=0.2 * torch.randn(n, generator=g))
    z = torch.zeros(n)
    ph = {dev: PhotonBatch(**{k: v.to(dev) for k, v in cols.items()},
                           pupil_u=z.to(dev), pupil_v=z.to(dev),
                           time=z.to(dev)) for dev in ("cuda", "cpu")}
    draws = S.silicon_draws(g, n)
    disp = (0.05 * torch.randn((H, W), generator=g),
            0.05 * torch.randn((H, W), generator=g))

    def displaced(dev, d):
        return S.apply_silicon_displacements(
            ph[dev], sil, tuple(a.to(dev) for a in draws),
            disp=None if d is None else tuple(a.to(dev) for a in d))

    base = {dev: displaced(dev, None) for dev in ("cuda", "cpu")}
    out = {dev: displaced(dev, disp) for dev in ("cuda", "cpu")}
    # the BF gather reads the pixel nearest each photon: where the two
    # devices' positions straddle a rounding boundary (one ulp apart) it
    # reads a neighbour, so those photons are left out of the gather's
    # check
    xb, yb = base["cpu"].x, base["cpu"].y
    edge = (((xb - torch.floor(xb)) - 0.5).abs() < 1e-3) \
        | (((yb - torch.floor(yb)) - 0.5).abs() < 1e-3)
    assert int(edge.sum()) < 0.01 * n
    for name in ("x", "y"):
        for res, keep in ((base, slice(None)), (out, ~edge)):
            a = getattr(res["cuda"], name).cpu()[keep]
            b = getattr(res["cpu"], name)[keep]
            d0 = (b - cols[name][keep]).abs().max()
            assert float((a - b).abs().max()) <= 1e-5 * float(d0) + float(
                np.spacing(np.float32(W)))
    assert torch.equal(out["cuda"].flux.cpu(), out["cpu"].flux)
    tr = S.tree_ring_field(sil, (H, W), cuda)
    tally = {}
    n0 = _build.LAUNCHES["stencil_pair"]
    img = S.accumulate_silicon(
        ph["cuda"], torch.zeros((H, W), device=cuda), sil, nsub=4,
        tr_field=tr, tally=tally, bf_mode=bf_mode,
        gen=torch.Generator(device=cuda).manual_seed(5))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["stencil_pair"] == n0 + 4
    total = float(img.sum(dtype=torch.float64))
    assert bool(torch.isfinite(img).all()) and total > 0.9 * 20 * n
    if bf_mode == "image":
        assert abs(total - float(tally["in_frame"])) <= 1e-5 * total


@pytest.mark.cuda
def test_render_ccd_pooled_analytic_card(cuda):
    """The rehearsal's analytic CCD on the card: K1 once per batch, K3
    once per chunk, K2 never; charge accounted to 1e-4."""
    from imsim_tpu_torch.benchmarks._util import analytic_workload
    from imsim_tpu_torch.image import photon_pooling as PP

    state, host, cfg = analytic_workload(cuda, small=True)
    _, _, nb, _ = PP.pooled_plan(host, PP.classify_objects(
        host, cfg, PP.make_psf_mtf(cfg)), cfg)
    tally = {}
    _build.reset_launches()
    img, modes, _ = PP.render_ccd_pooled(0, host, cfg, state.silicon,
                                         profiles=state.profiles,
                                         tally=tally)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["scan_slot_prefix"] == nb
    assert _build.LAUNCHES["stencil_pair"] == nb * cfg.nsub
    assert _build.LAUNCHES["field_to_sensor"] == 0
    pooled = float(img.sum(dtype=torch.float64)) - float(tally["fft"])
    assert abs(pooled - float(tally["in_frame"])) <= 1e-4 * pooled


@pytest.mark.cuda
def test_flats_card(cuda):
    """One pixel-area iteration with injected normals equals the CPU's
    to 1e-6 of the image; the photon flat (42M photons, three
    sub-batches) launches K3 once per sub-batch and lands its photons."""
    from imsim_tpu_torch.image import flat as FL
    from imsim_tpu_torch.sensor.silicon import SiliconParams

    sil = SiliconParams.make()
    g = torch.Generator().manual_seed(6)
    img = 3e4 + 2e4 * torch.rand((300, 333), generator=g)
    noise = torch.randn((300, 333), generator=g)
    a = FL._flat_iteration(None, img.to(cuda), 1000.0, sil,
                           noise=noise.to(cuda)).cpu()
    b = FL._flat_iteration(None, img, 1000.0, sil, noise=noise)
    assert _rel_gap(a, b) <= 1e-6
    cfg = FL.FlatConfig(counts_per_pixel=100.0, counts_per_iter=100.0,
                        xsize=700, ysize=600)
    n_iter, n_sub, _ = FL.photon_flat_plan(cfg)
    assert (n_iter, n_sub) == (1, 3)
    n0 = _build.LAUNCHES["stencil_pair"]
    flat = FL.build_flat_photons(1, cfg, np.full(96, 620.0, np.float32), sil,
                                 device=cuda)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["stencil_pair"] == n0 + n_sub
    st = FL.flat_statistics(flat)
    assert abs(st["mean"] - 100.0) < 1.0 and abs(st["var_over_mean"] - 1) \
        < 0.06


@pytest.mark.cuda
def test_cosmic_rays_card_bitwise(cuda):
    from imsim_tpu_torch.image.cosmic_rays import paint_cosmic_rays

    base = 700 + 30 * torch.randn((512, 512), generator=torch.Generator()
                                  .manual_seed(7))
    a = paint_cosmic_rays(base.clone().to(cuda), 30.0, 3, ccd_rate=200.0)
    b = paint_cosmic_rays(base.clone(), 30.0, 3, ccd_rate=200.0)
    assert torch.equal(a.cpu(), b)


def _to(ph, dev):
    return ph.replace(**{f.name: getattr(ph, f.name).to(dev)
                         for f in dataclasses.fields(ph)
                         if getattr(ph, f.name) is not None})


def _binned(fn, ph, image):
    """fn(ph, image, tally) traced: (image, tally's in-frame flux, the
    counters' totals)."""
    from imsim_tpu_torch.utils import trace

    trace.reset()
    trace.enable()
    tally = {}
    try:
        out = fn(ph, image, tally)
        got = {}
        for c in trace.counters():
            got[c["name"]] = got.get(c["name"], 0.0) + c["value"]
    finally:
        trace.disable()
        trace.reset()
    return out, float(tally["in_frame"]), got


def _twin(ph, base):
    """base + the plain twin's frame on the base's device, with the
    twin's in-frame flux and counters in `_binned`'s form."""
    from imsim_tpu_torch.ops import binning

    frame = torch.zeros_like(base)
    stats = torch.zeros(3, dtype=torch.float64, device=base.device)
    binning.bin_scatter_plain(ph.x, ph.y, ph.flux, frame, stats)
    s = stats.tolist()
    return base + frame, s[0], {"sensor.binned": float(ph.n),
                                "sensor.off_frame": s[1],
                                "sensor.nonunit": s[2]}


@pytest.mark.cuda
@pytest.mark.parametrize("charged", [False, True])
@pytest.mark.parametrize("share,bad", [
    (0.0, False), (0.002, False), (0.09, False), (1.0, False),
    (0.002, True), (0.09, True), (1.0, True)])
def test_bin_scatter_matches_the_sorted_twin(cuda, share, bad, charged):
    """K5 (sensor/simple.accumulate on the card) against its plain twin,
    ops/binning.bin_scatter_plain, run on the card too (`index_put_`
    sorts there), for fluxes of 0 and 1: off-frame shares of 0 to 100%,
    NaN, infinite and huge coordinates, an empty base and one charged
    with fractional values.  The frame is equal bit for bit, to the
    float64 reference's too, and repeats over five calls; the in-frame
    flux and the three counters are equal."""
    from test_torch_binning import H, W, _check_binned, _photons

    from imsim_tpu_torch.sensor import simple

    ph = _to(_photons(share, seed=61 + bad, whole=True, bad=bad), cuda)
    g = torch.Generator().manual_seed(8)
    base = (1e3 * torch.rand((H, W), generator=g) if charged
            else torch.zeros((H, W))).to(cuda)
    want, t_want, c_want = _twin(ph, base)
    _check_binned(want, base, ph)
    n0 = _build.LAUNCHES["bin_scatter"]
    for _ in range(5):
        image = base.clone()
        got, t_got, c_got = _binned(simple.accumulate, ph, image)
        assert got is image
        assert torch.equal(got, want)
        assert t_got == t_want and c_got == c_want
    assert _build.LAUNCHES["bin_scatter"] == n0 + 5
    assert c_want["sensor.nonunit"] == 0
    assert c_want["sensor.binned"] == ph.n


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3, 5, 4098])
def test_bin_scatter_on_unaligned_slices(cuda, offset):
    """Slices of a batch start at any photon: K5 bins a slice whose start
    is no multiple of 4 (nor of 16 bytes) as the twin does."""
    from test_torch_binning import H, W, _photons

    from imsim_tpu_torch.sensor import simple

    ph = _to(_photons(0.09, seed=71, whole=True), cuda)
    part = ph.slice(offset, ph.n - 7)
    assert part.x.data_ptr() % 16 != 0
    want = _twin(part, torch.zeros((H, W), device=cuda))[0]
    got = simple.accumulate(part, torch.zeros((H, W), device=cuda))
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_bin_scatter_full_frame_flat_sub_batch(cuda):
    """The flat's sub-batch: 16,769,309 photons over the whole 4004 x 4096
    frame (0.1% of them just beyond its edges), fluxes 0 and 1, on a
    charged base: bit-equal to the twin, five calls alike, the tally and
    the counters equal."""
    from imsim_tpu_torch.photons.batch import PhotonBatch
    from imsim_tpu_torch.sensor import simple

    H, W, n = 4004, 4096, 16_769_309
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.rand(n, generator=g, device=cuda) * (W + 2) - 1.5
    y = torch.rand(n, generator=g, device=cuda) * (H + 2) - 1.5
    flux = (torch.rand(n, generator=g, device=cuda) < 0.97).float()
    ph = PhotonBatch.zeros(n, device=cuda).replace(x=x, y=y, flux=flux)
    base = torch.floor(1500 + 50 * torch.randn(
        (H, W), generator=g, device=cuda)) + 0.25
    want, t_want, c_want = _twin(ph, base)
    for _ in range(5):
        got, t_got, c_got = _binned(simple.accumulate, ph, base.clone())
        assert torch.equal(got, want)
        assert t_got == t_want and c_got == c_want
    assert 0 < c_want["sensor.off_frame"] < 0.01 * n
    assert c_want["sensor.nonunit"] == 0


@pytest.mark.cuda
def test_bin_scatter_counts_nonunit_fluxes(cuda):
    """Fluxes other than 0 and 1 are counted by K5 as by the twin (NaN
    too), and bin to the twin's sums within float32 rounding (the bound
    of test_binning_matches_the_float64_sums_on_the_card)."""
    from test_torch_binning import H, W, _photons, _pixel_sums

    from imsim_tpu_torch.sensor import simple

    ph = _to(_photons(0.09, seed=81, bad=True), cuda)
    flux = ph.flux.clone()
    flux[::7] = 1.0
    flux[::11] = 0.0
    flux[5] = float("nan")
    ph = ph.replace(flux=flux)
    want, _, c_want = _twin(ph, torch.zeros((H, W), device=cuda))
    got, _, c_got = _binned(simple.accumulate, ph,
                            torch.zeros((H, W), device=cuda))
    assert c_got == c_want
    expect = ((flux != 0) & (flux != 1)).sum().item()
    assert c_got["sensor.nonunit"] == expect > 0.5 * ph.n
    nan = torch.isnan(want)
    assert torch.equal(nan, torch.isnan(got)) and int(nan.sum()) <= 1
    _, sums, count = _pixel_sums(ph, (H, W))
    gap = (got - want).double().cpu().abs()
    keep = ~nan.cpu()
    assert bool((gap <= count * 2.0 ** -23 * sums)[keep].all())


@pytest.mark.cuda
def test_bin_scatter_refuses_bad_inputs(cuda):
    """A CPU frame bins as the twin does; on the card, inputs beside
    another device, of another dtype or length, a strided frame and
    float32 stats raise, and no photons launch nothing."""
    from imsim_tpu_torch.ops import binning

    xc = torch.tensor([0.2, 3.6, -0.7, 4.4, float("nan")])
    yc = torch.tensor([1.0, 2.5, 1.0, 3.4, 1.0])
    fc = torch.tensor([1.0, 1.0, 1.0, 0.5, 1.0])
    n0 = _build.LAUNCHES["bin_scatter"]
    got = binning.bin_scatter(xc, yc, fc, torch.zeros((4, 5)))
    want = binning.bin_scatter_plain(xc, yc, fc, torch.zeros((4, 5)))
    assert torch.equal(got, want) and float(got.sum()) == 2.5
    assert _build.LAUNCHES["bin_scatter"] == n0
    x = torch.zeros(10, device=cuda)
    frame = torch.zeros((4, 5), device=cuda)
    with pytest.raises(ValueError):
        binning.bin_scatter(x.cpu(), x.cpu(), x.cpu(), frame)
    with pytest.raises(ValueError):
        binning.bin_scatter(x, x, x.double(), frame)
    with pytest.raises(ValueError):
        binning.bin_scatter(x, x, x[:5], frame)
    with pytest.raises(ValueError):
        binning.bin_scatter(x, x, x, frame.t())
    with pytest.raises(ValueError):
        binning.bin_scatter(x, x, x, frame,
                            torch.zeros(3, device=cuda))
    binning.bin_scatter(x[:0], x[:0], x[:0], frame)
    assert _build.LAUNCHES["bin_scatter"] == n0
    assert float(frame.abs().sum()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("whole", [True, False])
@pytest.mark.parametrize("share", [0.0, 0.002, 0.09, 1.0])
def test_binning_matches_the_float64_sums_on_the_card(cuda, share, whole):
    """sensor/simple's binner (K5 on the card) against the float64
    reference of tests/test_torch_binning.py, onto a new frame and into
    `binned`'s own: bit-equal for whole fluxes (the pooled render's 0 or
    1 sum to whole numbers below 2^24, exact in any order); other fluxes
    meet in the atomics' order, within float32 rounding of the
    reference."""
    from test_torch_binning import _check_binned, _photons

    from imsim_tpu_torch.sensor import simple

    ph = _to(_photons(share, seed=51, whole=whole, bad=share > 0), cuda)
    shape = (48, 56)
    zero = torch.zeros(shape, device=cuda)
    for got in (simple.accumulate(ph, zero.clone()),
                simple.binned(ph, shape, cuda)):
        assert got.is_cuda
        _check_binned(got, zero, ph)
