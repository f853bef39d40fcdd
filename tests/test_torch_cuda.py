"""The port's CUDA kernels against their plain twins at modest shapes.

These need an NVIDIA card (marker `cuda`); they skip elsewhere.  On the
card: python -m pytest tests/test_torch_cuda.py -q -p no:randomly
(chip_smoke.py runs the same comparisons at the main path's shapes)."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

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
@pytest.mark.parametrize("pair,share,mp", [(1, 1, 5000), (4, 4, 70_001),
                                           (4, 8, 3000)])
def test_scan_slot_prefix_kernel(cuda, pair, share, mp):
    """Any mp (ragged tail included): f32 prefix sums of 0.01-scale
    deltas, 2000 nonzero per column set -> 1e-5 absolute."""
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
    """K4 at row lengths with a ragged CUDA tile (5000, 3072 are not
    multiples of the 1024-column tile) and whole tiles: f32 prefix sums of
    0.01-scale deltas, 2000 nonzero per row -> 1e-5 absolute."""
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


def _outputs(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.cuda
@pytest.mark.parametrize("k,h,w,th", [(9, 256, 384, 128), (3, 200, 300, 8)])
def test_probe_kernels(cuda, k, h, w, th):
    """P1-P7 against their plain twins, on whole and ragged 32 x 32 tiles:
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
