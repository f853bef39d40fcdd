"""The port's CUDA kernels against their plain twins at modest shapes.

These need an NVIDIA card (marker `cuda`); they skip elsewhere.  On the
card: python -m pytest tests/test_torch_cuda.py -q -p no:randomly
(chip_smoke.py runs the same comparisons at the main path's shapes)."""
import dataclasses

import numpy as np
import pytest
import torch

from imsim_tpu_torch.convert import load_ccd_state
from imsim_tpu_torch.ops import _build, raychain, scanrows, stencil
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
