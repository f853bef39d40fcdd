"""The yardsticks chip_smoke.py reports beside every kernel: each
kernel's bound (benchmarks/_util.bound, from the operations and bytes of
the call) and the one PyTorch call computing the same function
(benchmarks/probe_pallas.window_library for the probe bodies, a float32
conv2d for K3).  On the CPU: the one-call versions compute the plain
twins' functions to 1e-5 of max |out| (the bar chip_smoke.py holds them
to on the card), and the work counts follow the bodies' taps."""
import numpy as np
import pytest
import torch

from imsim_tpu_torch.benchmarks._util import (LIBRARY_BAR, Timer, bound,
                                              check_kernel, conv2d_fp32)
from imsim_tpu_torch.benchmarks.probe_pallas import (make_frame,
                                                     window_library,
                                                     window_work)
from imsim_tpu_torch.ops import probes, stencil

torch.set_num_threads(1)

BODIES = ("p2", "p3", "p4", "p5") + probes.MK_BODIES + probes.MK2_BODIES


@pytest.mark.parametrize("body", BODIES)
def test_window_library_computes_the_body(body):
    h, w, k = 48, 40, 9
    _, P, dkf = make_frame("cpu", h, w, k, 16)
    want = probes.window_plain(body, dkf, P, k, w)
    got = window_library(body, dkf, P, k, w)()
    got = got if isinstance(got, (tuple, list)) else (got,)
    assert len(got) == len(want)
    scale = max(float(t.abs().max()) for t in want)
    for g, t in zip(got, want):
        assert tuple(g.shape) == (h, w)
        assert float((g - t).abs().max()) <= LIBRARY_BAR * scale


def test_window_work_follows_the_taps():
    h, w, k = 64, 128, 9
    reach = 4 * (h + k - 1) * (w + k - 1)
    # a copy moves the window and nothing else
    assert window_work("p2", k, h, w) == (0, 8 * h * w)
    assert window_work("p3", k, h, w) == (h * w, 8 * h * w)
    # 81 multiplies and 80 adds per output pixel and output
    assert window_work("p4", k, h, w) == (161 * h * w, reach + 4 * h * w)
    assert window_work("p5", k, h, w) == (2 * 161 * h * w,
                                          reach + 8 * h * w)
    # body c reads one row of k taps, d one column
    assert window_work("c", k, h, w) == (17 * h * w,
                                         4 * h * (w + k - 1) + 4 * h * w)
    assert window_work("d", k, h, w) == (17 * h * w,
                                         4 * (h + k - 1) * w + 4 * h * w)


def test_bound_takes_the_larger_time():
    assert bound(67e9, 1.0) == dict(bound_ms=1.0, bound_by="operations")
    assert bound(1.0, 3.35e9) == dict(bound_ms=1.0, bound_by="bytes")
    # K3 at the bench frame: 324 operations per pixel against 12 bytes
    b = bound(4 * 81 * 4004 * 4096, 12 * 4004 * 4096)
    assert b["bound_by"] == "operations"
    assert np.isclose(b["bound_ms"], 0.0793, rtol=1e-3)


@pytest.mark.parametrize("k", [3, 9, 11])
def test_stencil_conv2d_yardstick_computes_k3(k):
    """The K3 yardstick: one conv2d, both tap sets as output channels,
    SAME padding k // 2, equals the twin's correlation; cuDNN's TF32
    flag is restored."""
    rng = np.random.default_rng(k)
    img = torch.as_tensor(rng.uniform(0, 1e5, (37, 53)).astype(np.float32))
    kx, ky = (torch.as_tensor(rng.normal(0, 1e-6, (k, k)).astype(
        np.float32)) for _ in range(2))
    before = torch.backends.cudnn.allow_tf32
    out = conv2d_fp32(img[None, None], torch.stack([kx, ky])[:, None],
                      padding=k // 2)[0]
    assert torch.backends.cudnn.allow_tf32 == before
    for g, t in zip(out.unbind(0), stencil.stencil_pair_plain(img, kx, ky)):
        assert float((g - t).abs().max()) <= 1e-5 * float(t.abs().max())


def test_check_kernel_refuses_a_library_call_of_another_function():
    x = torch.linspace(1.0, 2.0, 1000)
    timer = Timer("cpu")
    row = check_kernel(timer, lambda: x * 2.0, lambda: x * 2.0, 0.0,
                       (1000, 8000), lambda: x + x)
    assert row["within"] == 0.0 and row["library_err"] == 0.0
    assert row["bound_by"] == "bytes" and row["library_ms"] is not None
    with pytest.raises(AssertionError):
        check_kernel(timer, lambda: x * 2.0, lambda: x * 2.0, 0.0,
                     (1000, 8000), lambda: x * 2.001)
