"""K5: the binning scatter on the card (csrc/binning.cu): each photon's
flux added into the pixel its rounded (x, y) falls in, off-frame photons
dropped.  It replaces no TPU kernel; its plain twin is the sorted
scatter of sensor/simple.accumulate_plain, which the CPU runs."""
from __future__ import annotations

import ctypes

import torch

from . import _build


def bin_scatter(x: torch.Tensor, y: torch.Tensor, flux: torch.Tensor,
                frame: torch.Tensor, stats: torch.Tensor | None = None):
    """Add flux[i] into frame[round(y[i]), round(x[i])] for every photon
    inside the (H, W) float32 frame, in place (round half to even, as
    torch.round).  With `stats`, a float64 tensor of 3 on the same card,
    adds to it the in-frame flux, the photons outside the frame and the
    photons whose flux is neither 0 nor 1.  CUDA tensors only."""
    if not frame.is_cuda:
        raise ValueError("bin_scatter: the kernel runs on the card; "
                         "sensor/simple.accumulate_plain bins elsewhere")
    H, W = frame.shape
    n = x.shape[0]
    _build.require(frame, "frame")
    for t, name in ((x, "x"), (y, "y"), (flux, "flux")):
        _build.require(t, name, (n,))
        if t.device != frame.device:
            raise ValueError(f"bin_scatter: {name} on {t.device}, the "
                             f"frame on {frame.device}")
    if stats is not None and (stats.dtype != torch.float64
                              or tuple(stats.shape) != (3,)
                              or stats.device != frame.device
                              or not stats.is_contiguous()):
        raise ValueError("bin_scatter: stats must be a contiguous float64 "
                         "tensor of 3 beside the frame")
    if H * W >= 2 ** 31:
        raise ValueError(f"bin_scatter: a frame of {H} x {W} pixels is "
                         f"indexed past int32")
    if n == 0:                       # nothing to launch, nothing counted
        return frame
    fn = _build.library().imsim_bin_scatter
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                           ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(x.data_ptr(), y.data_ptr(), flux.data_ptr(), n,
                frame.data_ptr(), H, W,
                None if stats is None else stats.data_ptr(),
                _build.stream_ptr(frame))
    _build.check(status, "bin_scatter")
    _build.count_launch("bin_scatter")
    return frame
