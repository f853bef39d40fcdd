"""K5: the binning scatter (csrc/binning.cu): each photon's flux added
into the pixel its rounded (x, y) falls in, off-frame photons dropped.
It replaces no TPU kernel (the JAX package bins with XLA's scatter-add).
Its plain twin, `bin_scatter_plain`, is the same algorithm in one masked
`index_put_(accumulate=True)` and runs on any device."""
from __future__ import annotations

import ctypes

import torch

from . import _build


def bin_scatter_plain(x: torch.Tensor, y: torch.Tensor, flux: torch.Tensor,
                      frame: torch.Tensor,
                      stats: torch.Tensor | None = None):
    """`bin_scatter` in plain PyTorch: the in-frame photons' fluxes added
    into the frame in place by one masked `index_put_`; `stats` as
    there.  The mask is applied before the integer cast, so that a NaN,
    infinite or huge coordinate never becomes an index."""
    H, W = frame.shape
    fx = torch.round(x)
    fy = torch.round(y)
    inb = (fx >= 0) & (fx < W) & (fy >= 0) & (fy < H)
    idx = fy[inb].to(torch.int64) * W + fx[inb].to(torch.int64)
    frame.view(-1).index_put_((idx,), flux[inb], accumulate=True)
    if stats is not None:
        stats += torch.stack((
            torch.where(inb, flux, 0.0).sum(dtype=torch.float64),
            (~inb).sum(dtype=torch.float64),
            ((flux != 0) & (flux != 1)).sum(dtype=torch.float64)))
    return frame


def bin_scatter(x: torch.Tensor, y: torch.Tensor, flux: torch.Tensor,
                frame: torch.Tensor, stats: torch.Tensor | None = None):
    """Add flux[i] into frame[round(y[i]), round(x[i])] for every photon
    inside the (H, W) float32 frame, in place (round half to even, as
    torch.round).  With `stats`, a float64 tensor of 3 beside the frame,
    adds to it the in-frame flux, the photons outside the frame and the
    photons whose flux is neither 0 nor 1.  A CUDA frame: the kernel;
    any other: the plain twin."""
    if not frame.is_cuda:
        return bin_scatter_plain(x, y, flux, frame, stats)
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
