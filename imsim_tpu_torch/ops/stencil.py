"""K3: SAME-padded correlation of a charge image with two k x k tap sets
that share every input tap (replaces imsim_tpu/ops/stencil.py::
stencil_pair).  out[y, x] = sum_{i,j} dk[i, j] * img[y+i-R, x+j-R],
zero outside the frame.  The CUDA kernel is csrc/stencil.cu; the plain
twin is the shifted-slice sum of silicon._displacement_slices."""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

# tap-set sizes the CUDA kernel is instantiated for (odd k)
CUDA_TAP_SIZES = (3, 5, 7, 9, 11)


def stencil_pair_plain(image: torch.Tensor, dkx: torch.Tensor,
                       dky: torch.Tensor):
    """Shifted-slice formulation: 2 k^2 multiply-adds over one padded
    copy, in (i, j) order."""
    k = dkx.shape[0]
    R = k // 2
    H, W = image.shape
    P = torch.nn.functional.pad(image, (R, R, R, R))
    kx = dkx.tolist()
    ky = dky.tolist()
    dx = torch.zeros_like(image)
    dy = torch.zeros_like(image)
    for i in range(k):
        for j in range(k):
            sl = P[i:i + H, j:j + W]
            dx = dx + kx[i][j] * sl
            dy = dy + ky[i][j] * sl
    return dx, dy


def stencil_pair_cuda(image: torch.Tensor, dkx: torch.Tensor,
                      dky: torch.Tensor):
    """Launch the CUDA kernel on an (H, W) float32 image."""
    H, W = image.shape
    k = dkx.shape[0]
    _build.require(image, "image")
    if k not in CUDA_TAP_SIZES or tuple(dkx.shape) != (k, k) \
            or tuple(dky.shape) != (k, k):
        raise ValueError(f"stencil_pair: tap sets {tuple(dkx.shape)}, "
                         f"{tuple(dky.shape)}; k must be in "
                         f"{CUDA_TAP_SIZES}")
    lib = _build.library()
    fn = lib.imsim_stencil_pair
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    # taps cross by value (host arrays copied into the launch)
    kx = np.ascontiguousarray(dkx.detach().cpu().numpy(), np.float32)
    ky = np.ascontiguousarray(dky.detach().cpu().numpy(), np.float32)
    ox = torch.empty_like(image)
    oy = torch.empty_like(image)
    status = fn(image.data_ptr(), ox.data_ptr(), oy.data_ptr(), H, W, k,
                kx.ctypes.data, ky.ctypes.data, _build.stream_ptr(image))
    _build.check(status, "stencil_pair")
    _build.count_launch("stencil_pair")
    return ox, oy


def stencil_pair(image: torch.Tensor, dkx: torch.Tensor,
                 dky: torch.Tensor):
    """(image * dkx, image * dky) as SAME correlations.  CUDA tensor:
    the kernel; CPU tensor: the plain twin."""
    if image.is_cuda:
        return stencil_pair_cuda(image, dkx, dky)
    if image.device.type != "cpu":
        raise ValueError(f"stencil_pair: unsupported device {image.device}")
    return stencil_pair_plain(image, dkx, dky)
