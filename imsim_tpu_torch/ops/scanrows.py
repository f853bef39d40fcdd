"""K1: ordinal-order prefix sum of slot-layout deltas
(replaces imsim_tpu/ops/scanrows.py::scan_slot_prefix).

The pooled row materialization scatters each object's parameter delta
into the two-level slot layout d (C, pe, mp): plane beta, lane q holds
photon ordinal j = pe*q + mu(beta) (photon_pooling.member_offsets).  The
per-photon rows are the prefix sum of d in ORDINAL order.  The CUDA
kernel (csrc/scanrows.cu) walks that order directly; the plain twin
permutes planes into ordinal order, runs one cumsum and permutes back.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

# lanes per scan block of the JAX kernel's tiling; kept so align_batch
# and pooled_plan size batches exactly as the JAX package does
_SLOT_LANES = 32_768


def slot_blkq(pe: int) -> int:
    """Per-plane lane-block length of the JAX kernel's tiling (copy of
    imsim_tpu.ops.scanrows.slot_blkq)."""
    return 128 * max(1, _SLOT_LANES // max(pe, 1) // 128)


def align_batch(batch_size: int, pair: int, share: int,
                blkq: int = None) -> int:
    """Round a pooled batch size up to whole (pe, blkq) lane blocks, the
    JAX package's batch sizing (copy of imsim_tpu.ops.scanrows.
    align_batch).  The CUDA kernel takes any mp; the alignment keeps the
    two packages' batches and slot layouts identical."""
    pe = max(pair, 1) * max(share, 1)
    if pe <= 1 or batch_size < (1 << 18):
        return batch_size
    q = pe * (slot_blkq(pe) if blkq is None else blkq)
    return -(-batch_size // q) * q


def beta_order(pair: int, share: int) -> tuple:
    """Plane index of each member mu = 0..pe-1 (planes sorted by mu):
    plane beta = h*share + r holds member mu = pair*r + h."""
    pe = pair * share
    return tuple((mu % pair) * share + (mu // pair) for mu in range(pe))


def scan_slot_prefix_plain(d: torch.Tensor, pair: int,
                           share: int) -> torch.Tensor:
    """Plain twin: planes to ordinal order, one cumsum, and back."""
    C, pe, mp = d.shape
    order = torch.as_tensor(beta_order(pair, share), device=d.device)
    ordinal = d[:, order, :].transpose(1, 2).reshape(C, pe * mp)
    cs = torch.cumsum(ordinal, dim=1).reshape(C, mp, pe).transpose(1, 2)
    out = torch.empty_like(d)
    out[:, order, :] = cs
    return out


def scan_slot_prefix_cuda(d: torch.Tensor, pair: int,
                          share: int) -> torch.Tensor:
    """Launch the CUDA kernel on d (C, pe, mp) float32."""
    C, pe, mp = d.shape
    _build.require(d, "d")
    if pe > 64:
        raise ValueError(f"scan_slot_prefix: pe={pe} > 64")
    lib = _build.library()
    fn = lib.imsim_scan_slot_prefix
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_longlong,
                                            ctypes.c_void_p,
                                            ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(d)
    ntiles = max(1, -(-mp // lib.imsim_scan_tile_columns()))
    scratch = torch.empty((C, ntiles), dtype=torch.float32, device=d.device)
    order = np.asarray(beta_order(pair, share), np.int32)
    status = fn(d.data_ptr(), out.data_ptr(), scratch.data_ptr(), C, pe,
                mp, order.ctypes.data, _build.stream_ptr(d))
    _build.check(status, "scan_slot_prefix")
    _build.count_launch("scan_slot_prefix")
    return out


def scan_slot_prefix(d: torch.Tensor, pair: int, share: int) -> torch.Tensor:
    """out[c, beta, q] = sum of d over all slots whose photon ordinal
    pe*q' + mu(beta') <= pe*q + mu(beta).  CUDA tensor: the kernel;
    CPU tensor: the plain twin."""
    if d.shape[1] != pair * share:
        raise ValueError(f"shape {tuple(d.shape)} vs pair={pair} "
                         f"share={share}")
    if d.is_cuda:
        return scan_slot_prefix_cuda(d, pair, share)
    if d.device.type != "cpu":
        raise ValueError(f"scan_slot_prefix: unsupported device {d.device}")
    return scan_slot_prefix_plain(d, pair, share)
