"""Ideal-sensor accumulation: photon scatter-add into pixels
(imsim_tpu/sensor/simple.py counterpart).

On the card `accumulate` bins with K5 (ops/binning.py): one pass of
atomic adds into a zeroed scratch frame, then one add of the scratch to
the image, so that every pixel becomes its old value plus the sum S of
its photons' fluxes, as the sorted scatter gives it.  No off-frame
photon touches memory.  The adds of a pixel meet in the hardware's
order: for fluxes of 0 and 1, as every producer of the port hands in
(the pooled render's alive weights, K2's zeroing, the flat's depth
loss), S is a whole number below 2^24, exact in any order, so the image
is the same bit for bit as the sorted scatter's and repeats.  Another
flux bins to the same sums within float32 rounding, not bit for bit;
the counter `sensor.nonunit` counts such photons.

Elsewhere `accumulate_plain` bins, the plain twin: one
`index_put_(accumulate=True)` into a flat buffer of the frame's H * W
pixels, row major, then a short tail of scratch slots; an out-of-frame
photon i goes, with flux 0, to tail slot i mod the tail's length, and
the tail is dropped (on the card, where that scatter sorts its indices
and sums each run of equal ones in one warp, that kept the off-frame
photons from making one long run at pixel 0).
"""
from __future__ import annotations

import torch

from ..ops import binning
from ..photons.batch import PhotonBatch
from ..utils import trace

# a run of this many equal indices takes the sorted scatter one pass of
# one warp
_WARP = 32


def tail_slots(n: int, frame: int) -> int:
    """The tail's length for n photons binned into `frame` pixels: the
    room below the next power of two at or above the frame (the sort's
    key bits follow the buffer's largest index, so that room adds no
    radix pass), at most n, and at least ceil(n / 32), so that no slot
    gathers more than one warp's pass of photons."""
    room = (1 << max(frame - 1, 0).bit_length()) - frame
    return max(1, min(n, max(room, -(-n // _WARP))))


def bin_indices(photons: PhotonBatch, H: int, W: int, tail: int):
    """(flat index, flux, in-frame mask) of each photon for a buffer of
    H * W + tail: integer (x, y) are pixel centres; an out-of-frame
    photon i takes index H * W + i mod tail and flux 0."""
    fx = torch.round(photons.x)
    fy = torch.round(photons.y)
    inb = (fx >= 0) & (fx < W) & (fy >= 0) & (fy < H)
    flux = torch.where(inb, photons.flux, 0.0)
    # masked before the integer cast: a NaN or huge coordinate must
    # never become an index
    ix = torch.where(inb, fx, 0.0).to(torch.int64)
    iy = torch.where(inb, fy, 0.0).to(torch.int64)
    spare = torch.arange(photons.n, device=ix.device).remainder_(tail) \
        .add_(H * W)
    return torch.where(inb, iy * W + ix, spare), flux, inb


def accumulate_plain(photons: PhotonBatch, image: torch.Tensor,
                     tally: dict | None = None) -> torch.Tensor:
    """`accumulate` as the sorted scatter into the padded buffer (the
    module's docstring): the image is copied into it and back."""
    H, W = image.shape
    tail = tail_slots(photons.n, H * W)
    idx, flux, inb = bin_indices(photons, H, W, tail)
    if trace.on():
        trace.count("sensor.binned", inb.numel())
        trace.count("sensor.off_frame", inb.numel() - inb.sum())
        trace.count("sensor.nonunit",
                    ((photons.flux != 0) & (photons.flux != 1)).sum())
    flux = flux.to(image.dtype)
    frame = image.view(-1)
    flat = torch.cat((frame, frame.new_zeros(tail)))
    flat.index_put_((idx,), flux, accumulate=True)
    frame.copy_(flat[:H * W])
    if tally is not None:
        tally["in_frame"] = tally.get("in_frame", 0.0) \
            + flux.sum(dtype=torch.float64)
    return image


def accumulate(photons: PhotonBatch, image: torch.Tensor,
               tally: dict | None = None) -> torch.Tensor:
    """Add photon flux into the (H, W) image in place and return it.
    Integer (x, y) are pixel centres; out-of-frame photons are dropped.
    A CUDA image is binned by K5, any other by `accumulate_plain`.  With
    `tally`, the in-frame flux is added (as a float64 device scalar, no
    host sync) to tally["in_frame"].  While tracing is on, the counters
    `sensor.binned` (the photons handed in), `sensor.off_frame` (those
    outside the frame) and `sensor.nonunit` (those whose flux is neither
    0 nor 1: outside the bit-for-bit contract of the module's
    docstring)."""
    if not image.is_cuda:
        return accumulate_plain(photons, image, tally)
    counted = trace.on()
    stats = image.new_zeros(3, dtype=torch.float64) \
        if counted or tally is not None else None
    scratch = torch.zeros_like(image)
    binning.bin_scatter(photons.x, photons.y, photons.flux, scratch, stats)
    image += scratch
    if counted:
        trace.count("sensor.binned", photons.n)
        trace.count("sensor.off_frame", stats[1])
        trace.count("sensor.nonunit", stats[2])
    if tally is not None:
        tally["in_frame"] = tally.get("in_frame", 0.0) + stats[0]
    return image
