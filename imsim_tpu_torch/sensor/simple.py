"""Ideal-sensor accumulation: photon scatter-add into pixels
(imsim_tpu/sensor/simple.py counterpart).

The scatter bins into a flat buffer: the frame's H * W pixels, row
major, then a short tail of scratch slots.  An out-of-frame photon i
goes, with flux 0, to tail slot i mod the tail's length, and the tail is
dropped.  On CUDA `index_put_(accumulate=True)` sorts the indices and
adds each run of equal indices in one warp, so sending all of those
photons to one pixel would make one serial run of every out-of-frame
photon in the chunk.  The sort is stable, so each in-frame pixel's run
holds the same photons in the same order as with all of them at pixel
0: every in-frame pixel's sum is unchanged bit for bit, but pixel
(0, 0), whose photons no longer share their run with zeros; with the
pooled render's fluxes, all 0 or 1, it too is exact.
"""
from __future__ import annotations

import torch

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


def accumulate(photons: PhotonBatch, image: torch.Tensor,
               tally: dict | None = None) -> torch.Tensor:
    """Add photon flux into the (H, W) image in place and return it.
    Integer (x, y) are pixel centres; out-of-frame photons are dropped:
    each goes with flux 0 to a tail slot of its own past the frame (the
    module's docstring), so the image is copied into the padded buffer
    and back.  With `tally`, the in-frame flux is added (as a float64
    device scalar, no host sync) to tally["in_frame"].  While tracing is
    on, the counters `sensor.binned` (the photons handed in) and
    `sensor.off_frame` (those outside the frame: the photons sent to the
    tail)."""
    H, W = image.shape
    tail = tail_slots(photons.n, H * W)
    idx, flux, inb = bin_indices(photons, H, W, tail)
    if trace.on():
        trace.count("sensor.binned", inb.numel())
        trace.count("sensor.off_frame", inb.numel() - inb.sum())
    flux = flux.to(image.dtype)
    frame = image.view(-1)
    flat = torch.cat((frame, frame.new_zeros(tail)))
    flat.index_put_((idx,), flux, accumulate=True)
    frame.copy_(flat[:H * W])
    if tally is not None:
        tally["in_frame"] = tally.get("in_frame", 0.0) \
            + flux.sum(dtype=torch.float64)
    return image
