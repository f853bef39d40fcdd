"""Ideal-sensor accumulation: photon scatter-add into pixels
(imsim_tpu/sensor/simple.py counterpart)."""
from __future__ import annotations

import torch

from ..photons.batch import PhotonBatch
from ..utils import trace


def accumulate(photons: PhotonBatch, image: torch.Tensor,
               tally: dict | None = None) -> torch.Tensor:
    """Add photon flux into the (H, W) image in place and return it.
    Integer (x, y) are pixel centres; out-of-frame photons are dropped.
    With `tally`, the in-frame flux is added (as a float64 device
    scalar, no host sync) to tally["in_frame"].  While tracing is on,
    the counters `sensor.binned` (the photons handed in) and
    `sensor.off_frame` (those outside the frame, which the scatter sends
    to pixel 0 with flux 0)."""
    H, W = image.shape
    fx = torch.round(photons.x)
    fy = torch.round(photons.y)
    inb = (fx >= 0) & (fx < W) & (fy >= 0) & (fy < H)
    if trace.on():
        trace.count("sensor.binned", inb.numel())
        trace.count("sensor.off_frame", inb.numel() - inb.sum())
    flux = torch.where(inb, photons.flux, 0.0).to(image.dtype)
    # masked before the integer cast: a NaN or huge coordinate must
    # never become an index
    ix = torch.where(inb, fx, 0.0).to(torch.int64)
    iy = torch.where(inb, fy, 0.0).to(torch.int64)
    image.view(-1).index_put_((iy * W + ix,), flux, accumulate=True)
    if tally is not None:
        tally["in_frame"] = tally.get("in_frame", 0.0) \
            + flux.sum(dtype=torch.float64)
    return image
