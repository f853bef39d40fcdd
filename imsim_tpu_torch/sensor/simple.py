"""Ideal-sensor accumulation: photon scatter-add into pixels
(imsim_tpu/sensor/simple.py counterpart).

`binned` bins photons into a zeroed frame with ops/binning.bin_scatter
(K5 on the card, its plain twin elsewhere): each pixel gets the sum S of
the fluxes of the photons that round into it, and no off-frame photon
touches memory.  `accumulate` adds S to an image, base + S on every
device.  A pixel's adds meet in no fixed order: for fluxes of 0 and 1,
which every producer of the port hands in (the pooled render's alive
weights, K2's zeroing, the flat's depth loss), S is a whole number below
2^24, exact in any order, so the frame repeats bit for bit; other fluxes
bin to the same sums within float32 rounding, and the counter
`sensor.nonunit` counts them.
"""
from __future__ import annotations

import torch

from ..ops import binning
from ..photons.batch import PhotonBatch
from ..utils import trace


def binned(photons: PhotonBatch, shape, device,
           tally: dict | None = None) -> torch.Tensor:
    """The (H, W) float32 frame S of the photons' fluxes on `device`.
    Integer (x, y) are pixel centres; out-of-frame photons are dropped.
    With `tally`, the in-frame flux is added (as a float64 device scalar,
    no host sync) to tally["in_frame"].  While tracing is on, the
    counters `sensor.binned` (the photons handed in), `sensor.off_frame`
    (those outside the frame) and `sensor.nonunit` (those whose flux is
    neither 0 nor 1: outside the bit-for-bit contract of the module's
    docstring)."""
    frame = torch.zeros(shape, device=device)
    counted = trace.on()
    stats = torch.zeros(3, dtype=torch.float64, device=device) \
        if counted or tally is not None else None
    binning.bin_scatter(photons.x, photons.y, photons.flux, frame, stats)
    if counted:
        trace.count("sensor.binned", photons.n)
        trace.count("sensor.off_frame", stats[1])
        trace.count("sensor.nonunit", stats[2])
    if tally is not None:
        tally["in_frame"] = tally.get("in_frame", 0.0) + stats[0]
    return frame


def accumulate(photons: PhotonBatch, image: torch.Tensor,
               tally: dict | None = None) -> torch.Tensor:
    """Add photon flux into the (H, W) image in place and return it:
    image += `binned` (tally and counters as there)."""
    image += binned(photons, image.shape, image.device, tally)
    return image
