"""Coarse-grid evaluation of smooth full-frame fields
(imsim_tpu/utils/grid.py counterpart, torch form only).

A map that is smooth at the tens-of-pixels scale (vignetting) is
evaluated on a stride-`step` grid on the host and bilinearly upsampled
on the device: exact to O((step * f'')^2), and the host ships
(H/step) * (W/step) values instead of a full frame.
"""
from __future__ import annotations

import torch


def coarse_shape(shape, step: int):
    """Coarse-grid shape covering `shape` with one sample beyond each
    edge so the bilinear stencil never reads out of range."""
    H, W = shape
    return (H - 1) // step + 2, (W - 1) // step + 2


def upsample_bilinear(g: torch.Tensor, shape, step: int) -> torch.Tensor:
    """Bilinearly upsample a coarse (gh, gw) grid sampled at pixel
    coordinates (i*step, j*step) onto the full (H, W) = `shape` frame,
    on g's device.  Fine index k reads coarse slots floor(k/step) and
    floor(k/step) + 1; g must have coarse_shape(shape, step)."""
    H, W = shape
    if step <= 1:
        return g[:H, :W]

    def up(gg, n, axis):
        f = torch.arange(n, dtype=torch.float32, device=gg.device) \
            * (1.0 / step)
        i0 = torch.floor(f).to(torch.int64)
        w = (f - i0).to(gg.dtype)
        g0 = torch.index_select(gg, axis, i0)
        g1 = torch.index_select(gg, axis, i0 + 1)
        wshape = [1, 1]
        wshape[axis] = n
        w = w.reshape(wshape)
        return g0 * (1 - w) + g1 * w

    return up(up(g, W, 1), H, 0)
