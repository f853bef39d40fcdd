"""Chromatic photon operators (imsim_tpu/photons/ops.py counterpart;
the slice needs only the silicon index)."""
from __future__ import annotations

import torch


def silicon_index(wave_nm: torch.Tensor) -> torch.Tensor:
    """Refractive index of silicon over 300-1100 nm (polynomial fit)."""
    w = torch.clamp(wave_nm, 300.0, 1100.0) * 1e-3  # microns
    return 3.42 + 0.159 / w**2 + 0.0324 / w**4
