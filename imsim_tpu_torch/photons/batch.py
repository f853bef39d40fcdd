"""Device photon batches (imsim_tpu/photons/batch.py counterpart): a
struct of (N,) tensors.  Dead photons carry flux == 0."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PhotonBatch:
    """x, y: pixel coordinates (integers are pixel centres); flux:
    electrons (0 = dead); wavelength: nm; dxdz, dydz: slopes inside the
    silicon; pupil_u/v: metres; time: seconds from exposure start."""

    x: torch.Tensor
    y: torch.Tensor
    flux: torch.Tensor
    wavelength: torch.Tensor
    dxdz: torch.Tensor
    dydz: torch.Tensor
    pupil_u: torch.Tensor
    pupil_v: torch.Tensor
    time: torch.Tensor

    @property
    def n(self) -> int:
        return self.x.shape[0]

    def slice(self, start: int, stop: int) -> "PhotonBatch":
        """Photons [start, stop) of every field (views, no copy)."""
        return PhotonBatch(**{f.name: getattr(self, f.name)[start:stop]
                              for f in dataclasses.fields(self)})
