"""Device photon batches (imsim_tpu/photons/batch.py counterpart): a
struct of (N,) tensors.  Dead photons carry flux == 0."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PhotonBatch:
    """x, y: pixel coordinates (integers are pixel centres); flux:
    electrons (0 = dead); wavelength: nm; dxdz, dydz: slopes inside the
    silicon; pupil_u/v: metres; time: seconds from exposure start;
    abs_len: silicon absorption length [um] when the producer fetched it
    with the wavelength (else None: the silicon looks it up)."""

    x: torch.Tensor
    y: torch.Tensor
    flux: torch.Tensor
    wavelength: torch.Tensor
    dxdz: torch.Tensor
    dydz: torch.Tensor
    pupil_u: torch.Tensor
    pupil_v: torch.Tensor
    time: torch.Tensor
    abs_len: torch.Tensor | None = None

    @property
    def n(self) -> int:
        return self.x.shape[0]

    def slice(self, start: int, stop: int) -> "PhotonBatch":
        """Photons [start, stop) of every field (views, no copy)."""
        return PhotonBatch(**{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name)[start:stop]
            for f in dataclasses.fields(self)})

    def replace(self, **kw) -> "PhotonBatch":
        return dataclasses.replace(self, **kw)

    @classmethod
    def zeros(cls, n: int, dtype=torch.float32,
              device="cuda") -> "PhotonBatch":
        """n dead photons at 622.2 nm."""
        z = torch.zeros((n,), dtype=dtype, device=device)
        return cls(x=z, y=z, flux=z,
                   wavelength=torch.full((n,), 622.2, dtype=dtype,
                                         device=device),
                   dxdz=z, dydz=z, pupil_u=z, pupil_v=z, time=z)

    @classmethod
    def concat(cls, batches) -> "PhotonBatch":
        """Several batches pooled into one (a field that is None in any
        batch is None)."""
        def cat(name):
            vals = [getattr(b, name) for b in batches]
            if any(v is None for v in vals):
                return None
            return torch.cat(vals)

        return cls(**{f.name: cat(f.name) for f in dataclasses.fields(cls)})

    def scaled_flux(self, s) -> "PhotonBatch":
        return self.replace(flux=self.flux * s)

    def shifted(self, dx, dy) -> "PhotonBatch":
        return self.replace(x=self.x + dx, y=self.y + dy)

    def total_flux(self):
        return torch.sum(self.flux)
