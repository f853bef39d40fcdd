"""Ray-surface math for torch tensors.

`imsim_tpu.optics.geometry` is JAX-free and written over an array
namespace `xp`; this module runs the same functions on torch tensors
through a small namespace shim (torch.maximum/where need tensor or
scalar operands in a fixed order, which the shim supplies).
"""
from __future__ import annotations

import torch

from imsim_tpu.optics import geometry as _G

NEWTON_POLISH = _G.NEWTON_POLISH


class _TorchNS:
    """The subset of an array namespace that geometry.py uses."""

    sqrt = staticmethod(torch.sqrt)
    abs = staticmethod(torch.abs)

    @staticmethod
    def maximum(a, b):
        if isinstance(b, torch.Tensor):
            return torch.maximum(a, b)
        return torch.clamp(a, min=b)

    @staticmethod
    def where(cond, a, b):
        return torch.where(cond, a, b)

    @staticmethod
    def asarray(a):
        return torch.as_tensor(a)


xp = _TorchNS()


def intersect(px, py, pz, vx, vy, vz, c, kappa, coefs):
    return _G.intersect(xp, px, py, pz, vx, vy, vz, c, kappa, coefs)


def surface_normal(x, y, c, kappa, coefs):
    return _G.surface_normal(xp, x, y, c, kappa, coefs)


def reflect(vx, vy, vz, nx, ny, nz):
    return _G.reflect(xp, vx, vy, vz, nx, ny, nz)


def refract(vx, vy, vz, nx, ny, nz, n1_over_n2):
    return _G.refract(xp, vx, vy, vz, nx, ny, nz, n1_over_n2)


def silica_index(wavelength_nm):
    return _G.silica_index(xp, wavelength_nm)


def air_index_excess(wavelength_nm, pressure_kpa, temperature_k,
                     h2o_pressure_kpa):
    return _G.air_index_excess(xp, wavelength_nm, pressure_kpa,
                               temperature_k, h2o_pressure_kpa)
