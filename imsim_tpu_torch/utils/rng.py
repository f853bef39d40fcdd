"""RNG discipline of the port (imsim_tpu/utils/rng.py counterpart).

Every random stream is a `torch.Generator` seeded from a stable hash of
(visit seed, purpose tags), so streams are reproducible regardless of
execution order.  A generator lives on the device whose tensors it fills
(Philox on CUDA, MT19937 on the CPU): the port never draws on one device
and copies to another.  Its numbers differ from JAX's threefry by
construction, so parity tests feed both packages the same numpy draws.
"""
from __future__ import annotations

import hashlib

import torch

# Offset the reference applies for the atmosphere's private stream
# (imsim/atmPSF.py:415: ``seed = seed + 271828``).
ATM_SEED_OFFSET = 271828


def _tag_to_int(tag) -> int:
    """Stable 31-bit integer from a purpose string (sha256, not hash())."""
    if isinstance(tag, str):
        h = hashlib.sha256(tag.encode()).digest()
        return int.from_bytes(h[:4], "little") & 0x7FFFFFFF
    return int(tag)


def stream_seed(seed: int, *tags) -> int:
    """63-bit generator seed for (seed, *tags)."""
    words = [int(seed)] + [_tag_to_int(t) for t in tags]
    h = hashlib.sha256(",".join(map(str, words)).encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def stream(seed: int, *tags, device) -> torch.Generator:
    """Named random stream on `device`, e.g.
    ``stream(seed, "photons", b, device="cuda")``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(stream_seed(seed, *tags))
    return g


def uniform(gen: torch.Generator, n: int, lo: float = 0.0,
            hi: float = 1.0) -> torch.Tensor:
    """(n,) float32 uniform draws on the generator's device."""
    u = torch.rand(n, generator=gen, device=gen.device, dtype=torch.float32)
    if lo != 0.0 or hi != 1.0:
        u = u * (hi - lo) + lo
    return u


def normal(gen: torch.Generator, n: int) -> torch.Tensor:
    """(n,) float32 standard normal draws on the generator's device."""
    return torch.randn(n, generator=gen, device=gen.device,
                       dtype=torch.float32)


def poisson_approx(gen: torch.Generator, lam: torch.Tensor) -> torch.Tensor:
    """Poisson draws that stay fast for the large means of sky and bright
    stars (imsim_tpu.utils.rng.poisson_approx): an exact draw from
    `gen` below 1000, the rounded Gaussian lam + sqrt(lam) N(0, 1) from
    1000 up (error < 0.1% of sigma there).  float32, on lam's device."""
    lam = lam.to(torch.float32)
    small = torch.poisson(torch.clamp(lam, min=0.0, max=1000.0),
                          generator=gen)
    gauss = lam + torch.sqrt(torch.clamp(lam, min=1e-12)) * torch.randn(
        lam.shape, generator=gen, device=lam.device, dtype=torch.float32)
    return torch.where(lam <= 1000.0, small, torch.round(gauss))
