"""The synthetic tree-ring model's parameters (copy of
imsim_tpu_torch/sensor/treerings.py's TreeRingModel; host numpy): per
detector, a sha256-seeded ring centre a few thousand pixels off a
sensor corner and 40 sinusoids of 95-210 px periods under an
(a + b r^4) envelope, normalised to about 0.02 px rms of radial
displacement."""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class TreeRings:
    center: tuple       # (cx, cy) pixels
    waves: np.ndarray   # (40, 3) float32: 2 pi / period, phase, amplitude
    env: tuple          # (a, b, norm)


def _rng_for(det_name: str) -> np.random.Generator:
    h = hashlib.sha256(f"treering:{det_name}".encode()).digest()
    return np.random.default_rng(int.from_bytes(h[:8], "little"))


def model(det_name: str, r_max: float = 8000.0,
          n_points: int = 2048) -> TreeRings:
    rng = _rng_for(det_name)
    corner = rng.integers(0, 4)
    cx = rng.uniform(2000.0, 7000.0)
    cy = rng.uniform(2000.0, 7000.0)
    sx = -1.0 if corner in (0, 3) else 1.0
    sy = -1.0 if corner in (0, 1) else 1.0
    center = (2048.0 + sx * cx, 2048.0 + sy * cy)
    nfreq = 40
    periods = rng.uniform(95.0, 210.0, nfreq)
    phases = rng.uniform(0, 2 * np.pi, nfreq)
    amps = rng.lognormal(np.log(0.25), 0.5, nfreq) / nfreq
    r = np.linspace(0.0, r_max, n_points)
    a_env, b_env = 1.0, 1.0 / 8000.0**4
    wave = np.zeros_like(r)
    for T, ph, A in zip(periods, phases, amps):
        wave += A * np.sin(2 * np.pi * r / T + ph)
    profile = wave * (a_env + b_env * r**4)
    norm = 0.02 / max(np.std(profile[n_points // 4:]), 1e-9)
    waves = np.stack([2 * np.pi / periods, phases, amps],
                     axis=1).astype(np.float32)
    return TreeRings(center=center, waves=waves, env=(a_env, b_env, norm))
