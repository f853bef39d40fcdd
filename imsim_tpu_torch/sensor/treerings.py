"""Tree-ring displacement model (imsim_tpu/sensor/treerings.py
counterpart, host numpy).

The same model family per detector, generated deterministically
(sha256-seeded `_rng_for`, drawn in the JAX package's order so every
parameter is bit-equal): radial displacement
    dr(r) = cumulative-integral of sum_k A_k (a + b r^4) sin(2 pi r / T_k + phi_k)
at ~0.02 px rms with 95-210 px periods, the ring centre a few thousand
pixels off a sensor corner.  A measured tree_ring_parameters file is
read instead when given.  `SiliconParams.make(treering_model=...)` takes
a model's center, profile, waves and env.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..utils.lookup import UniformTable


def _rng_for(det_name: str) -> np.random.Generator:
    h = hashlib.sha256(f"treering:{det_name}".encode()).digest()
    return np.random.default_rng(int.from_bytes(h[:8], "little"))


class TreeRingModel:
    """Per-detector ring center + radial displacement profile."""

    def __init__(self, det_name: str, r_max: float = 8000.0,
                 n_points: int = 2048):
        self.det_name = det_name
        self.r_max = r_max
        rng = _rng_for(det_name)
        # center: outside the sensor, a few kpx off one of the 4 corners
        corner = rng.integers(0, 4)
        cx = rng.uniform(2000.0, 7000.0)
        cy = rng.uniform(2000.0, 7000.0)
        sx = -1.0 if corner in (0, 3) else 1.0
        sy = -1.0 if corner in (0, 1) else 1.0
        # sensor ~4k: put center offset from the [0,4k] box
        self.center = (2048.0 + sx * cx, 2048.0 + sy * cy)

        # 40 sinusoidal components of the *doping variation*; the
        # displacement profile is its integral, with an (a + b r^4)
        # radial envelope like the measured data
        nfreq = 40
        periods = rng.uniform(95.0, 210.0, nfreq)        # pixels
        phases = rng.uniform(0, 2 * np.pi, nfreq)
        amps = rng.lognormal(np.log(0.25), 0.5, nfreq) / nfreq
        r = np.linspace(0.0, r_max, n_points)
        a_env, b_env = 1.0, 1.0 / 8000.0**4
        wave = np.zeros_like(r)
        for T, ph, A in zip(periods, phases, amps):
            wave += A * np.sin(2 * np.pi * r / T + ph)
        profile = wave * (a_env + b_env * r**4)
        # overall amplitude: ~0.02 px rms displacement (measured scale)
        rms = np.std(profile[n_points // 4:])
        norm = 0.02 / max(rms, 1e-9)
        profile *= norm
        self.profile = profile.astype(np.float32)
        self.table = UniformTable(0.0, r_max / (n_points - 1),
                                  torch.from_numpy(self.profile))
        # analytic parameters of the device evaluation
        # (sensor.silicon SiliconParams.tr_waves/tr_env): rows of
        # (2*pi/period, phase, amplitude) + envelope (a, b, norm)
        self.waves = np.stack([2 * np.pi / periods, phases, amps],
                              axis=1).astype(np.float32)
        self.env = (a_env, b_env, norm)

    def radial_displacement(self, r):
        return self.table(torch.as_tensor(np.asarray(r, np.float32)))


class MeasuredTreeRingModel:
    """Per-detector model built from a measured parameter block (the
    reference's tree_ring_parameters text format,
    imsim/treerings.py:14-68,100-195):

        dr(r) = 0.01 * (A + B r^4) * [ sum_j sin(2 pi r/cf_j + cp_j) cf_j/(2 pi)
                                     + sum_j -cos(2 pi r/sf_j + sp_j) sf_j/(2 pi) ]

    Exposes the same attributes as the generated TreeRingModel
    (center, profile, table, waves, env, r_max) so SiliconParams.make
    consumes either interchangeably.
    """

    def __init__(self, det_name, center, A, B, cfreqs, cphases, sfreqs,
                 sphases, r_max=8000.0, n_points=2668):
        self.det_name = det_name
        self.center = center
        self.r_max = r_max
        # -cos(x + p) == sin(x + p - pi/2): fold both series into one
        # (omega, phase, amplitude) wave table for the analytic sensor
        omg = np.concatenate([2 * np.pi / cfreqs, 2 * np.pi / sfreqs])
        ph = np.concatenate([cphases, sphases - np.pi / 2])
        amp = np.concatenate([cfreqs, sfreqs]) / (2 * np.pi)
        self.waves = np.stack([omg, ph, amp], axis=1).astype(np.float32)
        self.env = (float(A), float(B), 0.01)
        r = np.linspace(0.0, r_max, n_points)
        wave = np.zeros_like(r)
        for w, p, a in self.waves:
            wave += a * np.sin(w * r + p)
        self.profile = (0.01 * (A + B * r**4) * wave).astype(np.float32)
        self.table = UniformTable(0.0, r_max / (n_points - 1),
                                  torch.from_numpy(self.profile))

    def radial_displacement(self, r):
        return self.table(torch.as_tensor(np.asarray(r, np.float32)))


def read_tree_ring_parameters(file_name, only_dets=None, numfreqs=20,
                              r_max=8000.0):
    """Parse the reference's tree_ring_parameters text file
    (imsim/treerings.py:120-136 block layout: per detector, a title
    line, an 8-item 'Rx Ry Sx Sy Cx Cy A B' line, a column-header line,
    then `numfreqs` rows of cfreq cphase sfreq sphase).  Returns
    {det_name: MeasuredTreeRingModel}."""
    with open(file_name) as f:
        lines = f.readlines()
    block = numfreqs + 3
    out = {}
    for i in range(len(lines) // block):
        rows = lines[i * block:(i + 1) * block]
        items = rows[1].split()
        det = "R%s%s_S%s%s" % tuple(items[:4])
        if only_dets and det not in only_dets:
            continue
        cx = float(items[4]) + 2048.5
        cy = float(items[5]) + 2048.5
        A, B = float(items[6]), float(items[7])
        freq = np.array([[float(v) for v in r.split()] for r in rows[3:]])
        out[det] = MeasuredTreeRingModel(
            det, (cx, cy), A, B, freq[:, 0], freq[:, 1], freq[:, 2],
            freq[:, 3], r_max=r_max)
    return out


class TreeRings:
    """Lazy per-detector cache (imsim/treerings.py:169-195 reads lazily
    because loading all 189 profiles eagerly costs ~30 s in the
    reference; generation here is ~1 ms per detector but the same lazy
    interface is kept).

    With `file_name` the measured tree_ring_parameters format is parsed
    and served (the reference's drop-in data path); without it, the
    deterministic generated models are used."""

    def __init__(self, only_dets=None, defer_load=True, file_name=None):
        self._cache: dict[str, TreeRingModel] = {}
        self._measured = None
        if file_name:
            self._measured = read_tree_ring_parameters(
                file_name, only_dets=set(only_dets) if only_dets else None)
        if only_dets and not defer_load:
            for d in only_dets:
                self.get(d)

    def get(self, det_name: str):
        if self._measured is not None:
            return self._measured[det_name]
        if det_name not in self._cache:
            self._cache[det_name] = TreeRingModel(det_name)
        return self._cache[det_name]

    def get_center(self, det_name: str):
        return self.get(det_name).center

    def get_func(self, det_name: str):
        return self.get(det_name).table
