"""Telescope prescription as one parameter matrix
(imsim_tpu/optics/telescope.py counterpart).

The port holds a detector's telescope as the (S, 16+K) float32 surface
matrix of `imsim_tpu.ops.raychain._surf_matrix` — per surface
[c, kappa, coefs(K), ap_lo, ap_hi, vtx_x, vtx_y, vtx_z, rot(9)] — plus
the static surface kinds.  Both the K2 kernel and its plain twin read
this one block; perturbations are applied by the JAX package before the
matrix crosses (`convert.telescope_from_numpy`).
"""
from __future__ import annotations

import dataclasses

import numpy as np

MIRROR, REFRACT_IN, REFRACT_OUT, DETECTOR = 0, 1, 2, 3
N_COEF = 4


@dataclasses.dataclass(frozen=True)
class Telescope:
    surf: np.ndarray   # (S, 16 + N_COEF) float32, host
    kinds: tuple

    @property
    def n_coef(self) -> int:
        return self.surf.shape[1] - 16

    def surface(self, i: int):
        """(c, kappa, coefs, ap_lo, ap_hi, vtx3, rot9) of surface i as
        python floats (the float32 values)."""
        row = [float(v) for v in self.surf[i]]
        K = self.n_coef
        return (row[0], row[1], tuple(row[2:2 + K]), row[2 + K],
                row[3 + K], tuple(row[4 + K:7 + K]),
                tuple(row[7 + K:16 + K]))

    def newton_steps(self, i: int) -> int:
        """Newton polish steps of surface i: NEWTON_POLISH, +2 on an
        asphere (optics.geometry.intersect)."""
        from .geometry import NEWTON_POLISH

        aspheric = bool(np.any(self.surf[i, 2:2 + self.n_coef] != 0.0))
        return NEWTON_POLISH + (2 if aspheric else 0)


def surf_matrix(z0, c, kappa, coefs, aper, shift, rot) -> np.ndarray:
    """The (S, 16+K) float32 block from per-surface arrays (the layout of
    imsim_tpu.ops.raychain._surf_matrix)."""
    S = len(z0)
    f = lambda a: np.asarray(a, np.float32)
    sh = f(shift)
    vtx = np.stack([sh[:, 0], sh[:, 1], f(z0) + sh[:, 2]], axis=1)
    return np.concatenate([f(c).reshape(S, 1), f(kappa).reshape(S, 1),
                           f(coefs), f(aper), vtx,
                           f(rot).reshape(S, 9)], axis=1)
