"""Rubin telescope prescription, perturbation API and the surface matrix
(imsim_tpu/optics/telescope.py counterpart).

`TelescopeDesign` is the host description: float64 per-surface arrays
(z0, c, kappa, coefs, aper, shift, rot, zk) with the surface kinds and
names, built by `make_telescope` from `rubin_prescription` (the JAX
package's numbers, copied) and perturbed with `with_shift`, `with_rot`,
`with_zernikes` and `with_focus_shift`.  The trace reads a detector's
telescope as `Telescope`: the (S, 16+K) surface matrix of
`imsim_tpu.ops.raychain._surf_matrix` — per surface [c, kappa, coefs(K),
ap_lo, ap_hi, vtx_x, vtx_y, vtx_z, rot(9)] — plus the kinds.  The K2
kernel and its plain twin read the float32 block (`design.matrix()`);
the host trace behind the WCS reads the float64 one
(`design.matrix(np.float64)`).  `zk` rides in the design; neither
package's photon chain reads it (its textures belong to the OPD maps).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

MIRROR, REFRACT_IN, REFRACT_OUT, DETECTOR = 0, 1, 2, 3
# media tags: what the ray is in *after* the surface
N_COEF = 4   # even-asphere coefficients r^4 ... r^(4+2(N_COEF-1))
N_ZK = 29    # Zernike perturbation coefficients (Noll 1..N_ZK)


@dataclasses.dataclass(frozen=True)
class Telescope:
    surf: np.ndarray   # (S, 16 + N_COEF) float32 (K2) or float64 (host)
    kinds: tuple

    @property
    def n_coef(self) -> int:
        return self.surf.shape[1] - 16

    def surface(self, i: int):
        """(c, kappa, coefs, ap_lo, ap_hi, vtx3, rot9) of surface i as
        python floats (the matrix's values: float32-rounded on the
        photon path, float64 in the host trace)."""
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


def surf_matrix(z0, c, kappa, coefs, aper, shift, rot,
                dtype=np.float32) -> np.ndarray:
    """The (S, 16+K) block from per-surface arrays (the layout of
    imsim_tpu.ops.raychain._surf_matrix), in `dtype`: float32 for K2,
    float64 for the host trace (the vertex z = z0 + shift_z is then
    the float64 sum the JAX package's host trace forms)."""
    S = len(z0)
    f = lambda a: np.asarray(a, dtype)  # noqa: E731
    sh = f(shift)
    vtx = np.stack([sh[:, 0], sh[:, 1], f(z0) + sh[:, 2]], axis=1)
    return np.concatenate([f(c).reshape(S, 1), f(kappa).reshape(S, 1),
                           f(coefs), f(aper), vtx,
                           f(rot).reshape(S, 9)], axis=1)


@dataclasses.dataclass(frozen=True)
class TelescopeDesign:
    """Per-surface float64 parameter arrays (S surfaces, ray order).

    z0:     (S,) vertex z [m]
    c:      (S,) curvature 1/R [1/m] (0 = plane)
    kappa:  (S,) conic constant
    coefs:  (S, N_COEF) even asphere coefficients
    aper:   (S, 2) inner/outer aperture radius [m]
    shift:  (S, 3) rigid-body decenter [m]
    rot:    (S, 3, 3) rigid-body rotation about the (shifted) vertex
    zk:     (S, N_ZK) Zernike sag perturbation [m], Noll-indexed, over
            the unit disk r/aper_out
    """

    z0: np.ndarray
    c: np.ndarray
    kappa: np.ndarray
    coefs: np.ndarray
    aper: np.ndarray
    shift: np.ndarray
    rot: np.ndarray
    zk: np.ndarray
    kinds: tuple
    names: tuple

    # ---- perturbation API ----------------------------------------------
    def _idx(self, name):
        return self.names.index(name)

    def _update(self, **kw):
        return dataclasses.replace(self, **kw)

    def with_shift(self, name, dxyz):
        i = self._idx(name)
        shift = np.array(self.shift)
        shift[i] += np.asarray(dxyz, shift.dtype)
        return self._update(shift=shift)

    def with_rot(self, name, axis: str, angle_rad: float):
        i = self._idx(name)
        c, s = np.cos(angle_rad), np.sin(angle_rad)
        if axis == "x":
            R = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
        elif axis == "y":
            R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        else:
            R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        rot = np.array(self.rot)
        rot[i] = R @ rot[i]
        return self._update(rot=rot.astype(self.rot.dtype))

    def with_zernikes(self, name, coef_m, start_j=1):
        """Add Zernike sag perturbation (meters, Noll j=start_j..)."""
        i = self._idx(name)
        zk = np.array(self.zk)
        zk[i, start_j - 1:start_j - 1 + len(coef_m)] += \
            np.asarray(coef_m, zk.dtype)
        return self._update(zk=zk)

    def with_focus_shift(self, dz):
        """Shift the detector along z (focusZ / per-detector offset)."""
        i = self.kinds.index(DETECTOR)
        z0 = np.array(self.z0)
        z0[i] += dz
        return self._update(z0=z0)

    @property
    def det_z(self):
        return self.z0[self.kinds.index(DETECTOR)]

    def matrix(self, dtype=np.float32) -> Telescope:
        """The surface matrix in `dtype` with the kinds."""
        return Telescope(surf=surf_matrix(self.z0, self.c, self.kappa,
                                          self.coefs, self.aper, self.shift,
                                          self.rot, dtype),
                         kinds=tuple(self.kinds))

    @functools.cached_property
    def host(self) -> Telescope:
        """The float64 matrix of the host trace (built once)."""
        return self.matrix(np.float64)


def _surface(name, kind, z0, R=np.inf, kappa=0.0, coefs=(), aper=(0.0, 5.0)):
    c = 0.0 if not np.isfinite(R) else 1.0 / R
    co = np.zeros(N_COEF)
    co[: len(coefs)] = coefs
    return dict(name=name, kind=kind, z0=z0, c=c, kappa=kappa, coefs=co,
                aper=np.asarray(aper, float))


def rubin_prescription():
    """Surface list in ray order (rays travel -z from the sky, reflect
    up off M1, down off M2, up off M3 through the camera to the
    detector, which faces down at z ~ +4.57): the published Rubin
    first-order values refined to the design figures of merit (EFL
    10.307 m, 0.2 arcsec per 10 um pixel), the JAX package's numbers."""
    s = []
    s.append(_surface("M1", MIRROR, 0.0, R=19.835, kappa=-1.215,
                      coefs=(-1.6204189e-8, 1.3025030e-9),
                      aper=(2.558, 4.18)))
    s.append(_surface("M2", MIRROR, 6.1023286, R=6.8129645, kappa=0.078,
                      coefs=(-1.2394887e-4, 1.6263578e-5),
                      aper=(0.9, 1.71)))
    s.append(_surface("M3", MIRROR, -0.2338, R=8.4772206, kappa=0.0078910,
                      coefs=(3.3411739e-5, 1.1272920e-6),
                      aper=(0.55, 2.508)))
    # camera (all fused silica)
    s.append(_surface("L1_entrance", REFRACT_IN, 3.576994, R=2.824,
                      aper=(0.0, 0.775)))
    s.append(_surface("L1_exit", REFRACT_OUT, 3.659194, R=5.021,
                      aper=(0.0, 0.775)))
    s.append(_surface("L2_entrance", REFRACT_IN, 3.989194, R=np.inf,
                      aper=(0.0, 0.551)))
    s.append(_surface("L2_exit", REFRACT_OUT, 4.019194, R=2.529,
                      aper=(0.0, 0.551)))
    s.append(_surface("Filter_entrance", REFRACT_IN, 4.330694, R=5.632,
                      aper=(0.0, 0.378)))
    s.append(_surface("Filter_exit", REFRACT_OUT, 4.346594, R=5.530,
                      aper=(0.0, 0.378)))
    s.append(_surface("L3_entrance", REFRACT_IN, 4.416694, R=3.169,
                      aper=(0.0, 0.361)))
    s.append(_surface("L3_exit", REFRACT_OUT, 4.476694, R=-13.36,
                      aper=(0.0, 0.361)))
    # the focal plane is not a circular stop: the corner of the science
    # array reaches r = 0.37 m (field 2.05 deg)
    s.append(_surface("Detector", DETECTOR, 4.565494, R=np.inf,
                      aper=(0.0, 0.45)))
    return s


def make_telescope(surfaces=None, dtype=np.float64) -> TelescopeDesign:
    surfaces = surfaces if surfaces is not None else rubin_prescription()
    S = len(surfaces)
    eye = np.broadcast_to(np.eye(3), (S, 3, 3)).copy()
    return TelescopeDesign(
        z0=np.asarray([s["z0"] for s in surfaces], dtype),
        c=np.asarray([s["c"] for s in surfaces], dtype),
        kappa=np.asarray([s["kappa"] for s in surfaces], dtype),
        coefs=np.asarray(np.stack([s["coefs"] for s in surfaces]), dtype),
        aper=np.asarray(np.stack([s["aper"] for s in surfaces]), dtype),
        shift=np.zeros((S, 3), dtype),
        rot=np.asarray(eye, dtype),
        zk=np.zeros((S, N_ZK), dtype),
        kinds=tuple(s["kind"] for s in surfaces),
        names=tuple(s["name"] for s in surfaces),
    )
