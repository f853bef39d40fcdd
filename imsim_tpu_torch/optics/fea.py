"""FEA / active-optics perturbations (imsim_tpu/optics/fea.py
counterpart, host numpy, the same code): the `fea` config surface of
`optics.loader.load_telescope`.

The measured optical response of each bending mode ships as mode tables
in `imsim_tpu_torch/data/fea/` (byte copies of the JAX package's, derived
from the AOS sensitivity matrix); a user projection of finite-element
grids can replace them from `<IMSIM_TPU_DATA_DIR>/fea/` (see
load_measured_fea).  A seeded modeled basis is the last resort when no
table resolves.  Config keys, units, angle parsing and composition order
are the JAX package's.

Supported terms (all composable, applied in config order):

  m1m3_gravity:      {zenith}                      [print-through]
  m1m3_temperature:  {m1m3_TBulk, m1m3_TxGrad, m1m3_TyGrad,
                      m1m3_TzGrad, m1m3_TrGrad}    [Celsius(/m)]
  m1m3_lut:          {zenith, error, seed}         [actuator LUT]
  m2_gravity:        {zenith}
  m2_temperature:    {m2_TzGrad, m2_TrGrad}
  camera_gravity:    {zenith, rotation}            [rigid-body sag]
  camera_temperature:{camera_TBulk}
  aos_dof:           {dof: 50 floats}              [AOS DOF vector]

The 50-element ``aos_dof`` vector follows the batoid_rubin convention:
  0    M2 dz [um]          1-2  M2 dx, dy [um]
  3-4  M2 rx, ry [arcsec]
  5    camera dz [um]      6-7  camera dx, dy [um]
  8-9  camera rx, ry [arcsec]
  10-29  M1M3 bending modes [um of surface]
  30-49  M2 bending modes [um of surface]

Zernike terms change the design's `zk`, which only the OPD and sag
outputs read (optics.opd); the rigid-body shifts and rotations move the
surfaces every trace sees.
"""
from __future__ import annotations

import hashlib
import os
from functools import lru_cache

import numpy as np

ARCSEC = np.pi / 180 / 3600
_JMIN, _JMAX = 4, 22          # Noll range of the modeled figure modes
_NJ = _JMAX - _JMIN + 1


# Mode tables, the coefficient-space projection the loader consumes
# (physical amplitudes included):
#
#   <data_dir>/fea/m1m3_modes.npz
#       jmin                   scalar Noll start index
#       m1_gravity, m3_gravity (2, NJ)  [m]: coef = sin(z)*row0
#                                             + (cos z - 1)*row1
#       m1_temp,    m3_temp    (5, NJ)  [m per unit arg]: rows follow
#                                        M1M3_TEMP_KEYS order
#       m1_bending, m3_bending (20, NJ) [m per um of mode amplitude]
#   <data_dir>/fea/m2_modes.npz
#       jmin; m2_gravity (2, NJ); m2_temp (2, NJ) [M2_TEMP_KEYS order];
#       m2_bending (20, NJ)
#   <data_dir>/fea/camera.npz
#       gravity_lat_m, gravity_ax_m, temp_dz_m_per_C  scalars


def _load_npz(path):
    if not os.path.isfile(path):
        return None
    with np.load(path) as z:
        return {k: np.asarray(z[k]) for k in z.files}


@lru_cache(maxsize=4)
def load_measured_fea(data_dir: str | None = None) -> dict | None:
    """Measured FEA mode tables from `<data_dir>/fea/`, or None; cached
    per directory.  Default: IMSIM_TPU_DATA_DIR / IMSIM_DATA_DIR when it
    holds a `fea/` directory, else the tables shipped with the port."""
    if data_dir is None:
        from ..meta_data import data_dir as _dd
        data_dir = _dd()
        if not data_dir or not os.path.isdir(
                os.path.join(data_dir, "fea")):
            data_dir = os.path.join(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))), "data")
    if not data_dir:
        return None
    base = os.path.join(data_dir, "fea")
    m13 = _load_npz(os.path.join(base, "m1m3_modes.npz"))
    m2 = _load_npz(os.path.join(base, "m2_modes.npz"))
    cam = _load_npz(os.path.join(base, "camera.npz"))
    if m13 is None and m2 is None and cam is None:
        return None
    return {"m1m3": m13, "m2": m2, "camera": cam}


def parse_angle(v) -> float:
    """Angle in radians from a float (radians) or a unit-ful string
    ('30 deg', '12 arcsec', '0.1 rad') — the reference parses *_angle
    args through galsim's Angle machinery (telescope_loader.py:110-114).
    """
    if isinstance(v, str):
        parts = v.split()
        x = float(parts[0])
        unit = parts[1].lower() if len(parts) > 1 else "rad"
        scale = {"deg": np.pi / 180, "degree": np.pi / 180,
                 "degrees": np.pi / 180, "rad": 1.0, "radians": 1.0,
                 "arcsec": ARCSEC, "arcmin": 60 * ARCSEC,
                 "hour": np.pi / 12, "hours": np.pi / 12}[unit]
        return x * scale
    return float(v)


def _basis(tag: str, n_modes: int = 1) -> np.ndarray:
    """(n_modes, _NJ) deterministic unit-RMS figure modes for a named
    term: reproducible across runs/processes (sha256, not hash())."""
    seed = int.from_bytes(hashlib.sha256(tag.encode()).digest()[:4],
                          "little")
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(n_modes, _NJ))
    # low-order dominated: FEA figure errors are smooth
    B *= (1.0 / np.arange(1, _NJ + 1)) ** 0.7
    B /= np.sqrt((B ** 2).sum(axis=1, keepdims=True))
    return B


def _zern(surfs, coef_m, jmin=_JMIN):
    """One instruction: add Zernike figure [m] (Noll j=jmin..) to each
    listed surface."""
    return [("zern", s, np.asarray(coef_m, float), jmin) for s in surfs]


def _grav(G: np.ndarray, zenith: float) -> np.ndarray:
    """sin/cos-zenith decomposition of a gravity mode pair: zero at
    the build orientation (zenith = 0)."""
    return np.sin(zenith) * G[0] + (np.cos(zenith) - 1.0) * G[1]


def _m1m3_gravity_pair(meas):
    """((G_m1, G_m3), jmin): measured if available, else the modeled
    0.4-um-rms-at-horizon basis split 0.7/0.3 across the substrate."""
    if meas and meas.get("m1m3") is not None:
        d = meas["m1m3"]
        return (d["m1_gravity"], d["m3_gravity"]), int(d["jmin"])
    B = 0.4e-6 * _basis("m1m3_gravity", 2)
    return (0.7 * B, 0.3 * B), _JMIN


def _m1m3_gravity_coef(zenith: float) -> np.ndarray:
    """Zenith-dependent print-through, zero at the build orientation
    (zenith = 0): sin/cos-zenith decomposition of the gravity vector,
    ~0.4 um rms surface at horizon (batoid_rubin m1m3 FEA scale).
    Modeled-basis form, kept for the LUT-cancellation path."""
    B = _basis("m1m3_gravity", 2)
    return 0.4e-6 * _grav(B, zenith)


M1M3_TEMP_KEYS = ("m1m3_TBulk", "m1m3_TxGrad", "m1m3_TyGrad",
                  "m1m3_TzGrad", "m1m3_TrGrad")
M2_TEMP_KEYS = ("m2_TzGrad", "m2_TrGrad")


def fea_instructions(fea_cfg: dict, measured: dict | None = None) -> list:
    """Translate an fea config dict into an ordered instruction list:
    ("zern", surface, coef_m, start_j) | ("shift", optic, dxyz_m) |
    ("rot", optic, axis, angle_rad).  Surfaces named 'M1'/'M2'/'M3'/
    'LSSTCamera' are resolved by the loader's OPTIC_SURFACES aliases.

    `measured` overrides the mode tables (see load_measured_fea);
    default: the data-dir drop-in if present, else the modeled basis.
    """
    meas = measured if measured is not None else load_measured_fea()
    m13 = (meas or {}).get("m1m3")
    m2d = (meas or {}).get("m2")
    camd = (meas or {}).get("camera")

    def m13_pair(key_modeled, n, scale, key_meas):
        """((C_m1, C_m3), jmin) mode tables for an m1m3 term."""
        if m13 is not None and f"m1_{key_meas}" in m13:
            return (m13[f"m1_{key_meas}"], m13[f"m3_{key_meas}"]), \
                int(m13["jmin"])
        B = scale * _basis(key_modeled, n)
        return (0.7 * B, 0.3 * B), _JMIN

    def m2_table(key_modeled, n, scale, key_meas):
        if m2d is not None and f"m2_{key_meas}" in m2d:
            return m2d[f"m2_{key_meas}"], int(m2d["jmin"])
        return scale * _basis(key_modeled, n), _JMIN

    out = []
    for term, args in fea_cfg.items():
        args = dict(args or {})
        if term in ("m1m3_gravity", "m1m3_lut"):
            # the LUT cancels the gravity print-through (imperfectly if
            # a fractional actuator error is requested)
            z = parse_angle(args["zenith"])
            (G1, G3), jmin = m13_pair("m1m3_gravity", 2, 0.4e-6,
                                      "gravity")
            sign = 1.0 if term == "m1m3_gravity" else -1.0
            c1, c3 = sign * _grav(G1, z), sign * _grav(G3, z)
            err = float(args.get("error", 0.0))
            if term == "m1m3_lut" and err:
                rng = np.random.default_rng(int(args.get("seed", 0)))
                c1 = c1 * (1.0 + err * rng.normal(size=c1.shape))
                c3 = c3 * (1.0 + err * rng.normal(size=c3.shape))
            out += _zern(("M1",), c1, jmin) + _zern(("M3",), c3, jmin)
        elif term == "m1m3_temperature":
            (T1, T3), jmin = m13_pair("m1m3_temperature", 5, 0.1e-6,
                                      "temp")
            a = np.array([float(args.get(k, 0.0))
                          for k in M1M3_TEMP_KEYS])
            out += _zern(("M1",), a @ T1, jmin) \
                + _zern(("M3",), a @ T3, jmin)
        elif term == "m2_gravity":
            z = parse_angle(args["zenith"])
            G, jmin = m2_table("m2_gravity", 2, 0.15e-6, "gravity")
            out += _zern(("M2",), _grav(G, z), jmin)
        elif term == "m2_temperature":
            T, jmin = m2_table("m2_temperature", 2, 0.05e-6, "temp")
            a = np.array([float(args.get(k, 0.0)) for k in M2_TEMP_KEYS])
            out += _zern(("M2",), a @ T, jmin)
        elif term == "camera_gravity":
            z = parse_angle(args["zenith"])
            rot = parse_angle(args.get("rotation", 0.0))
            # lateral camera sag rotates with the rotator; axial sag
            # follows cos(zenith); few-micron scale
            lat_m = float(camd["gravity_lat_m"]) if camd is not None \
                else 5e-6
            ax_m = float(camd["gravity_ax_m"]) if camd is not None \
                else 2e-6
            lat = lat_m * np.sin(z)
            dx = lat * np.cos(rot)
            dy = lat * np.sin(rot)
            dz = -ax_m * (np.cos(z) - 1.0)
            out.append(("shift", "LSSTCamera", np.array([dx, dy, dz])))
        elif term == "camera_temperature":
            tb = float(args.get("camera_TBulk", 0.0))
            k = float(camd["temp_dz_m_per_C"]) if camd is not None \
                else 1e-6
            out.append(("shift", "LSSTCamera",
                        np.array([0.0, 0.0, k * tb])))
        elif term == "aos_dof":
            dof = np.asarray(args["dof"], float)
            if dof.shape != (50,):
                raise ValueError("aos_dof.dof must have 50 elements")
            um = 1e-6
            out.append(("shift", "M2",
                        np.array([dof[1], dof[2], dof[0]]) * um))
            out.append(("rot", "M2", "x", dof[3] * ARCSEC))
            out.append(("rot", "M2", "y", dof[4] * ARCSEC))
            out.append(("shift", "LSSTCamera",
                        np.array([dof[6], dof[7], dof[5]]) * um))
            out.append(("rot", "LSSTCamera", "x", dof[8] * ARCSEC))
            out.append(("rot", "LSSTCamera", "y", dof[9] * ARCSEC))
            (B1, B3), jmin13 = m13_pair("m1m3_bending", 20, 1.0,
                                        "bending")
            out += _zern(("M1",), (dof[10:30] @ B1) * um, jmin13) \
                + _zern(("M3",), (dof[10:30] @ B3) * um, jmin13)
            B2, jmin2 = m2_table("m2_bending", 20, 1.0, "bending")
            out += _zern(("M2",), (dof[30:50] @ B2) * um, jmin2)
        else:
            raise ValueError(f"unknown fea term '{term}' (supported: "
                             "m1m3_gravity, m1m3_temperature, m1m3_lut, "
                             "m2_gravity, m2_temperature, camera_gravity, "
                             "camera_temperature, aos_dof)")
    return out
