"""Parametric AOS optics model (imsim_tpu/optics/aos.py counterpart,
host numpy, the same code): OpticalZernikes, the `doOpt` option of the
atmosphere input.

A sensitivity tensor (35 hexapolar field points x 19 annular Zernikes x
50 AOS degrees of freedom), synthesized deterministically or read from
the reference's measured optics_data files, times randomized mock AOS
deviations drawn per visit, gives the wavefront error at the sample
points; `coefficients` interpolates it over the field and `apply_to`
folds one field point into a mirror's Zernike figure.
"""
from __future__ import annotations

import hashlib

import numpy as np

N_FIELD = 35       # hexapolar field points (1 + 6 + 12 + 16-ish rings)
N_ZK = 19          # annular Zernikes j = 4..22
N_DOF = 50         # AOS degrees of freedom
FIELD_RADIUS_DEG = 1.75


def hexapolar_field_points():
    """(N_FIELD, 2) field sample coordinates [deg]."""
    pts = [(0.0, 0.0)]
    for r_frac, m in ((0.38, 6), (0.70, 12), (1.0, 16)):
        r = FIELD_RADIUS_DEG * r_frac
        for k in range(m):
            a = 2 * np.pi * k / m
            pts.append((r * np.cos(a), r * np.sin(a)))
    return np.array(pts[:N_FIELD])


def _det_rng(tag: str) -> np.random.Generator:
    h = hashlib.sha256(tag.encode()).digest()
    return np.random.default_rng(int.from_bytes(h[:8], "little"))


# --- measured optics_data drop-in loaders ----------------------------------
# (imsim/optical_system.py:221-224 loads the same three files)


def load_sensitivity_matrix(path: str) -> np.ndarray:
    """data/optics_data/sensitivity_matrix.txt -> (35, 19, 50): one
    50-float row per (field point, Zernike), '#' comments skipped."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                rows.append([float(v) for v in line.split()])
    M = np.asarray(rows, float)
    if M.shape != (N_FIELD * N_ZK, N_DOF):
        raise ValueError(f"{path}: expected {N_FIELD * N_ZK} x {N_DOF} "
                         f"rows, got {M.shape}")
    return M.reshape(N_FIELD, N_ZK, N_DOF)


def load_aos_deviation_scales(path: str) -> np.ndarray:
    """data/optics_data/aos_sim_results.txt -> (50,) per-DOF std over
    the closed-loop iterations (the reference's mock_deviations draws
    normal(0, std(results, axis=1)), optical_system.py:152-174)."""
    res = np.loadtxt(path, skiprows=1)
    if res.shape[0] != N_DOF:
        raise ValueError(f"{path}: expected {N_DOF} DOF rows, got "
                         f"{res.shape}")
    return np.std(res, axis=1)


def load_nominal_coeff(path: str) -> np.ndarray:
    """data/optics_data/annular_nominal_coeff.txt -> (N_FIELD, N_ZK)
    Zemax nominal coefficients (stored transposed, 19 x 35)."""
    arr = np.loadtxt(path)
    if arr.shape != (N_ZK, N_FIELD):
        raise ValueError(f"{path}: expected {N_ZK} x {N_FIELD}, got "
                         f"{arr.shape}")
    return arr.T


def synth_sensitivity_matrix() -> np.ndarray:
    """(N_FIELD, N_ZK, N_DOF) nm-of-wavefront per unit DOF motion.

    Structure matching the measured matrix: each DOF excites a few
    low-order Zernikes with smooth (constant / linear / quadratic)
    field dependence; amplitudes fall off with Zernike order."""
    rng = _det_rng("imsim_tpu-aos-sensitivity-v1")
    pts = hexapolar_field_points() / FIELD_RADIUS_DEG
    fx, fy = pts[:, 0], pts[:, 1]
    basis = np.stack([np.ones_like(fx), fx, fy, fx * fy,
                      fx**2 - fy**2, fx**2 + fy**2], axis=-1)  # (F, 6)
    M = np.zeros((N_FIELD, N_ZK, N_DOF))
    for d in range(N_DOF):
        # each DOF couples to ~4 Zernikes
        for j in rng.choice(N_ZK, size=4, replace=False):
            amp = 50.0 * np.exp(-0.25 * j) * rng.normal()  # nm / unit
            w = rng.normal(0, [1.0, 0.5, 0.5, 0.25, 0.25, 0.25])
            M[:, j, d] += amp * basis @ w
    return M


def mock_deviations(seed: int = 42) -> np.ndarray:
    """(N_DOF,) randomized AOS state (imsim/optical_system.py:152-174
    draws per-DOF-scale random offsets): rigid-body microns/arcsec for
    M2+camera hexapods (10), bending modes for M1M3 and M2 (40)."""
    rng = _det_rng(f"imsim_tpu-aos-deviation-{seed}")
    scales = np.concatenate([
        np.full(5, 1.0),     # M2 hexapod dz,dx,dy,rx,ry
        np.full(5, 1.0),     # camera hexapod
        np.full(20, 0.5),    # M1M3 bending modes
        np.full(20, 0.5),    # M2 bending modes
    ])
    return rng.normal(0.0, scales)


class OpticalZernikes:
    """Wavefront-error coefficients at any field position.

    API parity with imsim/optical_system.py:244-329: per-position
    annular-Zernike coefficient evaluation, by inverse-distance
    interpolation over the hexapolar sample points (the reference fits
    the same samples)."""

    def __init__(self, seed: int = 42, deviations=None, data_dir=None):
        """data_dir: directory holding the reference's measured
        optics_data files (sensitivity_matrix.txt, aos_sim_results.txt,
        annular_nominal_coeff.txt) — when given, the sensitivity
        matrix, per-DOF deviation scales and Zemax nominal field come
        from the data (imsim/optical_system.py:221-224 semantics);
        otherwise the synthesized model family is used."""
        import os

        nominal = None
        if data_dir:
            self.sensitivity = load_sensitivity_matrix(
                os.path.join(data_dir, "sensitivity_matrix.txt"))
            scales = load_aos_deviation_scales(
                os.path.join(data_dir, "aos_sim_results.txt"))
            if deviations is None:
                rng = _det_rng(f"imsim_tpu-aos-deviation-{seed}")
                deviations = rng.normal(0.0, scales)
            nom_path = os.path.join(data_dir,
                                    "annular_nominal_coeff.txt")
            if os.path.exists(nom_path):
                nominal = load_nominal_coeff(nom_path)
        else:
            self.sensitivity = synth_sensitivity_matrix()
        self.deviations = (np.asarray(deviations) if deviations is not None
                           else mock_deviations(seed))
        # (N_FIELD, N_ZK) nm at the sample points; deviations ride on
        # top of the Zemax nominal wavefront when the data provide it
        self.field_coefs = self.sensitivity @ self.deviations
        if nominal is not None:
            self.field_coefs = self.field_coefs + nominal
        self.points = hexapolar_field_points()

    def coefficients(self, fx_deg: float, fy_deg: float) -> np.ndarray:
        """(N_ZK,) wavefront coefficients [nm] at a field point, Noll
        j = 4..22."""
        d2 = ((self.points[:, 0] - fx_deg) ** 2
              + (self.points[:, 1] - fy_deg) ** 2)
        w = 1.0 / (d2 + 0.01)
        w /= w.sum()
        return w @ self.field_coefs

    def zernike_perturbation(self, fx_deg=0.0, fy_deg=0.0):
        """Coefficients in meters for Telescope.with_zernikes(start_j=4):
        wavefront error -> equivalent mirror-figure error (half, double
        pass)."""
        return self.coefficients(fx_deg, fy_deg) * 1e-9 / 2.0

    def apply_to(self, loaded_telescope, fx_deg=0.0, fy_deg=0.0,
                 optic="M2"):
        """Fold the AOS wavefront at one field point into the telescope
        (the doOpt hook, imsim/atmPSF.py:37-80)."""
        tel = loaded_telescope.fiducial.with_zernikes(
            optic, self.zernike_perturbation(fx_deg, fy_deg), start_j=4)
        loaded_telescope.fiducial = tel
        loaded_telescope._cache.clear()
        return loaded_telescope
