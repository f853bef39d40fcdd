"""Telescope loading and perturbations (imsim_tpu/optics/loader.py
counterpart): the band's best-focus offset, the ordered perturbations
(shift / rotX / rotY / rotZ / Zernike sag per optic), the FEA / AOS
terms (optics.fea), the rotator angle,
focusZ defocus and per-detector focal-height offsets, as updates of the
host `TelescopeDesign`.
"""
from __future__ import annotations

import numpy as np

from .telescope import TelescopeDesign, make_telescope

# chromatic best-focus offsets [m] applied to the detector per band
# (minimum on-axis spot rms at each band's effective wavelength)
BAND_FOCUS_M = {
    "u": 5.224e-4, "g": 1.931e-4, "r": -6.4e-6,
    "i": -1.113e-4, "z": -1.763e-4, "y": -2.252e-4,
}

# Optic-name aliases: users address whole elements; surfaces are split
# into entrance/exit internally.
OPTIC_SURFACES = {
    "M1": ("M1",), "M2": ("M2",), "M3": ("M3",),
    "L1": ("L1_entrance", "L1_exit"),
    "L2": ("L2_entrance", "L2_exit"),
    "Filter": ("Filter_entrance", "Filter_exit"),
    "L3": ("L3_entrance", "L3_exit"),
    "LSSTCamera": ("L1_entrance", "L1_exit", "L2_entrance", "L2_exit",
                   "Filter_entrance", "Filter_exit", "L3_entrance",
                   "L3_exit", "Detector"),
    "Detector": ("Detector",),
}


def load_telescope(telescope: str = "LSST", band: str = "r",
                   perturbations=(), fea=None, rotTelPos: float = 0.0,
                   focusZ: float = 0.0) -> "LoadedTelescope":
    """Build the (possibly perturbed) telescope for one visit.

    perturbations : dict or list of dicts, ordered:
        {"M2": {"shift": [dx, dy, dz], "rotX": angle_rad,
                "zernikes": {"coef": [...meters], "start_j": 4}}, ...}
    fea : the finite-element / AOS terms: raw per-mirror Zernike lists
        ({"M1": [z4... meters]}, the legacy shorthand) or the terms of
        optics.fea.fea_instructions (m1m3_gravity, aos_dof, ...).
    rotTelPos : camera rotator angle [rad], consumed by the WCS and the
        photon chain as a focal-plane rotation.
    focusZ : extra detector defocus [m].
    """
    if telescope not in ("LSST", "LsstCam", "LsstCamSim", "ComCam",
                         "LsstComCamSim"):
        raise ValueError(f"unknown telescope {telescope}")
    tel = make_telescope()
    tel = tel.with_focus_shift(BAND_FOCUS_M.get(band, 0.0) + focusZ)

    if isinstance(perturbations, dict):
        perturbations = [perturbations]
    for pdict in perturbations:
        for optic, terms in pdict.items():
            for surf in OPTIC_SURFACES[optic]:
                for kind, val in terms.items():
                    if kind == "shift":
                        tel = tel.with_shift(surf, np.asarray(val, float))
                    elif kind in ("rotX", "rotY", "rotZ"):
                        tel = tel.with_rot(surf, kind[-1].lower(),
                                           float(val))
                    elif kind == "zernikes":
                        coef = np.asarray(val["coef"], float)
                        tel = tel.with_zernikes(
                            surf, coef, int(val.get("start_j", 1)))
                    else:
                        raise ValueError(f"unknown perturbation {kind}")
    if fea:
        raise ValueError("the frozen loader takes no FEA terms")
    return LoadedTelescope(tel=tel, band=band, rotTelPos=float(rotTelPos))


class LoadedTelescope:
    """Fiducial telescope + per-detector variants: detectors sit at
    slightly different heights; the per-detector telescope shifts the
    detector surface by the CCD's z-offset and caches the result."""

    def __init__(self, tel: TelescopeDesign, band: str, rotTelPos: float):
        self.fiducial = tel
        self.band = band
        self.rotTelPos = rotTelPos
        self._cache = {}

    def for_detector(self, det_name: str = None, z_offset: float = 0.0):
        key = (det_name, round(float(z_offset), 9))
        if key not in self._cache:
            self._cache[key] = self.fiducial.with_focus_shift(z_offset)
        return self._cache[key]
