"""Spherical/tangent-plane coordinate helpers, host numpy float64 (copy
of imsim_tpu/utils/coords.py).  All angles in radians unless suffixed
_deg."""
from __future__ import annotations

import numpy as np

DEG = np.pi / 180.0
ARCSEC = DEG / 3600.0


def normalize_ra(ra, center=np.pi):
    """Wrap RA into (center-pi, center+pi]."""
    return (np.asarray(ra) - center + np.pi) % (2 * np.pi) + center - np.pi


def radec_to_unit(ra, dec):
    cd = np.cos(dec)
    return np.stack([cd * np.cos(ra), cd * np.sin(ra), np.sin(dec)], axis=-1)


def unit_to_radec(v):
    v = np.asarray(v)
    ra = np.arctan2(v[..., 1], v[..., 0])
    dec = np.arcsin(np.clip(v[..., 2] / np.linalg.norm(v, axis=-1), -1, 1))
    return ra, dec


def angular_separation(ra1, dec1, ra2, dec2):
    """Haversine; accurate at small separations."""
    sdd = np.sin(0.5 * (dec2 - dec1))
    sdr = np.sin(0.5 * (ra2 - ra1))
    h = sdd**2 + np.cos(dec1) * np.cos(dec2) * sdr**2
    return 2 * np.arcsin(np.sqrt(np.clip(h, 0, 1)))


def gnomonic_project(ra, dec, ra0, dec0):
    """(ra, dec) -> tangent-plane (u, v) [rad]; u east, v north."""
    sra, cra = np.sin(ra - ra0), np.cos(ra - ra0)
    sd, cd = np.sin(dec), np.cos(dec)
    sd0, cd0 = np.sin(dec0), np.cos(dec0)
    cosc = sd0 * sd + cd0 * cd * cra
    u = cd * sra / cosc
    v = (cd0 * sd - sd0 * cd * cra) / cosc
    return u, v


def gnomonic_deproject(u, v, ra0, dec0):
    """Tangent plane (u, v) [rad] -> (ra, dec)."""
    u = np.asarray(u)
    v = np.asarray(v)
    rho = np.hypot(u, v)
    c = np.arctan(rho)
    sc, cc = np.sin(c), np.cos(c)
    sd0, cd0 = np.sin(dec0), np.cos(dec0)
    with np.errstate(invalid="ignore"):
        dec = np.arcsin(np.where(rho > 0, cc * sd0 + v * sc * cd0 / rho, sd0))
        ra = ra0 + np.arctan2(u * sc,
                              rho * cd0 * cc - v * sd0 * sc)
    ra = np.where(rho > 0, ra, ra0)
    return ra, dec


def gnomonic_to_dircos(u, v):
    """Tangent-plane field angles -> direction cosines (batoid convention:
    +z toward the telescope, cf. batoid.utils.gnomonicToDirCos usage at
    imsim/photon_ops.py:475)."""
    gamma = 1.0 / np.sqrt(1.0 + u * u + v * v)
    return u * gamma, v * gamma, -gamma


def dircos_to_gnomonic(vx, vy, vz):
    return -vx / vz, -vy / vz
