"""Visit metadata: opsim sqlite databases and phoSim instance-catalog
headers (copy of imsim_tpu/catalog/opsim.py; host numpy).

Reads one visit row from an opsim .db or the key/value header of an
instance catalog and derives the band, exptime, mjd midpoint, hour angle
from the apparent sidereal time, airmass (Krisciunas & Schaefer 1991),
FWHMeff / FWHMgeom, the seed and the sun's altitude.
"""
from __future__ import annotations

import gzip
import os
import sqlite3

import numpy as np

from ..optics.astrometry import RUBIN_LAT, RUBIN_LON, gast

DEG = np.pi / 180.0

# per-band effective wavelengths used by the FWHM derivations
BAND_WL_EFF = dict(u=365.49, g=480.03, r=622.20, i=754.06, z=868.21,
                   y=991.66)


class OpsimData:
    """dict-like visit metadata with derived quantities."""

    def __init__(self, meta: dict):
        self.meta = dict(meta)
        self._derive()

    def __getitem__(self, k):
        return self.meta[k]

    def get(self, k, default=None):
        return self.meta.get(k, default)

    def __contains__(self, k):
        return k in self.meta

    def getAirmass(self, altitude=None):
        """Krisciunas & Schaefer 1991 eq 3."""
        if altitude is None:
            altitude = self.get("altitude")
        return 1.0 / np.sqrt(1.0 - 0.96 * np.cos(altitude * DEG) ** 2)

    def FWHMeff(self, rawSeeing=None, band=None, altitude=None):
        """Effective single-Gaussian FWHM (LSST Document-20160 p.8): raw
        zenith/500 nm seeing scaled by X^0.6 (wl/500)^-0.3, in quadrature
        with the instrument floor 0.4 X^0.6."""
        X = self.getAirmass(altitude)
        if band is None:
            band = self.get("band")
        if rawSeeing is None:
            rawSeeing = self.get("rawSeeing")
        wl = BAND_WL_EFF.get(band, 622.20)
        fwhm_atm = rawSeeing * (wl / 500.0) ** (-0.3) * X ** 0.6
        fwhm_sys = 0.4 * X ** 0.6
        return 1.16 * np.sqrt(fwhm_sys ** 2 + 1.04 * fwhm_atm ** 2)

    def FWHMgeom(self, rawSeeing=None, band=None, altitude=None):
        """FWHMtot of the combined PSF."""
        return 0.822 * self.FWHMeff(rawSeeing, band, altitude) + 0.052

    def _derive(self):
        m = self.meta
        m.setdefault("exptime", 30.0)
        if "band" not in m and "filter" in m:
            m["band"] = m["filter"]
        ra = m.get("fieldRA", m.get("rightascension", 0.0))
        dec = m.get("fieldDec", m.get("declination", 0.0))
        m["fieldRA"] = ra
        m["fieldDec"] = dec
        if "observationStartMJD" not in m and "mjd" in m:
            m["observationStartMJD"] = m["mjd"]
        mjd0 = m.get("observationStartMJD", 60674.0)
        m["mjd_mid"] = mjd0 + m["exptime"] / 2.0 / 86400.0

        # hour angle from local apparent sidereal time
        last = (gast(m["mjd_mid"]) + RUBIN_LON) % (2 * np.pi)
        ha = (last - ra * DEG) % (2 * np.pi)
        if ha > np.pi:
            ha -= 2 * np.pi
        m["HA"] = ha / (2 * np.pi) * 24.0    # hours

        # altitude & airmass (Krisciunas & Schaefer 1991 eq 3)
        sin_alt = (np.sin(dec * DEG) * np.sin(RUBIN_LAT)
                   + np.cos(dec * DEG) * np.cos(RUBIN_LAT) * np.cos(ha))
        alt = np.arcsin(np.clip(sin_alt, -1, 1))
        m.setdefault("altitude", alt / DEG)
        x = np.clip(np.cos(np.pi / 2 - m["altitude"] * DEG), 0.05, 1.0)
        m.setdefault("airmass", 1.0 / np.sqrt(1.0 - 0.96 * (1.0 - x * x)))

        # delivered seeing: FWHM_eff at airmass & wavelength
        raw = m.get("seeingFwhm500", m.get("rawSeeing", 0.7))
        m["rawSeeing"] = raw
        m.setdefault("band", "r")
        m.setdefault("FWHMeff", self.FWHMeff())
        m.setdefault("FWHMgeom", 0.822 * m["FWHMeff"] + 0.052)
        m.setdefault("rotTelPos", m.get("rotTelPos", 0.0))
        m.setdefault("seed", int(m.get("observationId", 42)) % 2**31)

        # sun altitude for the twilight sky component (low-precision
        # solar ephemeris, good to ~0.01 rad)
        if "sunAlt" not in m:
            d = m["mjd_mid"] - 51544.5     # days since J2000
            g = np.radians((357.529 + 0.98560028 * d) % 360.0)
            lam_sun = np.radians((280.459 + 0.98564736 * d) % 360.0
                                 ) + np.radians(1.915) * np.sin(g) \
                + np.radians(0.020) * np.sin(2 * g)
            eps = np.radians(23.4393)
            sun_dec = np.arcsin(np.sin(eps) * np.sin(lam_sun))
            sun_ra = np.arctan2(np.cos(eps) * np.sin(lam_sun),
                                np.cos(lam_sun))
            ha_sun = (last - sun_ra) % (2 * np.pi)
            sin_a = (np.sin(sun_dec) * np.sin(RUBIN_LAT)
                     + np.cos(sun_dec) * np.cos(RUBIN_LAT)
                     * np.cos(ha_sun))
            m["sunAlt"] = float(np.degrees(
                np.arcsin(np.clip(sin_a, -1, 1))))


def _header_value(s: str):
    try:
        v = float(s)
        return int(v) if v == int(v) and "." not in s else v
    except ValueError:
        return s


def read_instcat_header(file_name: str) -> OpsimData:
    """The key/value header lines of a phoSim instance catalog, with the
    phoSim names (rightascension, declination, mjd, filter index,
    rotskypos, moon and sun keys) mapped to the opsim ones."""
    opener = gzip.open if file_name.endswith(".gz") else open
    meta = {}
    bands = "ugrizy"
    with opener(file_name, "rt") as fd:
        for line in fd:
            if line.startswith(("object", "includeobj")):
                break
            toks = line.strip().split()
            if len(toks) >= 2:
                meta[toks[0]] = _header_value(toks[1])
    if "filter" in meta and isinstance(meta["filter"], int):
        meta["band"] = bands[meta["filter"]]
    if "rightascension" in meta:
        meta["fieldRA"] = meta["rightascension"]
    if "declination" in meta:
        meta["fieldDec"] = meta["declination"]
    if "mjd" in meta:
        meta["observationStartMJD"] = meta["mjd"]
    if "rotskypos" in meta:
        meta["rotSkyPos"] = meta["rotskypos"]
    if "rottelpos" in meta:
        meta["rotTelPos"] = meta["rottelpos"]
    if "seeing" in meta:
        meta["rawSeeing"] = meta["seeing"]
    if "obshistid" in meta:
        meta["observationId"] = meta["obshistid"]
    # phoSim lowercase moon/sun keys -> the opsim camelCase names the sky
    # model reads (degrees / percent illuminated)
    for lo, hi in (("moonalt", "moonAlt"), ("moonphase", "moonPhase"),
                   ("moonra", "moonRA"), ("moondec", "moonDec"),
                   ("sunalt", "sunAlt"), ("dist2moon", "moonDistance")):
        if lo in meta:
            meta[hi] = meta[lo]
    meta.setdefault("exptime", meta.get("vistime", 30.0))
    return OpsimData(meta)


def read_opsim_db(file_name: str, visit: int | None = None,
                  snap: int = 0) -> OpsimData:
    """One row of an opsim sqlite database; seqnum = the count of visits
    up to this one in the same night."""
    if not os.path.isfile(file_name):
        raise OSError(f"opsim db not found: {file_name}")
    con = sqlite3.connect(file_name)
    con.row_factory = sqlite3.Row
    try:
        table = "observations"
        names = [r[0] for r in con.execute(
            "SELECT name FROM sqlite_master WHERE type='table'")]
        if table not in names:
            table = names[0]
        if visit is None:
            row = con.execute(f"SELECT * FROM {table} LIMIT 1").fetchone()
        else:
            row = con.execute(
                f"SELECT * FROM {table} WHERE observationId=?",
                (visit,)).fetchone()
        if row is None:
            raise ValueError(f"visit {visit} not in {file_name}")
        meta = dict(row)
        try:
            seqnum = con.execute(
                f"SELECT COUNT(*) FROM {table} WHERE night=? AND "
                "observationStartMJD<=?",
                (meta.get("night", 0),
                 meta.get("observationStartMJD", 0.0))).fetchone()[0]
            meta["seqnum"] = int(seqnum)
        except sqlite3.OperationalError:
            meta["seqnum"] = 1
        meta["snap"] = snap
        return OpsimData(meta)
    finally:
        con.close()


def from_dict(d: dict) -> OpsimData:
    """Visit metadata from a plain dict."""
    return OpsimData(d)
