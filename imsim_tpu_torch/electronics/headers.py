"""DM-ingestible FITS headers for eimages and raw amp files
(imsim_tpu/electronics/headers.py counterpart, the same cards): the
eimage keyword block, the raw file's primary header and the per-amp
segment headers with the detector's SIP WCS in each amp's raw frame,
without astropy (MJD to ISO conversion here; the WCS cards from
optics.wcs.TanSipWCS.header_cards).  IMSIMVER is the port's version.
"""
from __future__ import annotations

import numpy as np

from .._version import __version__

# physical filter names (imsim/readout.py:26-46)
LSSTCAM_FILTER_MAP = {"u": "u_24", "g": "g_6", "r": "r_57",
                      "i": "i_39", "z": "z_20", "y": "y_10"}
COMCAM_FILTER_MAP = {"u": "u_05", "g": "g_01", "r": "r_03",
                     "i": "i_06", "z": "z_03", "y": "y_04"}
SIMONYI_TELESCOPE = "Simonyi Survey Telescope"


def mjd_to_datetime(mjd: float):
    """MJD -> (y, m, d, hh, mm, ss.sss) via the standard Gregorian
    conversion (Fliegel & Van Flandern 1968)."""
    jd = mjd + 2400000.5
    jdi = int(np.floor(jd + 0.5))
    frac = jd + 0.5 - jdi
    ell = jdi + 68569
    n = 4 * ell // 146097
    ell -= (146097 * n + 3) // 4
    i = 4000 * (ell + 1) // 1461001
    ell -= 1461 * i // 4 - 31
    j = 80 * ell // 2447
    d = ell - 2447 * j // 80
    ell = j // 11
    m = j + 2 - 12 * ell
    y = 100 * (n - 49) + i + ell
    sec = frac * 86400.0
    hh = int(sec // 3600)
    mm = int((sec - hh * 3600) // 60)
    ss = sec - hh * 3600 - mm * 60
    return y, m, d, hh, mm, ss


def mjd_to_isot(mjd: float) -> str:
    y, m, d, hh, mm, ss = mjd_to_datetime(mjd)
    return f"{y:04d}-{m:02d}-{d:02d}T{hh:02d}:{mm:02d}:{ss:06.3f}"


def dayobs(mjd_obs: float) -> str:
    """Rubin DAYOBS: the calendar date of (mjd_obs - 0.5)
    (imsim/ccd.py:176-178 convention)."""
    y, m, d, *_ = mjd_to_datetime(mjd_obs - 0.5)
    return f"{y:04d}{m:02d}{d:02d}"


def eimage_header(ods, det_name, serial, vendor, camera_name, wcs,
                  parallactic_deg, focus_z=0.0):
    """The eimage keyword block (imsim/ccd.py:138-206) + the WCS."""
    exptime = float(ods.get("exptime", 30.0))
    mjd_obs = float(ods.get("observationStartMJD", 51444.0))
    mjd_end = mjd_obs + exptime / 86400.0
    rot_tel = float(ods.get("rotTelPos", 0.0))
    rot_sky = (rot_tel - parallactic_deg) % 360.0
    seqnum = int(ods.get("seqnum", 0))
    h = {
        "EXPTIME": exptime,
        "DARKTIME": exptime,
        "DET_NAME": det_name,
        "MJD": float(ods.get("mjd_mid", mjd_obs)),
        "MJD-OBS": mjd_obs,
        "DAYOBS": dayobs(mjd_obs),
        "SEQNUM": seqnum,
        "CONTRLLR": "S",
        "RUNNUM": int(ods.get("observationId", -999)),
        "OBSID": int(ods.get("observationId", -999)),
        "IMGTYPE": str(ods.get("image_type", "SKYEXP")),
        "REASON": str(ods.get("reason", "survey")),
        "RATEL": float(ods.get("fieldRA", 0.0)),
        "DECTEL": float(ods.get("fieldDec", 0.0)),
        "ROTTELPOS": rot_tel,
        "ROTANGLE": rot_tel,
        "ROTSKYPO": rot_sky,
        "FILTER": str(ods.get("band", "N/A")),
        "CAMERA": camera_name,
        "LSST_NUM": serial,
        "CCD_MANU": vendor,
        "DATE-OBS": mjd_to_isot(mjd_obs),
        "DATE-END": mjd_to_isot(mjd_end),
        "HASTART": float(ods.get("HA", 0.0)),
        "HAEND": float(ods.get("HA", 0.0)) + exptime / 3600.0 * 1.0027,
        "AMSTART": float(ods.get("airmass", 1.0)),
        "AMEND": float(ods.get("airmass", 1.0)),
        "AIRMASS": float(ods.get("airmass", 1.0)),
        "SEEING": float(ods.get("rawSeeing", 0.7)),
        "FOCUSZ": float(ods.get("focusZ", focus_z)),
        "ALTITUDE": float(ods.get("altitude", 0.0)),
        "AZIMUTH": float(ods.get("azimuth", 0.0)),
        "INSTRUME": "imsim_tpu",
    }
    h.update(wcs.header_cards())
    return h


def raw_primary_header(eh: dict, serial: str, camera_name: str):
    """Raw-file primary header (imsim/readout.py:208-299): the keyword
    set the LSST Stack's metadata translators require."""
    band = eh["FILTER"]
    comcam = camera_name == "LsstComCamSim"
    telcode = "CC" if comcam else "MC"
    fmap = COMCAM_FILTER_MAP if comcam else LSSTCAM_FILTER_MAP
    raft, sensor = eh["DET_NAME"].split("_")
    rotang = eh["ROTSKYPO"]
    h = {
        "RUNNUM": eh["RUNNUM"],
        "MJD": eh["MJD"],
        "DATE": mjd_to_isot(eh["MJD"]),
        "DAYOBS": eh["DAYOBS"],
        "SEQNUM": eh["SEQNUM"],
        "CONTRLLR": eh["CONTRLLR"],
        "EXPTIME": eh["EXPTIME"],
        "DARKTIME": eh["DARKTIME"],
        "TIMESYS": "TAI",
        "LSST_NUM": serial,
        "IMGTYPE": eh["IMGTYPE"],
        "OBSTYPE": eh["IMGTYPE"],
        "REASON": eh["REASON"],
        "MONOWL": -1,
        "ROTANGLE": rotang,
        "FILTER": fmap.get(band, band),
        "INSTRUME": "ComCamSim" if comcam else "LSSTCamSim",
        "RAFTBAY": raft,
        "CCDSLOT": sensor,
        "RA": eh["RATEL"],
        "DEC": eh["DECTEL"],
        "ROTCOORD": "sky",
        "ROTPA": rotang,
        "TELESCOP": SIMONYI_TELESCOPE,
        "TELCODE": telcode,
        "RASTART": eh["RATEL"],
        "DECSTART": eh["DECTEL"],
        "ELSTART": eh["ALTITUDE"],
        "AZSTART": eh["AZIMUTH"],
        "MJD-OBS": eh["MJD-OBS"],
        "HASTART": eh["HASTART"],
        "HAEND": eh["HAEND"],
        "DATE-OBS": eh["DATE-OBS"],
        "DATE-END": eh["DATE-END"],
        "AMSTART": eh["AMSTART"],
        "AMEND": eh["AMEND"],
        "ORIGIN": "imsim_tpu",
        "IMSIMVER": __version__,
        "CHIPID": eh["DET_NAME"],
        "FOCUSZ": eh["FOCUSZ"],
    }
    if eh["IMGTYPE"] == "SKYEXP":
        h["RADESYS"] = "ICRS"
        h["TRACKSYS"] = "RADEC"
    else:
        h["TRACKSYS"] = "LOCAL"
    h["OBSID"] = f"{telcode}_S_{eh['DAYOBS']}_{int(eh['SEQNUM']):06d}"
    return h


def amp_header(ccd, amp, wcs):
    """Per-segment header: DATASEC/DETSEC/DETSIZE bookkeeping plus the
    detector SIP WCS re-expressed in the amp's raw frame (CRPIX shifted
    into raw coordinates, CD columns sign-flipped per readout direction
    — the same affine-only treatment as imsim/readout.py:497-523; SIP
    polynomial terms are carried unchanged)."""
    cards = dict(wcs.header_cards())
    pre = amp.raw_data_bounds.xmin
    sx = -1.0 if amp.raw_flip_x else 1.0
    sy = -1.0 if amp.raw_flip_y else 1.0
    # detector pixel -> raw amp pixel (1-based CRPIX):
    #   raw_c = pre + (flip ? amp.xmax - det_x : det_x - amp.xmin)
    cx = cards["CRPIX1"] - 1.0
    cy = cards["CRPIX2"] - 1.0
    cards["CRPIX1"] = pre + (amp.bounds.xmax - cx if amp.raw_flip_x
                             else cx - amp.bounds.xmin) + 1.0
    cards["CRPIX2"] = (amp.bounds.ymax - cy if amp.raw_flip_y
                       else cy - amp.bounds.ymin) + 1.0
    cards["CD1_1"] *= sx
    cards["CD2_1"] *= sx
    cards["CD1_2"] *= sy
    cards["CD2_2"] *= sy
    cards.update({
        "EXTNAME": f"Segment{amp.name[1:]}",
        "DATASEC": amp.raw_data_bounds.section_keyword(),
        "DETSEC": amp.bounds.section_keyword(amp.raw_flip_x,
                                             amp.raw_flip_y),
        "DETSIZE": ccd.bounds.section_keyword(),
        "GAIN": amp.gain,
        "BIASLVL": amp.bias_level,
        "RDNOISE": amp.read_noise,
    })
    return cards
