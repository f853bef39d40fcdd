"""phoSim instance-catalog parser -> flat object table (copy of
imsim_tpu/catalog/instcat.py; host numpy).

The text format is ``object ID RA DEC MAGNORM SED_NAME REDSHIFT GAMMA1
GAMMA2 KAPPA DRA DDEC TYPE [params...] [dust...]``, with includeobj
recursion and gzip, the WCS + edge_pix pixel-box cull, the skip-invalid
rules and the magnorm >= 50 sentinel, flip_g2, the brightest-first
magnorm sort and the lensing conversion gamma/kappa -> (g1, g2, mu).
Lines are tokenized by the native C++ tokenizer (catalog/native_instcat.py,
io/native/instcat.cc) or, with force_python, by the JAX package's Python
loop (its reference semantics): both give the same table.
"""
from __future__ import annotations

import functools
import gzip
import os
from dataclasses import dataclass, field

import numpy as np

from ..utils.coords import DEG

# Rubin effective collecting area, cm^2 (primary minus obscuration):
# pi * (418^2 - 255^2)
RUBIN_AREA = np.pi * (418.0**2 - 255.0**2)

# object type codes
POINT, SERSIC, KNOTS, STREAK, FITSIMAGE = 0, 1, 2, 3, 4
_TYPE_NAMES = {POINT: "point", SERSIC: "sersic2d", KNOTS: "knots",
               STREAK: "streak", FITSIMAGE: "fits"}

# where the dust parameters start per type (token index)
_DUST_INDEX = {"point": 13, "sersic2d": 17, "knots": 17, "streak": 16}
_DEFAULT_DUST_INDEX = 15


def _open_lines(filename):
    """Yield lines, recursing into includeobj files; handles gzip."""
    if not os.path.isfile(filename):
        raise OSError(f"File not found: {filename}")
    abspath = os.path.dirname(os.path.abspath(filename))
    opener = gzip.open if filename.endswith(".gz") else open
    with opener(filename, "rt") as fd:
        for line in fd:
            if line.startswith("includeobj"):
                sub = os.path.join(abspath, line.strip().split()[-1])
                yield from _open_lines(sub)
            else:
                yield line


@dataclass
class ObjectTable:
    """Flat per-object arrays (host); x, y filled by the culling WCS."""

    id: np.ndarray = field(default_factory=lambda: np.array([], dtype=object))
    ra: np.ndarray = field(default_factory=lambda: np.zeros(0))        # rad
    dec: np.ndarray = field(default_factory=lambda: np.zeros(0))       # rad
    x: np.ndarray = field(default_factory=lambda: np.zeros(0))         # pix
    y: np.ndarray = field(default_factory=lambda: np.zeros(0))
    magnorm: np.ndarray = field(default_factory=lambda: np.zeros(0))
    obj_type: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    # profile params: sersic/knots -> (hlr, n_or_npoints, q, beta_rad)
    #                 streak       -> (length, width, pa_rad, 0)
    p0: np.ndarray = field(default_factory=lambda: np.zeros(0))
    p1: np.ndarray = field(default_factory=lambda: np.zeros(0))
    p2: np.ndarray = field(default_factory=lambda: np.zeros(0))
    p3: np.ndarray = field(default_factory=lambda: np.zeros(0))
    g1: np.ndarray = field(default_factory=lambda: np.zeros(0))
    g2: np.ndarray = field(default_factory=lambda: np.zeros(0))
    mu: np.ndarray = field(default_factory=lambda: np.zeros(0))
    sed_name: np.ndarray = field(default_factory=lambda: np.array([], object))
    redshift: np.ndarray = field(default_factory=lambda: np.zeros(0))
    int_av: np.ndarray = field(default_factory=lambda: np.zeros(0))
    int_rv: np.ndarray = field(default_factory=lambda: np.zeros(0))
    mw_av: np.ndarray = field(default_factory=lambda: np.zeros(0))
    mw_rv: np.ndarray = field(default_factory=lambda: np.zeros(0))
    # FITS-postage-stamp objects: file path per object ('' otherwise)
    image_file: np.ndarray = field(
        default_factory=lambda: np.array([], object))
    # optional pre-built observer-frame SED per row (catalog.sed.SED,
    # normalized for magnorm=0); None rows use the sed_name file
    sed_obj: np.ndarray = field(
        default_factory=lambda: np.array([], object))

    def __len__(self):
        return len(self.magnorm)

    def select(self, idx) -> "ObjectTable":
        kw = {}
        n = len(self)
        for k in self.__dataclass_fields__:
            v = getattr(self, k)
            if len(v) != n:   # optional column absent -> keep it absent
                kw[k] = v
            else:
                kw[k] = v[idx]
        return ObjectTable(**kw)


def _parse_dust(tokens):
    """(internal_av, internal_rv, mw_av, mw_rv); 'none' markers."""
    params = list(tokens)
    if params and params[0].lower() != "none":
        iav, irv = float(params[1]), float(params[2])
        params = params[3:]
    else:
        iav, irv = 0.0, 3.1
        params = params[1:]
    if params and params[0].lower() != "none":
        gav, grv = float(params[1]), float(params[2])
    else:
        gav, grv = 0.0, 3.1
    return iav, irv, gav, grv


def read_instcat(file_name, wcs=None, xsize=4096, ysize=4096, edge_pix=100,
                 sort_mag=True, flip_g2=True, min_source=None,
                 skip_invalid=True, logger=None):
    """Parse an instance catalog into an ObjectTable, culled to the image.

    wcs: object with radec_to_xy(ra, dec) (radians) -> pixel coords, or
    None to keep every object.  The parse is cached per (file, mtime,
    flags) and shared by every detector of a visit; the cull and the sort
    run per CCD."""
    tab, ntot = _parse_instcat_cached(
        os.path.abspath(file_name), _mtime_of(file_name),
        bool(flip_g2), bool(skip_invalid))

    if wcs is not None and len(tab):
        x, y = wcs.radec_to_xy(tab.ra, tab.dec)
        x, y = np.asarray(x, float), np.asarray(y, float)
        keep = ((x >= -edge_pix) & (x <= xsize + edge_pix)
                & (y >= -edge_pix) & (y <= ysize + edge_pix))
        tab = tab.select(keep)
        tab.x, tab.y = x[keep], y[keep]
    else:
        tab = tab.select(np.ones(len(tab), bool))   # private copy

    if min_source is not None:
        nsersic = int(np.sum(tab.obj_type == SERSIC))
        if nsersic < min_source:
            tab = tab.select(np.zeros(len(tab), bool))

    if sort_mag and len(tab):
        tab = tab.select(np.argsort(tab.magnorm))

    if logger:
        logger.info("instcat: %d/%d objects kept", len(tab), ntot)
    return tab


def _mtime_of(file_name):
    try:
        return os.path.getmtime(file_name)
    except OSError:
        return 0.0


@functools.lru_cache(maxsize=4)
def _parse_instcat_cached(file_name, mtime, flip_g2, skip_invalid):
    return _parse_instcat(file_name, flip_g2=flip_g2,
                          skip_invalid=skip_invalid)


def _parse_instcat(file_name, flip_g2=True, skip_invalid=True,
                   force_python=False):
    """Tokenize every `object` line into the full (unculled)
    ObjectTable.  Returns (table, n_total_lines).

    The native C++ tokenizer (catalog/native_instcat.py) is the default;
    this Python loop is its plain twin (force_python=True), the JAX
    package's reference semantics."""
    if not force_python:
        from .native_instcat import parse_instcat_native

        return parse_instcat_native(file_name, flip_g2, skip_invalid)
    g2_sign = -1.0 if flip_g2 else 1.0

    rows = {k: [] for k in ("id", "ra", "dec", "magnorm", "obj_type",
                            "p0", "p1", "p2", "p3", "g1", "g2", "mu",
                            "sed_name", "redshift",
                            "int_av", "int_rv", "mw_av", "mw_rv",
                            "image_file")}
    ntot = 0
    for line in _open_lines(file_name):
        if " inf " in line:
            continue
        if not line.startswith("object"):
            continue
        ntot += 1
        tokens = line.strip().split()
        ra = float(tokens[2]) * DEG
        dec = float(tokens[3]) * DEG
        magnorm = float(tokens[4])
        sed_name, redshift = tokens[5], float(tokens[6])
        gamma1 = float(tokens[7])
        gamma2 = g2_sign * float(tokens[8])
        kappa = float(tokens[9])
        # tokens 10, 11: delta_ra/delta_dec, unused
        tname = tokens[12].lower()
        dust_index = _DUST_INDEX.get(tname, _DEFAULT_DUST_INDEX)
        objinfo = tokens[12:dust_index]
        dust = tokens[dust_index:]

        if skip_invalid:
            ok = magnorm < 50.0
            if tname == "sersic2d" and float(objinfo[1]) < float(objinfo[2]):
                ok = False
            if tname == "knots" and (float(objinfo[1]) < float(objinfo[2])
                                     or int(objinfo[4]) <= 0):
                ok = False
            if not ok:
                continue

        p = [0.0, 0.0, 0.0, 0.0]
        if tname == "point":
            code = POINT
        elif tname == "sersic2d":
            code = SERSIC
            a, b = float(objinfo[1]), float(objinfo[2])
            pa = float(objinfo[3])
            beta = (90 - pa if flip_g2 else 90 + pa) * DEG
            n = round(float(objinfo[4]) * 20.0) / 20.0
            p = [np.sqrt(a * b), n, b / a, beta]
        elif tname == "knots":
            code = KNOTS
            a, b = float(objinfo[1]), float(objinfo[2])
            pa = float(objinfo[3])
            beta = (90 - pa if flip_g2 else 90 + pa) * DEG
            npoints = int(objinfo[4])
            p = [np.sqrt(a * b), float(npoints), b / a, beta]
        elif tname == "streak":
            code = STREAK
            p = [float(objinfo[1]), float(objinfo[2]),
                 float(objinfo[3]) * DEG, 0.0]
        elif tname.endswith(".fits") or tname.endswith(".fits.gz"):
            code = FITSIMAGE
            p = [float(objinfo[1]), float(objinfo[2]) * DEG, 0.0, 0.0]
        else:
            raise RuntimeError(f"Unknown object type: {tokens[12]}")

        # reduced shear + magnification
        g1r = gamma1 / (1.0 - kappa)
        g2r = gamma2 / (1.0 - kappa)
        mu = 1.0 / ((1.0 - kappa) ** 2 - (gamma1**2 + gamma2**2))

        iav, irv, gav, grv = _parse_dust(dust)

        rows["id"].append(tokens[1])
        rows["ra"].append(ra)
        rows["dec"].append(dec)
        rows["magnorm"].append(magnorm)
        rows["obj_type"].append(code)
        for i in range(4):
            rows[f"p{i}"].append(p[i])
        rows["g1"].append(g1r)
        rows["g2"].append(g2r)
        rows["mu"].append(mu)
        rows["sed_name"].append(sed_name)
        rows["image_file"].append(tokens[12] if code == FITSIMAGE else "")
        rows["redshift"].append(redshift)
        rows["int_av"].append(iav)
        rows["int_rv"].append(irv)
        rows["mw_av"].append(gav)
        rows["mw_rv"].append(grv)

    tab = ObjectTable(
        id=np.array(rows["id"], object),
        ra=np.array(rows["ra"]),
        dec=np.array(rows["dec"]),
        x=np.zeros(len(rows["ra"])),
        y=np.zeros(len(rows["ra"])),
        magnorm=np.array(rows["magnorm"]),
        obj_type=np.array(rows["obj_type"], np.int32),
        p0=np.array(rows["p0"]), p1=np.array(rows["p1"]),
        p2=np.array(rows["p2"]), p3=np.array(rows["p3"]),
        g1=np.array(rows["g1"]), g2=np.array(rows["g2"]),
        mu=np.array(rows["mu"]),
        sed_name=np.array(rows["sed_name"], object),
        redshift=np.array(rows["redshift"]),
        int_av=np.array(rows["int_av"]), int_rv=np.array(rows["int_rv"]),
        mw_av=np.array(rows["mw_av"]), mw_rv=np.array(rows["mw_rv"]),
        image_file=np.array(rows["image_file"], object),
    )
    return tab, ntot


def object_flux(magnorm, pupil_area=RUBIN_AREA, exptime=30.0):
    """Normalization in photons/cm^2/s x area x time for a magnorm."""
    return np.exp(-0.9210340371976184 * np.asarray(magnorm)) \
        * pupil_area * exptime
