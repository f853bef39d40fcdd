"""ICRF <-> observed astrometry, self-contained numpy float64 (copy of
imsim_tpu/optics/astrometry.py).

Precession (Capitaine et al. 2003, IAU 2006, frame bias in the constant
terms), the complete IAU 2000B nutation series, IAU 2006 GMST, exact
relativistic annual aberration of a Kepler-ellipse barycentric Earth
velocity, diurnal aberration, and two-term refraction with the Edlen air
index.  Polar motion and UT1-UTC enter from an IERS finals file when
`eop` is given; without one they are zero (nothing is downloaded).

All angles radians, times MJD (UTC ~ TT for series arguments).
"""
from __future__ import annotations

import numpy as np

from .geometry import air_index_excess

DEG = np.pi / 180.0
ARCSEC = DEG / 3600.0

# Rubin site (same constants the reference pulls from lsst.utils /
# opsim headers; imsim/batoid_wcs.py:619-634 defaults).  The pressure
# default must match the reference's barometric polynomial at its
# h=2715 m Cerro Pachon figure (imsim/batoid_wcs.py:625-630) — a 0.7%
# pressure difference shifts every refracted position ~150 mas
# zenith-ward at zd~30 deg.
RUBIN_LAT = -30.24463 * DEG
RUBIN_LON = -70.749417 * DEG
RUBIN_HEIGHT = 2715.0          # m
RUBIN_PRESSURE_KPA = 101.325 * (1 - 2.25577e-5 * RUBIN_HEIGHT) ** 5.25588


def load_iers_finals(path):
    """(mjd, xp_arcsec, yp_arcsec, dut1_s) arrays from an IERS
    finals2000A.all file (the fixed-column standard; the reference
    ships a 2019 snapshot, data/19-10-30-finals2000A.all).  Rows with
    no measured/predicted values (far-future padding) are dropped."""
    mjds, xps, yps, duts = [], [], [], []
    with open(path) as f:
        for ln in f:
            try:
                mjd = float(ln[7:15])
                xp = float(ln[18:27])
                yp = float(ln[37:46])
                du = float(ln[58:68])
            except (ValueError, IndexError):
                continue
            mjds.append(mjd)
            xps.append(xp)
            yps.append(yp)
            duts.append(du)
    if not mjds:
        raise ValueError(f"no usable EOP rows in {path}")
    return (np.asarray(mjds), np.asarray(xps), np.asarray(yps),
            np.asarray(duts))


_EOP_CACHE: dict = {}


def eop_for_mjd(eop, mjd_utc):
    """(xp_arcsec, yp_arcsec, dut1_s) at mjd_utc.  `eop` is a finals
    file path or a preloaded (mjd, xp, yp, dut1) tuple.  Linear
    interpolation; epochs outside the table clamp to the nearest end
    (the honest choice without a prediction model — polar motion
    wanders +-0.3 arcsec, so an out-of-range epoch keeps only the
    order of magnitude)."""
    if isinstance(eop, (str, bytes)):
        tab = _EOP_CACHE.get(eop)
        if tab is None:
            tab = _EOP_CACHE[eop] = load_iers_finals(eop)
    else:
        tab = eop
    mjds, xp, yp, du = tab
    return (float(np.interp(mjd_utc, mjds, xp)),
            float(np.interp(mjd_utc, mjds, yp)),
            float(np.interp(mjd_utc, mjds, du)))


def _jc(mjd):
    """Julian centuries of TT since J2000."""
    return (mjd - 51544.5) / 36525.0


def gmst(mjd):
    """Greenwich mean sidereal time [rad] (IAU 1982-style polynomial).

    Kept for callers without a UT1/TT split; Observation uses the
    IAU 2006 expression gmst06() (ERA + precession-in-RA), which is the
    one consistent with the IAU 2006 precession used below (the 1982
    polynomial drifts ~1 mas/yr against it away from J2000)."""
    d = mjd - 51544.5
    t = d / 36525.0
    g = (280.46061837 + 360.98564736629 * d
         + 0.000387933 * t * t - t**3 / 38710000.0)
    return (g % 360.0) * DEG


def era(mjd_ut1):
    """Earth rotation angle [rad] (IAU 2000 defining relation; linear
    in UT1).  SOFA-validated in tests/test_astrometry.py."""
    d = mjd_ut1 - 51544.5
    # UT1 fraction of the *JD* day: MJD flips at 0h, JD at 12h UT
    f = np.fmod(mjd_ut1, 1.0) + 0.5
    theta = 2 * np.pi * np.fmod(
        f + 0.7790572732640 + 0.00273781191135448 * d, 1.0)
    return theta % (2 * np.pi)


def gmst06(mjd_ut1, mjd_tt):
    """IAU 2006 Greenwich mean sidereal time [rad]: ERA(UT1) plus the
    precession-of-the-equinox-in-RA polynomial (TT)."""
    t = _jc(mjd_tt)
    poly = (0.014506 + 4612.156534 * t + 1.3915817 * t * t
            - 0.00000044 * t**3 - 0.000029956 * t**4
            - 0.0000000368 * t**5) * ARCSEC
    return (era(mjd_ut1) + poly) % (2 * np.pi)


def delaunay_args(mjd):
    """Fundamental lunisolar (Delaunay) arguments l, l', F, D, Om [rad]
    (IAU 2000 polynomials, linear + quadratic terms)."""
    t = _jc(mjd)
    l = (134.96340251 + (1717915923.2178 * t + 31.8792 * t * t)
         / 3600.0) * DEG
    lp = (357.52910918 + (129596581.0481 * t - 0.5532 * t * t)
          / 3600.0) * DEG
    F = (93.27209062 + (1739527262.8478 * t - 12.7512 * t * t)
         / 3600.0) * DEG
    D = (297.85019547 + (1602961601.2090 * t - 6.3706 * t * t)
         / 3600.0) * DEG
    om = (125.04455501 + (-6962890.5431 * t + 7.4722 * t * t)
          / 3600.0) * DEG
    return l, lp, F, D, om


# The COMPLETE IAU 2000B lunisolar nutation series (McCarthy & Luzum
# 2003): all 77 terms.  Columns: l, l', F, D, Om multipliers, then
# A_psi, A_psi*T, A_psi_cos ; B_eps, B_eps*T, B_eps_sin in units of
# 0.1 microarcsec (the published table's units):
#   dpsi = sum (A + A't) sin(arg) + A'' cos(arg)
#   deps = sum (B + B't) cos(arg) + B'' sin(arg)
# plus the model's fixed planetary-bias offsets below.  Residual vs the
# full IAU 2000A model: < 1 mas over 1995-2050 (the model's published
# design envelope) — down from ~6 mas on the sky for the previous
# 20-term truncation.
_NUT_TERMS = np.array([
    # l  l'  F   D  Om     A         A'      A''     B         B'     B''
    (0,  0,  0,  0, 1, -172064161.0, -174666.0, 33386.0, 92052331.0, 9086.0, 15377.0),
    (0,  0,  2, -2, 2, -13170906.0, -1675.0, -13696.0, 5730336.0, -3015.0, -4587.0),
    (0,  0,  2,  0, 2, -2276413.0, -234.0, 2796.0, 978459.0, -485.0, 1374.0),
    (0,  0,  0,  0, 2, 2074554.0, 207.0, -698.0, -897492.0, 470.0, -291.0),
    (0,  1,  0,  0, 0, 1475877.0, -3633.0, 11817.0, 73871.0, -184.0, -1924.0),
    (0,  1,  2, -2, 2, -516821.0, 1226.0, -524.0, 224386.0, -677.0, -174.0),
    (1,  0,  0,  0, 0, 711159.0, 73.0, -872.0, -6750.0, 0.0, 358.0),
    (0,  0,  2,  0, 1, -387298.0, -367.0, 380.0, 200728.0, 18.0, 318.0),
    (1,  0,  2,  0, 2, -301461.0, -36.0, 816.0, 129025.0, -63.0, 367.0),
    (0, -1,  2, -2, 2, 215829.0, -494.0, 111.0, -95929.0, 299.0, 132.0),
    (0,  0,  2, -2, 1, 128227.0, 137.0, 181.0, -68982.0, -9.0, 39.0),
    (-1, 0,  2,  0, 2, 123457.0, 11.0, 19.0, -53311.0, 32.0, -4.0),
    (-1, 0,  0,  2, 0, 156994.0, 10.0, -168.0, -1235.0, 0.0, 82.0),
    (1,  0,  0,  0, 1, 63110.0, 63.0, 27.0, -33228.0, 0.0, -9.0),
    (-1, 0,  0,  0, 1, -57976.0, -63.0, -189.0, 31429.0, 0.0, -75.0),
    (-1, 0,  2,  2, 2, -59641.0, -11.0, 149.0, 25543.0, -11.0, 66.0),
    (1,  0,  2,  0, 1, -51613.0, -42.0, 129.0, 26366.0, 0.0, 78.0),
    (-2, 0,  2,  0, 1, 45893.0, 50.0, 31.0, -24236.0, -10.0, 20.0),
    (0,  0,  0,  2, 0, 63384.0, 11.0, -150.0, -1220.0, 0.0, 29.0),
    (0,  0,  2,  2, 2, -38571.0, -1.0, 158.0, 16452.0, -11.0, 68.0),
    (0, -2,  2, -2, 2, 32481.0, 0.0, 0.0, -13870.0, 0.0, 0.0),
    (-2, 0,  0,  2, 0, -47722.0, 0.0, -18.0, 477.0, 0.0, -25.0),
    (2,  0,  2,  0, 2, -31046.0, -1.0, 131.0, 13238.0, -11.0, 59.0),
    (1,  0,  2, -2, 2, 28593.0, 0.0, -1.0, -12338.0, 10.0, -3.0),
    (-1, 0,  2,  0, 1, 20441.0, 21.0, 10.0, -10758.0, 0.0, -3.0),
    (2,  0,  0,  0, 0, 29243.0, 0.0, -74.0, -609.0, 0.0, 13.0),
    (0,  0,  2,  0, 0, 25887.0, 0.0, -66.0, -550.0, 0.0, 11.0),
    (0,  1,  0,  0, 1, -14053.0, -25.0, 79.0, 8551.0, -2.0, -45.0),
    (-1, 0,  0,  2, 1, 15164.0, 10.0, 11.0, -8001.0, 0.0, -1.0),
    (0,  2,  2, -2, 2, -15794.0, 72.0, -16.0, 6850.0, -42.0, -5.0),
    (0,  0, -2,  2, 0, 21783.0, 0.0, 13.0, -167.0, 0.0, 13.0),
    (1,  0,  0, -2, 1, -12873.0, -10.0, -37.0, 6953.0, 0.0, -14.0),
    (0, -1,  0,  0, 1, -12654.0, 11.0, 63.0, 6415.0, 0.0, 26.0),
    (-1, 0,  2,  2, 1, -10204.0, 0.0, 25.0, 5222.0, 0.0, 15.0),
    (0,  2,  0,  0, 0, 16707.0, -85.0, -10.0, 168.0, -1.0, 10.0),
    (1,  0,  2,  2, 2, -7691.0, 0.0, 44.0, 3268.0, 0.0, 19.0),
    (-2, 0,  2,  0, 0, -11024.0, 0.0, -14.0, 104.0, 0.0, 2.0),
    (0,  1,  2,  0, 2, 7566.0, -21.0, -11.0, -3250.0, 0.0, -5.0),
    (0,  0,  2,  2, 1, -6637.0, -11.0, 25.0, 3353.0, 0.0, 14.0),
    (0, -1,  2,  0, 2, -7141.0, 21.0, 8.0, 3070.0, 0.0, 4.0),
    (0,  0,  0,  2, 1, -6302.0, -11.0, 2.0, 3272.0, 0.0, 4.0),
    (1,  0,  2, -2, 1, 5800.0, 10.0, 2.0, -3045.0, 0.0, -1.0),
    (2,  0,  2, -2, 2, 6443.0, 0.0, -7.0, -2768.0, 0.0, -4.0),
    (-2, 0,  0,  2, 1, -5774.0, -11.0, -15.0, 3041.0, 0.0, -5.0),
    (2,  0,  2,  0, 1, -5350.0, 0.0, 21.0, 2695.0, 0.0, 12.0),
    (0, -1,  2, -2, 1, -4752.0, -11.0, -3.0, 2719.0, 0.0, -3.0),
    (0,  0,  0, -2, 1, -4940.0, -11.0, -21.0, 2720.0, 0.0, -9.0),
    (-1, -1, 0,  2, 0, 7350.0, 0.0, -8.0, -51.0, 0.0, 4.0),
    (2,  0,  0, -2, 1, 4065.0, 0.0, 6.0, -2206.0, 0.0, 1.0),
    (1,  0,  0,  2, 0, 6579.0, 0.0, -24.0, -199.0, 0.0, 2.0),
    (0,  1,  2, -2, 1, 3579.0, 0.0, 5.0, -1900.0, 0.0, 1.0),
    (1, -1,  0,  0, 0, 4725.0, 0.0, -6.0, -41.0, 0.0, 3.0),
    (-2, 0,  2,  0, 2, -3075.0, 0.0, -2.0, 1313.0, 0.0, -1.0),
    (3,  0,  2,  0, 2, -2904.0, 0.0, 15.0, 1233.0, 0.0, 7.0),
    (0, -1,  0,  2, 0, 4348.0, 0.0, -10.0, -81.0, 0.0, 2.0),
    (1, -1,  2,  0, 2, -2878.0, 0.0, 8.0, 1232.0, 0.0, 4.0),
    (0,  0,  0,  1, 0, -4230.0, 0.0, 5.0, -20.0, 0.0, -2.0),
    (-1, -1, 2,  2, 2, -2819.0, 0.0, 7.0, 1207.0, 0.0, 3.0),
    (-1, 0,  2,  0, 0, -4056.0, 0.0, 5.0, 40.0, 0.0, -2.0),
    (0, -1,  2,  2, 2, -2647.0, 0.0, 11.0, 1129.0, 0.0, 5.0),
    (-2, 0,  0,  0, 1, -2294.0, 0.0, -10.0, 1266.0, 0.0, -4.0),
    (1,  1,  2,  0, 2, 2481.0, 0.0, -7.0, -1062.0, 0.0, -3.0),
    (2,  0,  0,  0, 1, 2179.0, 0.0, -2.0, -1129.0, 0.0, -2.0),
    (-1, 1,  0,  1, 0, 3276.0, 0.0, 1.0, -9.0, 0.0, 0.0),
    (1,  1,  0,  0, 0, -3389.0, 0.0, 5.0, 35.0, 0.0, -2.0),
    (1,  0,  2,  0, 0, 3339.0, 0.0, -13.0, -107.0, 0.0, 1.0),
    (-1, 0,  2, -2, 1, -1987.0, 0.0, -6.0, 1073.0, 0.0, -2.0),
    (1,  0,  0,  0, 2, -1981.0, 0.0, 0.0, 854.0, 0.0, 0.0),
    (-1, 0,  0,  1, 0, 4026.0, 0.0, -353.0, -553.0, 0.0, -139.0),
    (0,  0,  2,  1, 2, 1660.0, 0.0, -5.0, -710.0, 0.0, -2.0),
    (-1, 0,  2,  4, 2, -1521.0, 0.0, 9.0, 647.0, 0.0, 4.0),
    (-1, 1,  0,  1, 1, 1314.0, 0.0, 0.0, -700.0, 0.0, 0.0),
    (0, -2,  2, -2, 1, -1283.0, 0.0, 0.0, 672.0, 0.0, 0.0),
    (1,  0,  2,  2, 1, -1331.0, 0.0, 8.0, 663.0, 0.0, 4.0),
    (-2, 0,  2,  2, 2, 1383.0, 0.0, -2.0, -594.0, 0.0, -2.0),
    (-1, 0,  0,  0, 2, 1405.0, 0.0, 4.0, -610.0, 0.0, 2.0),
    (1,  1,  2, -2, 2, 1290.0, 0.0, 0.0, -556.0, 0.0, 0.0),
], dtype=np.float64)

# IAU 2000B fixed offsets standing in for the planetary nutation
# series [mas] (part of the published model definition).
_NUT_PLANETARY_DPSI_MAS = -0.135
_NUT_PLANETARY_DEPS_MAS = 0.388


def _nut00b_args(t):
    """Fundamental lunisolar arguments as the IAU 2000B model defines
    them (linear-only polynomials, arcsec mod 1296000) [rad]."""
    turnas = 1296000.0
    el = np.fmod(485868.249036 + 1717915923.2178 * t, turnas) * ARCSEC
    elp = np.fmod(1287104.79305 + 129596581.0481 * t, turnas) * ARCSEC
    f = np.fmod(335779.526232 + 1739527262.8478 * t, turnas) * ARCSEC
    d = np.fmod(1072260.70369 + 1602961601.2090 * t, turnas) * ARCSEC
    om = np.fmod(450160.398036 - 6962890.5431 * t, turnas) * ARCSEC
    return np.array([el, elp, f, d, om])


def nutation(mjd):
    """Complete IAU 2000B nutation: (dpsi, deps) [rad].

    The full published 77-term lunisolar series + the model's fixed
    planetary offsets; < 1 mas of IAU 2000A across 1995-2050.  Pinned
    against the SOFA validation value in tests/test_astrometry.py."""
    t = _jc(mjd)
    phase = _NUT_TERMS[:, :5] @ _nut00b_args(t)
    sp, cp = np.sin(phase), np.cos(phase)
    u = 1e-7 * ARCSEC          # table units: 0.1 microarcsec
    dpsi = np.sum((_NUT_TERMS[:, 5] + _NUT_TERMS[:, 6] * t) * sp
                  + _NUT_TERMS[:, 7] * cp) * u
    deps = np.sum((_NUT_TERMS[:, 8] + _NUT_TERMS[:, 9] * t) * cp
                  + _NUT_TERMS[:, 10] * sp) * u
    MAS = ARCSEC / 1000.0
    return (dpsi + _NUT_PLANETARY_DPSI_MAS * MAS,
            deps + _NUT_PLANETARY_DEPS_MAS * MAS)


def mean_obliquity(mjd):
    """IAU 2006 mean obliquity of the ecliptic [rad]."""
    t = _jc(mjd)
    return ((84381.406 - 46.836769 * t - 0.0001831 * t * t
             + 0.00200340 * t**3) * ARCSEC)


def precession_matrix(mjd):
    """ICRS/GCRS -> mean-of-date rotation.

    Capitaine et al. (2003) IAU 2006 equatorial precession angles
    referred to the GCRS: the +-2.650545 arcsec constant terms carry the
    ICRS frame bias, so this single rotation is bias+precession."""
    t = _jc(mjd)
    zeta = (2.650545 + 2306.083227 * t + 0.2988499 * t * t
            + 0.01801828 * t**3) * ARCSEC
    z = (-2.650545 + 2306.077181 * t + 1.0927348 * t * t
         + 0.01826837 * t**3) * ARCSEC
    theta = (2004.191903 * t - 0.4294934 * t * t
             - 0.04182264 * t**3) * ARCSEC
    return _rz(-z) @ _ry(theta) @ _rz(-zeta)


def _rx(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, s], [0, -s, c]])


def _ry(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])


def _rz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])


def nutation_matrix(mjd):
    dpsi, deps = nutation(mjd)
    eps = mean_obliquity(mjd)
    return _rx(-(eps + deps)) @ _rz(-dpsi) @ _rx(eps)


def icrf_to_tod_matrix(mjd):
    """ICRF -> true-of-date equatorial."""
    return nutation_matrix(mjd) @ precession_matrix(mjd)


def gast(mjd):
    dpsi, _ = nutation(mjd)
    return gmst(mjd) + dpsi * np.cos(mean_obliquity(mjd))


_C_LIGHT = 2.99792458e8


def _ellipse_vel(lam_mean, ecc, peri_lon, speed, node=0.0, incl=0.0):
    """Ecliptic velocity/c of a Kepler ellipse: exact-in-e direction via
    the true longitude (equation of center to e^3), optional orbital
    inclination about the ascending node.  `speed` = n*a [m/s]."""
    M = lam_mean - peri_lon
    C = ((2 * ecc - 0.25 * ecc**3) * np.sin(M)
         + 1.25 * ecc * ecc * np.sin(2 * M)
         + (13.0 / 12.0) * ecc**3 * np.sin(3 * M))
    lam_t = lam_mean + C
    vfac = speed / np.sqrt(1 - ecc * ecc) / _C_LIGHT
    if incl == 0.0:
        return np.array([-vfac * (np.sin(lam_t) + ecc * np.sin(peri_lon)),
                         vfac * (np.cos(lam_t) + ecc * np.cos(peri_lon)),
                         0.0])
    # in-plane components with x' at the ascending node, then rotate
    # R_z(node) @ R_x(incl)
    ut, uw = lam_t - node, peri_lon - node
    vpx = -vfac * (np.sin(ut) + ecc * np.sin(uw))
    vpy = vfac * (np.cos(ut) + ecc * np.cos(uw))
    ci, si = np.cos(incl), np.sin(incl)
    cn, sn = np.cos(node), np.sin(node)
    return np.array([vpx * cn - vpy * ci * sn,
                     vpx * sn + vpy * ci * cn,
                     vpy * si])


def earth_velocity(mjd):
    """Earth barycentric velocity / c in the *equatorial-of-date* frame.

    Kepler-ellipse sum (erfa epv00 analog):
      1. heliocentric EMB: exact two-body ellipse, equation of center
         to e^3 (Meeus ch. 25 elements);
      2. Earth about the Earth-Moon barycenter (12.45 m/s, ~8.6 mas):
         lunar ellipse with eccentricity AND the 5.145 deg inclination
         about the node (Delaunay Om);
      3. Sun about the solar-system barycenter: Jupiter and Saturn
         elliptical reflex (inclined), Uranus/Neptune/Venus circular
         reflex, EMB's own reflex.
    Residual vs a full ephemeris: ~2 m/s RSS (~1.4 mas of aberration) —
    planetary perturbations of the EMB orbit (~1.5 m/s), lunar
    evection/variation (~0.35 m/s).  Pinned against the SOFA epv00
    validation vector in tests/test_astrometry.py.

    Rotate by icrf2tod.T for the ICRF components used in aberration.
    """
    t = _jc(mjd)

    # --- heliocentric EMB: exact ellipse -----------------------------
    L = (280.46646 + 36000.76983 * t) * DEG       # sun mean longitude
    M = (357.52911 + 35999.05029 * t) * DEG       # sun mean anomaly
    e = 0.016708634 - 0.000042037 * t
    kgauss = 0.01720209895                         # rad/day (a = 1 AU)
    AU_DAY = 1.495978707e11 / 86400.0
    v_emb = _ellipse_vel(L + np.pi, e, L - M + np.pi, kgauss * AU_DAY)

    # --- Earth about EMB (opposite the Moon's motion) ----------------
    lam_m = (218.3164477 + 481267.88123421 * t) * DEG
    l_m, _, _, _, om_m = delaunay_args(mjd)        # lunar mean anomaly,
    f_m = 0.0121505856                             # node; m_m/(m_e+m_m)
    v_moon = 2 * np.pi * 384399e3 / (27.321582 * 86400.0)   # n*a
    v_emb = v_emb - f_m * _ellipse_vel(
        lam_m, 0.0549, lam_m - l_m, v_moon,
        node=om_m, incl=5.145 * DEG)

    # --- Sun about the barycenter -------------------------------------
    # giant-planet reflex: v_sun = -sum m_p/m_sun * v_p; Jupiter and
    # Saturn as inclined ellipses, Uranus/Neptune/Venus circular, plus
    # the EMB's own reflex.  (elements: Meeus table 31.a, J2000 mean)
    v_sun = np.zeros(3)
    for lam0, rate, ecc, pw, node, incl, speed, mratio in (
            (34.351484, 3034.9056746, 0.04849485, 14.331309,
             100.464441, 1.303270, 13064.0, 1.0 / 1047.3486),
            (50.077471, 1222.1137943, 0.05550862, 93.056787,
             113.665524, 2.488878, 9660.0, 1.0 / 3497.898),
            (314.055005, 428.4669983, 0.0, 0.0, 0.0, 0.0,
             6813.0, 1.0 / 22902.98),
            (304.348665, 218.4862002, 0.0, 0.0, 0.0, 0.0,
             5443.0, 1.0 / 19412.24),
            (181.979801, 58517.8156760, 0.0, 0.0, 0.0, 0.0,
             35020.0, 1.0 / 408523.71)):
        v_sun = v_sun - mratio * _ellipse_vel(
            (lam0 + rate * t) * DEG, ecc, pw * DEG, speed,
            node=node * DEG, incl=incl * DEG)
    v_sun = v_sun - (1.0 / 328900.56) * v_emb       # EMB reflex

    vx, vy, vz = v_emb + v_sun
    # ecliptic-of-date -> equatorial-of-date
    eps = mean_obliquity(mjd)
    ce, se = np.cos(eps), np.sin(eps)
    return np.array([vx, vy * ce - vz * se, vy * se + vz * ce])


def aberrate(v, vel):
    """Exact special-relativistic aberration: natural direction unit
    vectors v (..., 3) seen by an observer with velocity `vel` (units
    of c).  The erfa `ab` formula without the light-deflection term;
    exact to all orders in |vel| (second order ~1 mas matters here)."""
    bm1 = np.sqrt(1.0 - np.dot(vel, vel))
    pdv = v @ vel
    w = (1.0 + pdv / (1.0 + bm1)) / (1.0 + pdv)
    return bm1 / (1.0 + pdv)[..., None] * v + w[..., None] * vel


def unaberrate(v, vel, niter=3):
    """Inverse of aberrate (fixed point; converges to f64 in 3 steps
    since |vel| ~ 1e-4)."""
    p = v
    for _ in range(niter):
        p = v - (aberrate(p, vel) - p)
        p = p / np.linalg.norm(p, axis=-1, keepdims=True)
    return p


def refraction_coefs(wavelength_nm, pressure_kpa=RUBIN_PRESSURE_KPA,
                     temperature_k=280.0, h2o_pressure_kpa=1.0):
    """Two-term refraction R(z) = k1 tan z + k2 tan^3 z [rad]
    (erfa refco-style quick formula; exact chromatic dependence via the
    Edlen air index in optics.geometry)."""
    n = 1.0 + air_index_excess(wavelength_nm, pressure_kpa, temperature_k,
                               h2o_pressure_kpa)
    xi = n - 1.0
    beta = 0.001254  # H_atm / R_earth
    k1 = xi * (1.0 - beta)
    k2 = -xi * (beta + xi / 2.0)
    return k1, k2


def apply_refraction(alt, k1, k2):
    """True altitude -> refracted (observed) altitude."""
    z = np.pi / 2 - alt
    tz = np.tan(np.clip(z, 0.0, 1.50))
    return alt + k1 * tz + k2 * tz**3


def undo_refraction(alt_obs, k1, k2, niter=3):
    alt = alt_obs
    for _ in range(niter):
        alt = alt_obs - (apply_refraction(alt, k1, k2) - alt)
    return alt


def _sph_to_vec(ra, dec):
    return np.stack([np.cos(dec) * np.cos(ra),
                     np.cos(dec) * np.sin(ra),
                     np.sin(dec)], axis=-1)


def _vec_to_sph(v):
    ra = np.arctan2(v[..., 1], v[..., 0]) % (2 * np.pi)
    dec = np.arcsin(np.clip(v[..., 2], -1, 1))
    return ra, dec


class Observation:
    """Frozen per-visit astrometry context: all matrices precomputed.

    The five frames of the reference's WCS factory
    (imsim/batoid_wcs.py:20-33): ICRF -> observed (az/alt) -> field;
    field -> focal -> pixel live in optics.trace + electronics.camera.
    """

    def __init__(self, boresight_ra, boresight_dec, mjd,
                 wavelength_nm=622.0, lat=RUBIN_LAT, lon=RUBIN_LON,
                 pressure_kpa=RUBIN_PRESSURE_KPA, temperature_k=280.0,
                 h2o_pressure_kpa=1.0, dut1=None, time_scale="tai",
                 eop=None):
        # Rubin MJDs (opsim, phosim headers) are TAI (the reference
        # constructs astropy Time(..., scale='tai'),
        # imsim/batoid_wcs.py:607-612).  Earth rotation needs UT1
        # (= UTC + dut1; TAI-UTC = 37 s since 2017-01, valid for all
        # contemporary survey epochs) and the precession/nutation/
        # aberration series need TT (= TAI + 32.184 s).
        if time_scale == "tai":
            mjd_utc = mjd - 37.0 / 86400.0
            mjd_tt = mjd + 32.184 / 86400.0
        elif time_scale == "utc":
            mjd_utc = mjd
            mjd_tt = mjd + (37.0 + 32.184) / 86400.0
        else:
            raise ValueError(f"unknown time_scale {time_scale!r}")
        # Earth-orientation parameters: `eop` is a finals2000A.all path
        # (or preloaded arrays) supplying measured UT1-UTC and polar
        # motion (the reference ships one: data/19-10-30-finals2000A.all,
        # though it runs with IERS lookups disabled, imsim/utils.py:19-28).
        # An explicit dut1 argument wins over the file.
        xp_as = yp_as = 0.0
        if eop is not None:
            xp_as, yp_as, dut1_file = eop_for_mjd(eop, mjd_utc)
            if dut1 is None:
                dut1 = dut1_file
        dut1 = 0.0 if dut1 is None else float(dut1)
        # Polar motion: first-order shift of the site's ASTRONOMICAL
        # coordinates from the CIP-vs-ITRF pole offset (classic
        # reduction; exact to << 1 mas for |xp|,|yp| < 0.4 arcsec):
        #   dphi    = xp cos(lon) - yp sin(lon)
        #   dlambda = (xp sin(lon) + yp cos(lon)) tan(phi)
        if xp_as or yp_as:
            lat = lat + (xp_as * np.cos(lon)
                         - yp_as * np.sin(lon)) * ARCSEC
            lon = lon + (xp_as * np.sin(lon)
                         + yp_as * np.cos(lon)) * np.tan(lat) * ARCSEC
        self.xp_as, self.yp_as, self.dut1 = xp_as, yp_as, dut1
        self.mjd = mjd
        self.mjd_tt = mjd_tt
        self.mjd_ut1 = mjd_utc + dut1 / 86400.0
        self.lat, self.lon = lat, lon
        self.pressure_kpa = pressure_kpa
        self.temperature_k = temperature_k
        self.h2o_pressure_kpa = h2o_pressure_kpa
        self.wavelength_nm = wavelength_nm
        self.icrf2tod = icrf_to_tod_matrix(mjd_tt)
        # barycentric Earth velocity: computed in the equatorial-of-date
        # frame, rotated to ICRF components (aberration is applied to
        # ICRF vectors; a frame mismatch here costs |v/c| * frame angle
        # ~ 0.1 arcsec)
        self.vel = self.icrf2tod.T @ earth_velocity(mjd_tt)
        # local apparent sidereal time from UT1: IAU 2006 GMST (ERA +
        # precession-in-RA, consistent with the precession model above)
        # + equation of the equinoxes evaluated at TT
        self.last = (gmst06(self.mjd_ut1, mjd_tt)
                     + nutation(mjd_tt)[0] * np.cos(mean_obliquity(mjd_tt))
                     + lon)
        self.k1, self.k2 = refraction_coefs(wavelength_nm, pressure_kpa,
                                            temperature_k, h2o_pressure_kpa)
        # diurnal aberration: observer velocity / c, due east
        self.v_diurnal = 465.10 * np.cos(lat) / 2.99792458e8
        self.boresight = (boresight_ra, boresight_dec)
        self.bore_az, self.bore_alt = self.icrf_to_observed(
            np.atleast_1d(boresight_ra), np.atleast_1d(boresight_dec))
        self.bore_az = float(self.bore_az[0])
        self.bore_alt = float(self.bore_alt[0])

    def _diurnal_vec(self):
        """Observer velocity / c in the true-of-date frame (due east at
        local apparent sidereal time)."""
        return self.v_diurnal * np.array([-np.sin(self.last),
                                          np.cos(self.last), 0.0])

    # --- ICRF -> observed az/alt ----------------------------------------
    def icrf_to_observed(self, ra, dec):
        v = _sph_to_vec(ra, dec)
        # annual aberration (exact relativistic; v expressed in ICRF)
        v = aberrate(v, self.vel)
        # bias-precession-nutation
        v = v @ self.icrf2tod.T
        # diurnal aberration (0.32 arcsec at the site), TOD frame
        v = v + self._diurnal_vec()
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        ra_a, dec_a = _vec_to_sph(v)
        # hour angle
        ha = self.last - ra_a
        sin_lat, cos_lat = np.sin(self.lat), np.cos(self.lat)
        sin_alt = (np.sin(dec_a) * sin_lat
                   + np.cos(dec_a) * cos_lat * np.cos(ha))
        alt = np.arcsin(np.clip(sin_alt, -1, 1))
        az = np.arctan2(-np.cos(dec_a) * np.sin(ha),
                        np.sin(dec_a) * cos_lat
                        - np.cos(dec_a) * sin_lat * np.cos(ha)) % (2 * np.pi)
        # refraction (raises apparent altitude)
        alt = apply_refraction(alt, self.k1, self.k2)
        return az, alt

    # --- observed equatorial (rob, dob) ---------------------------------
    # The reference's WCS field frame lives in *observed* ra/dec (the
    # apparent, refracted position re-expressed as equatorial
    # coordinates of date: rob = LAST - hob; erfa atco13's rob/dob,
    # imsim/batoid_wcs.py:118-243).
    def icrf_to_observed_radec(self, ra, dec):
        az, alt = self.icrf_to_observed(ra, dec)
        return self.azalt_to_observed_radec(az, alt)

    def azalt_to_observed_radec(self, az, alt):
        sin_lat, cos_lat = np.sin(self.lat), np.cos(self.lat)
        sin_dec = np.sin(alt) * sin_lat + np.cos(alt) * cos_lat * np.cos(az)
        dob = np.arcsin(np.clip(sin_dec, -1, 1))
        hob = np.arctan2(-np.sin(az) * np.cos(alt),
                         np.sin(alt) * cos_lat
                         - np.cos(alt) * sin_lat * np.cos(az))
        rob = self.last - hob
        return rob, dob

    def observed_radec_to_icrf(self, rob, dob):
        ha = self.last - rob
        sin_lat, cos_lat = np.sin(self.lat), np.cos(self.lat)
        sin_alt = (np.sin(dob) * sin_lat
                   + np.cos(dob) * cos_lat * np.cos(ha))
        alt = np.arcsin(np.clip(sin_alt, -1, 1))
        az = np.arctan2(-np.cos(dob) * np.sin(ha),
                        np.sin(dob) * cos_lat
                        - np.cos(dob) * sin_lat * np.cos(ha)) % (2 * np.pi)
        return self.observed_to_icrf(az, alt)

    def parallactic_angle_observed(self):
        """Parallactic angle of the *observed* boresight (position angle
        of zenith from true north through east at the refracted apparent
        place) — erfa hd2pa(hob, dob, lat), the q of the reference's
        field frame (imsim/batoid_wcs.py:255-268)."""
        rob, dob = self.azalt_to_observed_radec(
            np.atleast_1d(self.bore_az), np.atleast_1d(self.bore_alt))
        hob = self.last - rob[0]
        dob = dob[0]
        return np.arctan2(
            np.sin(hob),
            np.tan(self.lat) * np.cos(dob) - np.sin(dob) * np.cos(hob))

    def pseudo_parallactic_angle(self):
        """Position angle of zenith measured from *ICRF* north through
        east at the boresight (the reference's `pq`,
        imsim/batoid_wcs.py:270-308): computed, like the reference, by
        mapping a point slightly zenith-ward of the boresight back to
        ICRF and taking its position angle.  Differs from
        parallactic_angle_observed() by the ICRS-vs-of-date north
        convergence (~0.1-0.2 deg at |dec|~35, epoch 2025)."""
        eps = 1e-4
        ra_z, dec_z = self.observed_to_icrf(
            np.atleast_1d(self.bore_az), np.atleast_1d(self.bore_alt + eps))
        ra0, dec0 = self.boresight
        dra = (float(ra_z[0]) - ra0 + np.pi) % (2 * np.pi) - np.pi
        return np.arctan2(dra * np.cos(dec0), float(dec_z[0]) - dec0)

    # --- observed az/alt -> ICRF ----------------------------------------
    def observed_to_icrf(self, az, alt):
        alt = undo_refraction(alt, self.k1, self.k2)
        sin_lat, cos_lat = np.sin(self.lat), np.cos(self.lat)
        sin_dec = np.sin(alt) * sin_lat + np.cos(alt) * cos_lat * np.cos(az)
        dec_a = np.arcsin(np.clip(sin_dec, -1, 1))
        ha = np.arctan2(-np.sin(az) * np.cos(alt),
                        np.sin(alt) * cos_lat
                        - np.cos(alt) * sin_lat * np.cos(az))
        ra_a = self.last - ha
        v = _sph_to_vec(ra_a, dec_a)
        v = v - self._diurnal_vec()
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        v = v @ self.icrf2tod            # inverse rotation (orthogonal)
        v = unaberrate(v, self.vel)
        return _vec_to_sph(v)

    # --- parallactic angle at the boresight ------------------------------
    def parallactic_angle(self):
        """Angle zenith-ward from north at the boresight (q, the rotator
        relation rotSkyPos = rotTelPos - q; imsim/batoid_wcs.py:255-308)."""
        ra_a, dec_a = self.boresight
        ha = self.last - ra_a
        return np.arctan2(
            np.sin(ha),
            np.tan(self.lat) * np.cos(dec_a) - np.sin(dec_a) * np.cos(ha))
