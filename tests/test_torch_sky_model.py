"""The port's sky model against the JAX package's, on the CPU:
SkyModel over the bands, the moon, twilight and a loaded sky spectrum
(bit-equal: the same numpy); SkyGradient through each package's own WCS
of R22_S11 (1e-12 relative: the port's float64 host trace moves the WCS
by ~1e-16 rad, ROADMAP C) and through one WCS (bit-equal); the fringe
map CCD_Fringing on a 4096^2 heightfield (bit-equal)."""
import numpy as np
import pytest

import imsim_tpu.image.sky as JSky
from imsim_tpu.catalog.bandpass import rubin_bandpass as jbp
from imsim_tpu.electronics.camera import get_camera as jcamera
from imsim_tpu.image.sky_sed import load_sky_sed as jload
from imsim_tpu.optics.wcs_factory import make_wcs_factory as jfactory
import imsim_tpu_torch.image.sky as TSky
from imsim_tpu_torch.catalog.bandpass import rubin_bandpass as tbp
from imsim_tpu_torch.electronics.camera import get_camera as tcamera
from imsim_tpu_torch.image.sky_sed import load_sky_sed as tload
from imsim_tpu_torch.optics.wcs_factory import make_wcs_factory as tfactory

DEG = np.pi / 180
# (moon phase angle deg, moon alt rad, sun alt rad): dark, moon up near
# the field, moon down, twilight
CONDITIONS = [(180.0, -0.5, -1.0), (40.0, 0.6, -1.0), (90.0, -0.1, -0.5),
              (120.0, 0.3, -0.23)]


def _models(band, cond, sky_sed, airmass=1.2):
    phase, moon_alt, sun_alt = cond
    kw = dict(airmass=airmass, moon_phase_deg=phase, moon_alt_rad=moon_alt,
              moon_ra=0.7, moon_dec=-0.2, sun_alt_rad=sun_alt)
    j = JSky.SkyModel(30.0, 60674.2, jbp(band, airmass),
                      sky_sed=jload("default") if sky_sed else None, **kw)
    t = TSky.SkyModel(30.0, 60674.2, tbp(band, airmass),
                      sky_sed=tload("default") if sky_sed else None, **kw)
    return j, t


@pytest.mark.parametrize("sky_sed", [False, True])
@pytest.mark.parametrize("band", list("ugrizy"))
def test_sky_level(band, sky_sed):
    pos = [(30 * DEG, -20 * DEG), (0.65, -0.15), (3.0, 0.5), (5.9, -1.2)]
    for cond in CONDITIONS:
        j, t = _models(band, cond, sky_sed)
        for ra, dec in pos:
            assert j.get_sky_level(ra, dec) == t.get_sky_level(ra, dec), \
                (band, cond, ra, dec)
    assert JSky.ecliptic_latitude(0.3, 0.2) == TSky.ecliptic_latitude(0.3,
                                                                      0.2)


@pytest.fixture(scope="module")
def wcs_pair():
    """R22_S11's WCS at the bench pointing, one per package."""
    args = (30 * DEG, -20 * DEG, 60674.2)
    jw = jfactory(*args).get_wcs(jcamera()["R22_S11"])
    tw = tfactory(*args).get_wcs(tcamera()["R22_S11"])
    return jw, tw


@pytest.mark.parametrize("cond", CONDITIONS)
def test_sky_gradient(wcs_pair, cond):
    jw, tw = wcs_pair
    j, t = _models("r", cond, False)
    ra_c, dec_c = (float(v) for v in tw.xy_to_radec(2047.5, 2001.5))
    ga = JSky.SkyGradient(j, tw, ra_c, dec_c, 4096)
    gb = TSky.SkyGradient(t, tw, ra_c, dec_c, 4096)
    assert (ga.a, ga.b, ga.c, ga.sky_level_center) == \
        (gb.a, gb.b, gb.c, gb.sky_level_center)
    x, y = np.meshgrid(np.arange(0, 4096, 512.0), np.arange(0, 4004, 512.0))
    assert np.array_equal(ga(x, y), gb(x, y))
    # each package's own WCS: 1e-12 relative
    ja_c, jd_c = (float(v) for v in jw.xy_to_radec(2047.5, 2001.5))
    gj = JSky.SkyGradient(j, jw, ja_c, jd_c, 4096)
    for p, q in ((gj.a, gb.a), (gj.b, gb.b), (gj.c, gb.c)):
        assert abs(p - q) <= 1e-12 * abs(gb.c)


def test_fringing_seed():
    for serial, visit in (("E2V-CCD250-382", 181000), ("ITL-3800C-1", 3)):
        assert JSky.sensor_fringing_seed(serial, visit) == \
            TSky.sensor_fringing_seed(serial, visit)


@pytest.mark.parametrize("offset", [0.0, 1.3])
def test_fringing_map(offset):
    """The 4096^2 heightfield map on R22_S11's frame, bit-equal to the
    JAX package's."""
    seed = TSky.sensor_fringing_seed("E2V-CCD250-382", 181000)
    j = JSky.CCD_Fringing(seed, boresight_offset_deg=offset)
    t = TSky.CCD_Fringing(seed, boresight_offset_deg=offset)
    want = j.fringing_map((4004, 4096), amplitude=0.0023)
    got = t.fringing_map((4004, 4096), amplitude=0.0023)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert abs(float(want.std()) - 0.0023 * j.fringe_variation_level()
               / np.sqrt(2)) < 2e-4


def test_fringing_skyline_surface():
    """A measured skyline surface, bilinearly resampled (a small frame)."""
    rng = np.random.default_rng(2)
    sv = 1 + 0.05 * rng.normal(size=(9, 11))
    j = JSky.CCD_Fringing(77)
    t = TSky.CCD_Fringing(77)
    want = j.fringing_map((300, 200), skyline_surface=sv)
    assert np.array_equal(t.fringing_map((300, 200), skyline_surface=sv),
                          want)
