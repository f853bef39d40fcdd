"""The port's pointing chain against the JAX package's: the astrometry
(`Observation`), the telescope prescription and its perturbation API,
the float64 host trace (the port's torch trace on float64 CPU tensors
against the JAX package's trace with xp=numpy), the TAN-SIP WCS of a
detector, the WCS factory's frames and the optics context.  Over three
detectors (E2V R22_S11, ITL R10_S11, the LsstCam corner wavefront
sensor R00_SW0 at half height and a 1.5 mm focal offset), two pointings
and epochs, two bands, a non-zero rotator angle and an M2 shift + rotX
perturbation.

Tolerances: the astrometry to 1e-13 rad, the host trace to 1e-12 m with
equal vignette flags, xy_to_radec on a pixel grid to 1e-10 rad, the
prescription, perturbations and the optics context bit-equal."""
import numpy as np
import pytest
import torch

from imsim_tpu.electronics.camera import get_camera as jcamera
from imsim_tpu.optics import astrometry as JA
from imsim_tpu.optics import loader as JL
from imsim_tpu.optics import telescope as JTel
from imsim_tpu.optics.trace import rays_from_field as j_rays
from imsim_tpu.optics.trace import trace as j_trace
from imsim_tpu.optics.wcs import fit_tan_sip as j_fit
from imsim_tpu.optics.wcs_factory import make_wcs_factory as j_factory
from imsim_tpu.photons.optics_ops import make_optics_context as j_context
from imsim_tpu_torch import convert as CV
from imsim_tpu_torch.electronics.camera import get_camera as tcamera
from imsim_tpu_torch.optics import astrometry as TA
from imsim_tpu_torch.optics import loader as TL
from imsim_tpu_torch.optics import telescope as TTel
from imsim_tpu_torch.optics import trace as TTr
from imsim_tpu_torch.optics.wcs import fit_tan_sip as t_fit
from imsim_tpu_torch.optics.wcs_factory import host_trace
from imsim_tpu_torch.optics.wcs_factory import make_wcs_factory as t_factory
from imsim_tpu_torch.ops import raychain
from imsim_tpu_torch.photons.optics_ops import make_optics_context

torch.set_num_threads(1)

DEG = np.pi / 180
PERTURB = [{"M2": {"shift": [2e-4, -1e-4, 5e-5], "rotX": 3e-5}}]
# (det, ra, dec, mjd, band, rotTelPos, perturbations)
VISITS = [
    ("R22_S11", 30.0, -20.0, 60674.2, "r", 0.0, ()),
    ("R10_S11", 30.0, -20.0, 60674.2, "r", 0.0, ()),
    ("R00_SW0", 30.0, -20.0, 60674.2, "r", 0.0, ()),
    ("R10_S11", 201.5, -44.0, 61200.83, "g", 0.35, ()),
    ("R22_S11", 201.5, -44.0, 61200.83, "i", -0.2, PERTURB),
]


def _ids(v):
    return f"{v[0]}-{v[4]}-rot{v[5]}" + ("-perturbed" if v[6] else "")


@pytest.fixture(scope="module", params=VISITS, ids=_ids)
def visit(request):
    det, ra, dec, mjd, band, rot, pert = request.param
    jf = j_factory(ra * DEG, dec * DEG, mjd, band=band, telescope=JL
                   .load_telescope(band=band, perturbations=pert,
                                   rotTelPos=rot))
    tf = t_factory(ra * DEG, dec * DEG, mjd, band=band, telescope=TL
                   .load_telescope(band=band, perturbations=pert,
                                   rotTelPos=rot))
    return dict(det=det, jf=jf, tf=tf, jccd=jcamera("LsstCam")[det],
                tccd=tcamera("LsstCam")[det])


@pytest.mark.parametrize("where", [(30.0, -20.0, 60674.2),
                                   (201.5, -44.0, 61200.83)])
def test_observation_transforms(where):
    """The ICRF <-> observed chain and its angles, to 1e-13 rad."""
    ra0, dec0, mjd = where
    kw = dict(wavelength_nm=480.0, temperature_k=275.0)
    j = JA.Observation(ra0 * DEG, dec0 * DEG, mjd, **kw)
    t = TA.Observation(ra0 * DEG, dec0 * DEG, mjd, **kw)
    rng = np.random.default_rng(1)
    ra = ra0 * DEG + rng.uniform(-0.04, 0.04, 300)
    dec = dec0 * DEG + rng.uniform(-0.04, 0.04, 300)
    tol = 1e-13

    def close(a, b):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=tol)

    for name in ("icrf_to_observed", "icrf_to_observed_radec"):
        for a, b in zip(getattr(t, name)(ra, dec), getattr(j, name)(ra, dec)):
            close(a, b)
    az, alt = j.icrf_to_observed(ra, dec)
    for a, b in zip(t.observed_to_icrf(az, alt), j.observed_to_icrf(az, alt)):
        close(a, b)
    rob, dob = j.icrf_to_observed_radec(ra, dec)
    for a, b in zip(t.observed_radec_to_icrf(rob, dob),
                    j.observed_radec_to_icrf(rob, dob)):
        close(a, b)
    for name in ("parallactic_angle", "parallactic_angle_observed",
                 "pseudo_parallactic_angle"):
        close(getattr(t, name)(), getattr(j, name)())
    close([t.bore_az, t.bore_alt, t.last], [j.bore_az, j.bore_alt, j.last])
    assert (t.k1, t.k2) == (j.k1, j.k2)
    np.testing.assert_array_equal(t.icrf2tod, j.icrf2tod)
    np.testing.assert_array_equal(t.vel, j.vel)
    for f in ("nutation", "gmst", "gast", "mean_obliquity"):
        assert getattr(TA, f)(mjd) == getattr(JA, f)(mjd)


def test_observation_with_eop_file(tmp_path):
    """load_iers_finals / eop_for_mjd on a finals-format file: polar
    motion and UT1-UTC enter as in the JAX package."""
    rows = []
    for i, mjd in enumerate(range(60670, 60680)):
        ln = [" "] * 80
        for pos, txt in ((7, f"{mjd:8.2f}"), (18, f"{0.1 + 0.01 * i:9.6f}"),
                         (37, f"{0.3 - 0.02 * i:9.6f}"),
                         (58, f"{-0.05 + 0.001 * i:10.7f}")):
            ln[pos:pos + len(txt)] = txt
        rows.append("".join(ln))
    path = tmp_path / "finals.all"
    path.write_text("\n".join(rows) + "\n")
    assert TA.eop_for_mjd(str(path), 60674.2) == JA.eop_for_mjd(str(path),
                                                                 60674.2)
    j = JA.Observation(30 * DEG, -20 * DEG, 60674.2, eop=str(path))
    t = TA.Observation(30 * DEG, -20 * DEG, 60674.2, eop=str(path))
    assert (t.xp_as, t.yp_as, t.dut1) == (j.xp_as, j.yp_as, j.dut1) != (
        0.0, 0.0, 0.0)
    assert abs(t.bore_alt - j.bore_alt) <= 1e-13
    assert abs(t.bore_az - j.bore_az) <= 1e-13


@pytest.mark.parametrize("band", ["r", "u"])
def test_prescription_and_perturbations_bit_equal(band):
    j = JL.load_telescope(band=band, perturbations=PERTURB + [
        {"L3": {"rotY": 1e-4, "zernikes": {"coef": [1e-8, 2e-8],
                                           "start_j": 4}}},
        {"LSSTCamera": {"rotZ": 2e-4}}], focusZ=1e-5).fiducial
    t = TL.load_telescope(band=band, perturbations=PERTURB + [
        {"L3": {"rotY": 1e-4, "zernikes": {"coef": [1e-8, 2e-8],
                                           "start_j": 4}}},
        {"LSSTCamera": {"rotZ": 2e-4}}], focusZ=1e-5).fiducial
    for k in ("z0", "c", "kappa", "coefs", "aper", "shift", "rot", "zk"):
        a, b = getattr(t, k), getattr(j, k)
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert (t.kinds, t.names) == (j.kinds, j.names)
    assert t.det_z == j.det_z
    d = t.with_focus_shift(1.5e-3)
    assert d.det_z == j.with_focus_shift(1.5e-3).det_z
    assert TTel.rubin_prescription()[3]["name"] == \
        JTel.rubin_prescription()[3]["name"]
    # the float32 block K2 reads is the exported converter's
    np.testing.assert_array_equal(t.matrix().surf,
                                  CV.telescope_from_numpy(j).surf)
    assert t.matrix().surf.dtype == np.float32
    assert t.matrix(np.float64).surf.dtype == np.float64
    # K2 reads only the float32 block
    ctx = CV.load_ccd_state(device="cpu").ctx
    raychain.chain_params(t.matrix(), ctx, True, True, True)
    with pytest.raises(ValueError, match="float32"):
        raychain.chain_params(t.matrix(np.float64), ctx, True, True, True)
    # the legacy per-mirror fea shorthand (tests/test_torch_fea.py holds
    # the fea terms)
    np.testing.assert_array_equal(
        TL.load_telescope(band=band, fea={"M1": [1e-8]}).fiducial.zk,
        JL.load_telescope(band=band, fea={"M1": [1e-8]}).fiducial.zk)
    with pytest.raises(ValueError):
        TL.load_telescope(perturbations={"M1": {"tilt": 1.0}})


def test_host_trace_matches_numpy_trace(visit):
    """The port's trace on float64 CPU tensors with the float64 matrix
    against the JAX package's trace with xp=numpy: 1e-12 m, the same
    vignette flags, over chief and pupil-filling rays."""
    det = visit["det"]
    jt = visit["jf"].telescope.for_detector(det, 1.5e-3)
    tt = visit["tf"].telescope.for_detector(det, 1.5e-3)
    rng = np.random.default_rng(2)
    n = 3000
    thx, thy = rng.uniform(-0.035, 0.035, n), rng.uniform(-0.035, 0.035, n)
    r = np.sqrt(rng.uniform(2.4**2, 4.3**2, n))
    a = rng.uniform(0, 2 * np.pi, n)
    wl = rng.uniform(350.0, 1000.0, n)
    rays = j_rays(np, thx, thy, r * np.cos(a), r * np.sin(a))
    want = j_trace(jt, *rays, wl, np)
    f64 = [torch.as_tensor(v) for v in rays]
    got = TTr.trace(tt.host, *f64, torch.as_tensor(wl))
    assert got["x"].dtype == torch.float64
    np.testing.assert_array_equal(got["vignette"].numpy(), want["vignette"])
    assert 0 < want["vignette"].sum() < n
    for k in ("x", "y", "vx", "vy", "vz"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-12, err_msg=k)
    x, y = host_trace(tt, thx, thy, 622.0)
    w = j_trace(jt, *j_rays(np, thx, thy, np.zeros(n), np.zeros(n)),
                np.full(n, 622.0), np)
    np.testing.assert_allclose(x, w["x"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(y, w["y"], rtol=0, atol=1e-12)


def test_wcs_matches(visit):
    """The detector's TAN-SIP WCS: xy_to_radec on a pixel grid to 1e-10
    rad, radec_to_xy back, and the header cards."""
    jw = visit["jf"].get_wcs(visit["jccd"])
    tw = visit["tf"].get_wcs(visit["tccd"])
    b = visit["tccd"].bounds
    gx, gy = np.meshgrid(np.linspace(0, b.width - 1, 41),
                         np.linspace(0, b.height - 1, 37))
    ra_t, dec_t = tw.xy_to_radec(gx.ravel(), gy.ravel())
    ra_j, dec_j = jw.xy_to_radec(gx.ravel(), gy.ravel())
    np.testing.assert_allclose(ra_t, ra_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose(dec_t, dec_j, rtol=0, atol=1e-10)
    x, y = tw.radec_to_xy(ra_j, dec_j)
    np.testing.assert_allclose(x, gx.ravel(), atol=1e-3)
    np.testing.assert_allclose(y, gy.ravel(), atol=1e-3)
    hj, ht = jw.header_cards(), tw.header_cards()
    assert hj.keys() == ht.keys()
    for k, v in hj.items():
        if isinstance(v, str):
            assert ht[k] == v
        else:
            np.testing.assert_allclose(ht[k], v, rtol=1e-9, atol=1e-15)
    assert abs(tw.pixel_scale() - jw.pixel_scale()) <= 1e-9
    # the fit itself on the same samples
    rng = np.random.default_rng(4)
    xs, ys = rng.uniform(0, 4000, 200), rng.uniform(0, 4000, 200)
    ra, dec = jw.xy_to_radec(xs, ys)
    a, c = t_fit(xs, ys, ra, dec), j_fit(xs, ys, ra, dec)
    np.testing.assert_allclose(a.xy_to_radec(xs, ys), c.xy_to_radec(xs, ys),
                               rtol=0, atol=1e-12)


def test_factory_frames_and_optics_context(visit):
    """Field angles through the factory, the alt-az Jacobian, and the
    optics context (every float32 field bit-equal)."""
    jf, tf = visit["jf"], visit["tf"]
    rng = np.random.default_rng(6)
    ra = jf.obs.boresight[0] + rng.uniform(-0.03, 0.03, 500)
    dec = jf.obs.boresight[1] + rng.uniform(-0.03, 0.03, 500)
    for a, b in zip(tf.icrf_to_field(ra, dec), jf.icrf_to_field(ra, dec)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-13)
    thx, thy = jf.icrf_to_field(ra, dec)
    for a, b in zip(tf.field_to_icrf(thx, thy), jf.field_to_icrf(thx, thy)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-13)
    np.testing.assert_allclose(tf.altaz_to_field_jacobian(),
                               jf.altaz_to_field_jacobian(), rtol=0,
                               atol=1e-12)
    assert abs(tf._efl - jf._efl) <= 1e-9
    for a, b in zip(tf.det_field_center(visit["tccd"]),
                    jf.det_field_center(visit["jccd"])):
        assert abs(a - b) <= 1e-13
    ctx = make_optics_context(tf, visit["tccd"])
    assert ctx == CV.optics_context_from_numpy(j_context(jf, visit["jccd"]))
