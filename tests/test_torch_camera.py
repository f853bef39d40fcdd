"""The port's host code for a CCD's hardware state against the JAX
package's: the camera model (every CCD of LsstCam and LsstComCamSim),
the coordinate helpers, tree rings, the vendor BF kernels, the
vignetting profile and grid, and the readout parameters.  All are host
numpy copies drawn from the same sha256-seeded generators, so every
value is bit-equal."""
import json
import os

import numpy as np
import pytest
import torch

from imsim_tpu.electronics import camera as JC
from imsim_tpu.electronics.readout import CcdReadout as JReadout
from imsim_tpu.image import vignetting as JV
from imsim_tpu.sensor import silicon as JS
from imsim_tpu.sensor import treerings as JT
from imsim_tpu.utils import coords as JCo
from imsim_tpu_torch.electronics import camera as TC
from imsim_tpu_torch.electronics.readout import CcdReadout
from imsim_tpu_torch.image import vignetting as TV
from imsim_tpu_torch.sensor import silicon as TS
from imsim_tpu_torch.sensor import treerings as TT
from imsim_tpu_torch.utils import coords as TCo

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DETS = ("R22_S11", "R10_S11", "R00_SW0")


def _amp_fields(amp):
    return (amp.name, amp.bounds, amp.raw_bounds, amp.raw_data_bounds,
            amp.raw_flip_x, amp.raw_flip_y, amp.gain, amp.read_noise,
            amp.bias_level, amp.full_well)


def _same_bounds(a, b):
    return (a.xmin, a.xmax, a.ymin, a.ymax) == (b.xmin, b.xmax, b.ymin,
                                                b.ymax)


@pytest.mark.parametrize("camera", ["LsstCam", "LsstComCamSim",
                                    "LsstCamSim"])
def test_camera_bit_equal(camera):
    """Every CCD and amp: geometry, vendor, serial, centre, height, yaw,
    full well, crosstalk and the per-amp electronics."""
    j, t = JC.Camera(camera), TC.Camera(camera)
    assert j.det_names == t.det_names and list(j) == list(t)
    for name in j.det_names:
        a, b = j[name], t[name]
        assert (a.vendor, a.serial, a.center_mm, a.full_well, a.height_mm,
                a.rot_deg) == (b.vendor, b.serial, b.center_mm, b.full_well,
                               b.height_mm, b.rot_deg), name
        assert _same_bounds(a.bounds, b.bounds), name
        assert a.xtalk.dtype == b.xtalk.dtype
        np.testing.assert_array_equal(a.xtalk, b.xtalk, err_msg=name)
        assert a.amp_names == b.amp_names
        for amp in a.amp_names:
            fa, fb = _amp_fields(a[amp]), _amp_fields(b[amp])
            assert fa[0] == fb[0] and fa[4:] == fb[4:], (name, amp)
            assert all(_same_bounds(x, y) for x, y in zip(fa[1:4], fb[1:4]))
    assert t.det_num("R22_S11") == j.det_num("R22_S11")
    assert t.det_name(5) == j.det_name(5)


def test_camera_files_and_focal_transforms(tmp_path):
    """The optional bias and overrides JSON files, and the pixel <->
    focal-plane maps with a yaw."""
    bias = {"R22_S11": {"C03": 1234.5}}
    ov = {"R22_S11": {"gains": {"C00": 1.5}, "read_noise": {"C01": 4.0},
                      "full_well": 123_000.0, "rot_deg": 0.1,
                      "height_mm": 0.02, "xtalk": np.eye(16).tolist()}}
    bf, of = tmp_path / "bias.json", tmp_path / "ov.json"
    bf.write_text(json.dumps(bias))
    of.write_text(json.dumps(ov))
    j = JC.get_camera("LsstCamSim", str(bf), str(of))["R22_S11"]
    t = TC.get_camera("LsstCamSim", str(bf), str(of))["R22_S11"]
    assert t["C03"].bias_level == 1234.5 and t["C00"].gain == 1.5
    assert t.rot_deg == 0.1 and t.full_well == 123_000.0
    for amp in j.amp_names:
        assert _amp_fields(j[amp])[4:] == _amp_fields(t[amp])[4:]
    np.testing.assert_array_equal(j.xtalk, t.xtalk)
    # a missing file keeps the synthesized values
    assert TC.Camera("LsstCamSim", str(tmp_path / "none.json"))[
        "R22_S11"]["C03"].bias_level == 1000.0
    rng = np.random.default_rng(3)
    x, y = rng.uniform(0, 4096, 50), rng.uniform(0, 4004, 50)
    for ccd_j, ccd_t in ((j, t), (JC.get_camera("LsstCam")["R00_SW0"],
                                  TC.get_camera("LsstCam")["R00_SW0"])):
        for a, b in zip(JC.pixel_to_focal_mm(ccd_j, x, y),
                        TC.pixel_to_focal_mm(ccd_t, x, y)):
            np.testing.assert_array_equal(a, b)
        fx, fy = TC.pixel_to_focal_mm(ccd_t, x, y)
        for a, b in zip(JC.focal_mm_to_pixel(ccd_j, fx, fy),
                        TC.focal_mm_to_pixel(ccd_t, fx, fy)):
            np.testing.assert_array_equal(a, b)
    assert t.bounds.section_keyword(True, False) == \
        j.bounds.section_keyword(True, False)


def test_coords_bit_equal():
    rng = np.random.default_rng(5)
    ra, dec = rng.uniform(0, 2 * np.pi, 200), rng.uniform(-1.4, 1.4, 200)
    ra0, dec0 = 0.6, -0.4
    u, v = rng.uniform(-0.03, 0.03, 200), rng.uniform(-0.03, 0.03, 200)
    pairs = [
        (TCo.normalize_ra(ra, 1.0), JCo.normalize_ra(ra, 1.0)),
        (TCo.radec_to_unit(ra, dec), JCo.radec_to_unit(ra, dec)),
        (TCo.unit_to_radec(JCo.radec_to_unit(ra, dec)),
         JCo.unit_to_radec(JCo.radec_to_unit(ra, dec))),
        (TCo.angular_separation(ra, dec, ra0, dec0),
         JCo.angular_separation(ra, dec, ra0, dec0)),
        (TCo.gnomonic_project(ra0 + u, dec0 + v, ra0, dec0),
         JCo.gnomonic_project(ra0 + u, dec0 + v, ra0, dec0)),
        (TCo.gnomonic_deproject(u, v, ra0, dec0),
         JCo.gnomonic_deproject(u, v, ra0, dec0)),
        (TCo.gnomonic_to_dircos(u, v), JCo.gnomonic_to_dircos(u, v)),
        (TCo.dircos_to_gnomonic(*JCo.gnomonic_to_dircos(u, v)),
         JCo.dircos_to_gnomonic(*JCo.gnomonic_to_dircos(u, v)))]
    for got, want in pairs:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("det", DETS)
def test_tree_rings_bit_equal(det, tmp_path):
    """The generated model per detector (centre, profile, waves, env and
    the radial table), and the measured-file reader."""
    j, t = JT.TreeRings().get(det), TT.TreeRings().get(det)
    assert j.center == t.center and j.env == t.env and j.r_max == t.r_max
    for k in ("profile", "waves"):
        a, b = getattr(j, k), getattr(t, k)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (t.table.x0, t.table.dx) == (j.table.x0, j.table.dx)
    r = np.linspace(0.0, 9000.0, 777)
    np.testing.assert_array_equal(t.radial_displacement(r).numpy(),
                                  np.asarray(j.radial_displacement(r)))
    # a measured tree_ring_parameters block for this detector
    raft, sensor = det.split("_")
    rng = np.random.default_rng(11)
    lines = ["title\n", f"{raft[1]} {raft[2]} {sensor[1]} {sensor[2]} "
             f"-3000.5 -2500.25 0.3 1.2e-15\n", "cf cp sf sp\n"]
    lines += [" ".join(f"{v:.6f}" for v in (rng.uniform(90, 200),
                                              rng.uniform(0, 6),
                                              rng.uniform(90, 200),
                                              rng.uniform(0, 6))) + "\n"
              for _ in range(20)]
    path = tmp_path / "tr.txt"
    path.write_text("".join(lines))
    jm = JT.TreeRings(file_name=str(path)).get(det)
    tm = TT.TreeRings(file_name=str(path)).get(det)
    assert jm.center == tm.center and jm.env == tm.env
    np.testing.assert_array_equal(jm.profile, tm.profile)
    np.testing.assert_array_equal(jm.waves, tm.waves)


@pytest.mark.parametrize("vendor", ["ITL", "E2V", "ITL_WF"])
@pytest.mark.parametrize("strength", [0.4, 0.9])
def test_vendor_bf_kernel_bit_equal(vendor, strength):
    a = TS.vendor_bf_kernel(vendor, strength)
    b = JS.vendor_bf_kernel(vendor, strength)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_bf_kernel_files_byte_equal():
    """The port carries its own copies of the measured kernels."""
    for v in ("itl", "e2v"):
        with open(os.path.join(REPO, "imsim_tpu", "data",
                               f"bf_kernel_{v}.npy"), "rb") as f:
            ref = f.read()
        with open(os.path.join(REPO, "imsim_tpu_torch", "data",
                               f"bf_kernel_{v}.npy"), "rb") as f:
            assert f.read() == ref


def test_vignetting_bit_equal(tmp_path):
    """The profile, the image plane (coarse grid + bilinear upsample),
    and both file formats."""
    j, t = JV.Vignetting(), TV.Vignetting()
    r = np.linspace(0.0, 500.0, 1001)
    np.testing.assert_array_equal(t(r), j(r))
    ccd = TC.get_camera("LsstCamSim")["R10_S11"]
    ny, nx = 300, 260
    Y = (np.arange(ny) - (ny - 1) / 2) * 0.01 + ccd.center_mm[1]
    X = (np.arange(nx) - (nx - 1) / 2) * 0.01 + ccd.center_mm[0]
    for step in (1, 32):
        np.testing.assert_array_equal(
            t.image_plane(ccd.center_mm, (Y, X), step),
            j.image_plane(ccd.center_mm, (Y, X), step))
    assert t.at_sky_coord(321.0) == j.at_sky_coord(321.0)
    txt = tmp_path / "vig.txt"
    np.savetxt(txt, np.stack(JV.default_profile_samples(), 1) * [1, 0.9])
    np.testing.assert_array_equal(TV.Vignetting.from_file(str(txt))(r),
                                  JV.Vignetting.from_file(str(txt))(r))
    knots = tmp_path / "vig.json"
    t_k = [0, 0, 0, 0, 150, 300, 450, 450, 450, 450]
    knots.write_text(json.dumps([t_k, [1.0, 1.0, 0.97, 0.6, 0.2, 0.0],
                                 3]))
    np.testing.assert_array_equal(TV.Vignetting.from_file(str(knots))(r),
                                  JV.Vignetting.from_file(str(knots))(r))


@pytest.mark.parametrize("det", DETS)
def test_vignetting_grid_matches_the_state_exporter(det):
    """The sky stage's stride-32 grid, as tests/test_torch_state.py's
    exporter builds it from the JAX package's Vignetting."""
    from test_torch_state import vignetting_grid

    jccd = JC.get_camera("LsstCam")[det]
    tccd = TC.get_camera("LsstCam")[det]
    got = TV.Vignetting().coarse_grid(
        tccd.center_mm, (tccd.bounds.height, tccd.bounds.width), 32)
    want = vignetting_grid(jccd, 32)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("det", DETS)
def test_readout_from_ccd_bit_equal(det):
    """CcdReadout.from_ccd against the JAX package's CcdReadout(ccd):
    gains, read noises, bias levels, crosstalk, CTE bands, full well."""
    jccd = JC.get_camera("LsstCam")[det]
    tccd = TC.get_camera("LsstCam")[det]
    for kw in ({}, dict(read_noise=3.0, bias_level=900.0, full_well=9e4,
                        scti=2e-6)):
        jro = JReadout(jccd, **kw)
        tro = CcdReadout.from_ccd(tccd, "cpu", **kw)
        assert tro.vendor == jccd.vendor
        assert tro.full_well == float(jro.full_well)
        for k in ("gains", "read_noises", "bias_levels", "xtalk", "pcte",
                  "scte"):
            np.testing.assert_array_equal(getattr(tro, k).numpy(),
                                          np.asarray(getattr(jro, k)),
                                          err_msg=k)
