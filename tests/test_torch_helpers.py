"""The JAX package's remaining public helpers against their port
counterparts on the CPU, one case each (no runner path reaches them):
the chromatic photon ops, the double-Gaussian and Sersic samplers (fed
the JAX package's own draws, rebuilt from its key splits), the field
rotation angle and rate, the PhotonBatch constructors and transforms,
the image-domain first kick, the culling WCS, the telescope's
perturbation API, the surface sag, air index and the split trace
(surface_scalars / trace_surfaces), the host-strided batches and the
device batch assignment, add_stamp, the cosmic-ray bank's npz and FITS
writers, the process-info stage rows, the native sky catalog's
component lookup, the uniform-table builders and the scene's column
views.  float64 paths are held to 1e-12 relative or bit for bit,
float32 ones to float32 rounding."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imsim_tpu.image import cosmic_rays as JC
from imsim_tpu.image import fft_render as JF
from imsim_tpu.image import photon_pooling as JPP
from imsim_tpu.image import scene as JS
from imsim_tpu.optics import geometry as JG
from imsim_tpu.optics import telescope as JT
from imsim_tpu.optics import trace as JTr
from imsim_tpu.photons import batch as JB
from imsim_tpu.photons import diffraction as JD
from imsim_tpu.photons import ops as JO
from imsim_tpu.photons import profiles as JP
from imsim_tpu.psf import atmosphere as JA
from imsim_tpu.utils import lookup as JL
from imsim_tpu.utils import process_info as JPI
from imsim_tpu_torch import convert as CV
from imsim_tpu_torch.image import cosmic_rays as TC
from imsim_tpu_torch.image import fft_render as TF
from imsim_tpu_torch.image import photon_pooling as TPP
from imsim_tpu_torch.image import scene as TS
from imsim_tpu_torch.optics import geometry as TG
from imsim_tpu_torch.optics import telescope as TT
from imsim_tpu_torch.optics import trace as TTr
from imsim_tpu_torch.photons import batch as TB
from imsim_tpu_torch.photons import diffraction as TD
from imsim_tpu_torch.photons import ops as TO
from imsim_tpu_torch.photons import profiles as TP
from imsim_tpu_torch.psf import atmosphere as TA
from imsim_tpu_torch.utils import lookup as TL
from imsim_tpu_torch.utils import process_info as TPI

torch.set_num_threads(1)

T = torch.as_tensor
RNG = np.random.default_rng(20261017)
WL = RNG.uniform(350.0, 1050.0, 512)
DEG = np.pi / 180


def _close(got, want, rtol, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _air_n_minus_one():
    _close(TO.air_refractive_index_minus_one(T(WL)),
           JO.air_refractive_index_minus_one(WL), 1e-15)


def _refraction_angle():
    w = np.float32(WL)
    _close(TO.refraction_angle(T(w), 0.7), JO.refraction_angle(w, 0.7),
           1e-6)


def _photon_dcr():
    w = np.float32(WL)
    x, y = np.float32(RNG.uniform(0, 4000, (2, 512)))
    got = TO.photon_dcr(T(x), T(y), T(w), 622.0, 0.6, 0.3)
    want = JO.photon_dcr(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                         622.0, 0.6, 0.3)
    for g, wv in zip(got, want):
        _close(g, wv, 0, 2e-3)       # pixels of ~4000: float32 rounding


def _focus_depth():
    a = np.float32(RNG.normal(size=(4, 256)))
    got = TO.focus_depth(*map(T, a), 12.5)
    want = JO.focus_depth(*map(jnp.asarray, a), 12.5)
    for g, wv in zip(got, want):
        _close(g, wv, 0)


def _silicon_refraction():
    s = np.float32(RNG.normal(0, 0.2, (2, 512)))
    got = TO.silicon_refraction(T(s[0]), T(s[1]), T(np.float32(WL)))
    want = JO.silicon_refraction(jnp.asarray(s[0]), jnp.asarray(s[1]),
                                 jnp.asarray(np.float32(WL)))
    for g, wv in zip(got, want):
        _close(g, wv, 1e-6)


def _bandpass_ratio():
    xs = np.linspace(300, 1100, 81)
    tj = [JL.UniformTable.from_pairs(xs, f(xs)) for f in
          (lambda v: np.exp(-((v - 600) / 150) ** 2), lambda v: v / 1100)]
    tt = [TL.UniformTable.from_pairs(xs, f(xs), device="cpu") for f in
          (lambda v: np.exp(-((v - 600) / 150) ** 2), lambda v: v / 1100)]
    flux = np.float32(RNG.uniform(0.5, 2.0, 512))
    w = np.float32(WL)
    _close(TO.bandpass_ratio(T(flux), T(w), *tt),
           JO.bandpass_ratio(jnp.asarray(flux), jnp.asarray(w), *tj), 1e-6)


def _double_gaussian():
    key = jax.random.PRNGKey(5)
    n = 4096
    k1, k2, _ = jax.random.split(key, 3)
    u = np.asarray(jax.random.uniform(k1, (n,), jnp.float32))
    xy = np.asarray(jax.random.normal(k2, (n, 2), jnp.float32))
    got = TP.sample_double_gaussian(None, n, 0.6, 1.4, 0.8,
                                    draws=(T(u), T(xy)))
    want = JP.sample_double_gaussian(key, n, 0.6, 1.4, 0.8)
    for g, wv in zip(got, want):
        _close(g, wv, 1e-7)


def _sersic():
    key = jax.random.PRNGKey(6)
    n = 4096
    ku, kt = jax.random.split(key)
    u = np.asarray(jax.random.uniform(ku, (n,), jnp.float32, 0.0, 1.0))
    tu = np.asarray(jax.random.uniform(kt, (n,), jnp.float32))
    sn = np.float32(RNG.uniform(0.5, 5.0, n))
    hlr = np.float32(RNG.uniform(0.2, 2.0, n))
    got = TP.sample_sersic(None, n, T(sn), T(hlr), draws=(T(u), T(tu)))
    want = JP.sample_sersic(key, n, jnp.asarray(sn), jnp.asarray(hlr))
    for g, wv in zip(got, want):
        _close(g, wv, 0, 2e-5 * float(np.abs(np.asarray(wv)).max()))


def _vonkarman():
    k = np.geomspace(1e-3, 1e3, 64)
    _close(TP.vonkarman_phase_spectrum(k, 0.15, 25.0),
           JP.vonkarman_phase_spectrum(k, 0.15, 25.0), 1e-14)
    rho = np.linspace(0.01, 8.0, 16)
    _close(TP.vonkarman_structure(rho, 0.15, 25.0),
           JP.vonkarman_structure(rho, 0.15, 25.0), 1e-12)


def _field_rotation_angle():
    t = np.linspace(0.0, 30.0, 31)
    got = TD.field_rotation_angle(T(t), -0.5278, 1.1, 0.4)
    want = JD.field_rotation_angle(t, -0.5278, 1.1, 0.4, xp=np)
    _close(got, want, 1e-12, 1e-15)


def _field_rotation_rate():
    got = TD.field_rotation_rate(-0.5278, 1.1, 0.4)
    _close(got, JD.field_rotation_rate(-0.5278, 1.1, 0.4), 1e-6)


def _batches():
    """(port, JAX) PhotonBatch pairs with the same float32 fields."""
    out = []
    for n in (100, 37):
        f = {k: np.float32(RNG.normal(size=n))
             for k in ("x", "y", "flux", "wavelength", "dxdz", "dydz",
                       "pupil_u", "pupil_v", "time")}
        out.append((TB.PhotonBatch(**{k: T(v) for k, v in f.items()}),
                    JB.PhotonBatch(**{k: jnp.asarray(v)
                                      for k, v in f.items()})))
    return out


def _batch_equal(tb, jbatch):
    for k in ("x", "y", "flux", "wavelength", "dxdz", "dydz", "pupil_u",
              "pupil_v", "time"):
        _close(getattr(tb, k), getattr(jbatch, k), 0)


def _batch_zeros():
    _batch_equal(TB.PhotonBatch.zeros(64, device="cpu"),
                 JB.PhotonBatch.zeros(64))


def _batch_concat():
    (t1, j1), (t2, j2) = _batches()
    _batch_equal(TB.PhotonBatch.concat([t1, t2]),
                 JB.PhotonBatch.concat([j1, j2]))


def _batch_shifted_scaled_total():
    (t1, j1), _ = _batches()
    _batch_equal(t1.shifted(1.5, -2.25), j1.shifted(1.5, -2.25))
    _batch_equal(t1.scaled_flux(0.7), j1.scaled_flux(0.7))
    _close(t1.total_flux(), j1.total_flux(), 1e-6)


def _first_kick():
    screens = JA.make_screens(42 + 271828, JA.AtmConfig(fwhm=0.7,
                                                        screen_size=51.2))
    (tb, jbatch), _ = _batches()
    f32 = np.float32
    pu, pv = f32(RNG.uniform(-4, 4, (2, 100)))
    t = f32(RNG.uniform(0, 30, 100))
    tb = tb.replace(pupil_u=T(pu), pupil_v=T(pv), time=T(t))
    jbatch = jbatch.replace(pupil_u=jnp.asarray(pu),
                            pupil_v=jnp.asarray(pv), time=jnp.asarray(t))
    got = TA.first_kick(tb, CV.screens_from_numpy(screens, "cpu"), 0.2,
                        0.001, -0.002)
    want = JA.first_kick(jbatch, screens, 0.2, 0.001, -0.002)
    _close(got.x, want.x, 0, 1e-3)   # 1e-9 rad kicks over 0.2" pixels
    _close(got.y, want.y, 0, 1e-3)


def _culling_wcs():
    from imsim_tpu.electronics.camera import get_camera as jcam
    from imsim_tpu.optics.wcs_factory import make_wcs_factory as jfac
    from imsim_tpu_torch.electronics.camera import get_camera as tcam
    from imsim_tpu_torch.optics.wcs_factory import make_wcs_factory as tfac

    jw = jfac(30 * DEG, -20 * DEG, 60674.2).make_culling_wcs(
        jcam()["R22_S11"])
    tw = tfac(30 * DEG, -20 * DEG, 60674.2).make_culling_wcs(
        tcam()["R22_S11"])
    x, y = RNG.uniform(0, 4000, (2, 64))
    for g, wv in zip(tw.xy_to_radec(x, y), jw.xy_to_radec(x, y)):
        _close(g, wv, 0, 1e-10)


def _telescopes():
    return JT.make_telescope(), TT.make_telescope()


def _telescope_perturbations():
    j, t = _telescopes()
    zk = np.linspace(1e-8, 5e-8, 6)
    jj = (j.with_shift("M2", (1e-5, -2e-5, 3e-6))
          .with_rot("M1", "x", 1e-5).with_rot("M3", "y", -2e-5)
          .with_rot("L1_entrance", "z", 3e-5).with_zernikes("M1", zk, 4)
          .with_focus_shift(2e-5))
    tt = (t.with_shift("M2", (1e-5, -2e-5, 3e-6))
          .with_rot("M1", "x", 1e-5).with_rot("M3", "y", -2e-5)
          .with_rot("L1_entrance", "z", 3e-5).with_zernikes("M1", zk, 4)
          .with_focus_shift(2e-5))
    for k in ("z0", "c", "kappa", "coefs", "aper", "shift", "rot", "zk"):
        np.testing.assert_array_equal(getattr(tt, k), getattr(jj, k), k)
    assert tt.det_z == jj.det_z and tt.kinds == jj.kinds


def _surface_sag():
    x, y = RNG.uniform(-4, 4, (2, 256))
    coefs = (1e-4, -2e-6, 3e-8)
    got = TG.surface_sag(T(x), T(y), 0.05, -1.2, coefs)
    _close(got, JG.surface_sag(np, x, y, 0.05, -1.2, coefs), 1e-15)


def _air_index():
    _close(TG.air_index(T(WL)), JG.air_index(np, WL), 0, 1e-16)


def _surface_scalars():
    j, t = _telescopes()
    js = JTr.surface_scalars(j, np)
    ts = TTr.surface_scalars(t.host)
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        assert a[0] == b[0] and a[1] == b[1] and a[3:5] == b[3:5]
        assert tuple(map(float, a[2])) == b[2]
        assert tuple(map(float, a[5])) == b[5]
        assert tuple(map(float, a[6])) == b[6]


def _trace_surfaces():
    j, t = _telescopes()
    n = 256
    thx, thy = RNG.uniform(-0.02, 0.02, (2, n))
    r = np.sqrt(RNG.uniform(0.4, 0.98, n)) * 4.18
    a = RNG.uniform(0, 2 * np.pi, n)
    rays = JTr.rays_from_field(np, thx, thy, r * np.cos(a), r * np.sin(a))
    wl = np.full(n, 622.0)
    want = JTr.trace_surfaces(np, JTr.surface_scalars(j, np), j.kinds,
                              *rays, wl, with_path=True)
    got = TTr.trace_surfaces(TTr.surface_scalars(t.host), t.kinds,
                             *map(T, rays), T(wl), with_path=True)
    for k in ("x", "y", "vx", "vy", "vz", "path"):
        _close(got[k], want[k], 0, 1e-12)
    np.testing.assert_array_equal(got["vignette"].numpy(), want["vignette"])


def _hosts():
    """(port, JAX) SceneHosts of 40 objects with the same columns."""
    n = 40
    wl = np.broadcast_to(np.linspace(400, 700, JS.WL_CDF_K,
                                     dtype=np.float32), (n, JS.WL_CDF_K))
    cols = dict(x=RNG.uniform(0, 100, n), y=RNG.uniform(0, 100, n),
                obj_type=RNG.integers(0, 2, n), p0=RNG.uniform(0.3, 1, n),
                p1=np.ones(n), p2=RNG.uniform(0.3, 1, n), p3=np.zeros(n),
                g1=np.zeros(n), g2=np.zeros(n), mu=np.ones(n), wl_icdf=wl)
    flux = RNG.integers(0, 400, n).astype(np.float64)
    th = TS.SceneHost(scene=TS.DeviceScene.from_columns(**cols,
                                                        device="cpu"),
                      flux=flux, nominal_flux=flux, n_objects=n)
    jh = JS.SceneHost(scene=JS.DeviceScene.from_columns(**cols),
                      flux=flux, nominal_flux=flux, n_objects=n)
    return th, jh, cols


def _strided_batches():
    th, jh, _ = _hosts()
    modes = np.where(np.arange(40) % 7 == 0, TPP.FFT, TPP.PHOT)
    cfg_t = TPP.PoolingConfig(nbatch=3, batch_size=5000)
    cfg_j = JPP.PoolingConfig(nbatch=3, batch_size=5000)
    got = list(TPP.make_strided_batches(th, modes, cfg_t))
    want = list(JPP.make_strided_batches(jh, modes, cfg_j))
    assert len(got) == len(want) == 3
    for (gi, gw), (wi, ww) in zip(got, want):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gw.numpy(), np.asarray(ww))


def _batch_obj_assignment():
    counts = RNG.integers(0, 50, 30)
    cum = np.cumsum(counts).astype(np.int32)
    total = int(cum[-1])
    for b in range(3):
        go, ga = TPP.batch_obj_assignment(T(cum), total, b, 3, 400)
        wo, wa = JPP.batch_obj_assignment(jnp.asarray(cum), total, b, 3,
                                          400)
        np.testing.assert_array_equal(go.numpy(), np.asarray(wo))
        np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))


def _add_stamp():
    img = np.float32(RNG.uniform(0, 1, (48, 64)))
    st = np.float32(RNG.uniform(0, 1, (16, 16)))
    for x0, y0 in ((3, 5), (-6, 40), (55, -4)):
        _close(TF.add_stamp(T(img), T(st), x0, y0),
               JF.add_stamp(jnp.asarray(img), jnp.asarray(st), x0, y0), 0)


def _cr_save(tmp_path):
    cat = TC.CosmicRayCatalog.synthesize(n=20, seed=3)
    cat.save(str(tmp_path / "t.npz"))
    JC.CosmicRayCatalog(cat.footprints).save(str(tmp_path / "j.npz"))
    a = JC.CosmicRayCatalog.load(str(tmp_path / "t.npz"))
    b = TC.CosmicRayCatalog.load(str(tmp_path / "j.npz"))
    for fa, fb, f0 in zip(a.footprints, b.footprints, cat.footprints):
        for u, v, w in zip(fa, fb, f0):
            np.testing.assert_array_equal(u, w)
            np.testing.assert_array_equal(v, w)


def _cr_fits(tmp_path):
    cat = TC.CosmicRayCatalog.synthesize(n=20, seed=4)
    cat.write_catalog_fits(str(tmp_path / "t.fits"), exptime=30.0)
    JC.CosmicRayCatalog(cat.footprints).write_catalog_fits(
        str(tmp_path / "j.fits"), exptime=30.0)
    assert (tmp_path / "t.fits").read_bytes() == \
        (tmp_path / "j.fits").read_bytes()
    back, rate = TC.CosmicRayCatalog.read_catalog_fits(
        str(tmp_path / "t.fits"))
    assert len(back) == 20 and rate == 20 / 30.0


def _process_rows(tmp_path):
    TPI._rows.clear()
    with TPI.stage_profile("render"):
        pass
    (row,) = TPI.rows()
    assert row["stage"] == "render" and row["wall_s"] >= 0
    JPI._rows[:] = [dict(row)]
    TPI.write_catalog(str(tmp_path / "t.txt"))
    JPI.write_catalog(str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_text() == \
        (tmp_path / "j.txt").read_text()
    JPI._rows.clear()
    TPI._rows.clear()


def _component_spec(tmp_path):
    from imsim_tpu.catalog.skycat_native import NativeSkyCatalog as JN
    from imsim_tpu_torch.catalog.skycat_native import NativeSkyCatalog as TN

    y = tmp_path / "sky.yaml"
    y.write_text("area_partition: {type: healpix, ordering: ring, "
                 "nside: 32}\nobject_types:\n"
                 "  galaxy: {composite: {bulge: required, disk: required}}\n"
                 "  bulge_basic: {parent: galaxy, subtype: bulge}\n"
                 "  disk_basic: {parent: galaxy, subtype: disk}\n"
                 "  star: {file_template: 'pointsource_(?P<healpix>\\d+)'}\n")
    tn, jn = TN(str(y)), JN(str(y))
    for parent, sub in (("galaxy", "bulge"), ("galaxy", "disk"),
                        ("galaxy", "knots"), ("star", "bulge")):
        a, b = tn.component_spec(parent, sub), jn.component_spec(parent, sub)
        assert (a is None and b is None) or a.name == b.name


def _uniform_tables():
    x = RNG.uniform(0, 10, 50)
    y = np.sin(x)
    for got, want in (
            (TL.UniformTable.from_pairs(x, y, 64, device="cpu"),
             JL.UniformTable.from_pairs(x, y, 64)),
            (TL.UniformTable.from_func(np.cos, 0.5, 7.5, 33, device="cpu"),
             JL.UniformTable.from_func(np.cos, 0.5, 7.5, 33))):
        assert (got.x0, got.dx) == (want.x0, want.dx)
        _close(got.y, want.y, 0)


def _scene_views():
    th, jh, _ = _hosts()
    for k in ("x", "y", "obj_type"):
        got, want = getattr(th.scene, k), getattr(jh.scene, k)
        assert got.dtype == (torch.int32 if k == "obj_type"
                             else torch.float32)
        _close(got, want, 0)


CASES = dict(
    air_refractive_index_minus_one=_air_n_minus_one,
    refraction_angle=_refraction_angle, photon_dcr=_photon_dcr,
    focus_depth=_focus_depth, silicon_refraction=_silicon_refraction,
    bandpass_ratio=_bandpass_ratio,
    sample_double_gaussian=_double_gaussian, sample_sersic=_sersic,
    vonkarman=_vonkarman, field_rotation_angle=_field_rotation_angle,
    field_rotation_rate=_field_rotation_rate,
    PhotonBatch_zeros=_batch_zeros, PhotonBatch_concat=_batch_concat,
    PhotonBatch_shifted_scaled_total=_batch_shifted_scaled_total,
    first_kick=_first_kick, make_culling_wcs=_culling_wcs,
    telescope_perturbations=_telescope_perturbations,
    surface_sag=_surface_sag, air_index=_air_index,
    surface_scalars=_surface_scalars, trace_surfaces=_trace_surfaces,
    make_strided_batches=_strided_batches,
    batch_obj_assignment=_batch_obj_assignment, add_stamp=_add_stamp,
    uniform_tables=_uniform_tables, scene_views=_scene_views)
FILE_CASES = dict(CosmicRayCatalog_save=_cr_save,
                  write_catalog_fits=_cr_fits, process_info=_process_rows,
                  component_spec=_component_spec)


@pytest.mark.parametrize("name", sorted(CASES))
def test_helper_matches_the_jax_package(name):
    CASES[name]()


@pytest.mark.parametrize("name", sorted(FILE_CASES))
def test_helper_with_files_matches_the_jax_package(name, tmp_path):
    FILE_CASES[name](tmp_path)


def test_trace_is_trace_surfaces_of_its_scalars():
    """The port's trace delegates to trace_surfaces: the same rays."""
    _, t = _telescopes()
    n = 64
    thx, thy = RNG.uniform(-0.02, 0.02, (2, n))
    rays = TTr.rays_from_field(T(thx), T(thy), T(np.full(n, 2.5)),
                               T(np.full(n, 1.0)))
    a = TTr.trace(t.host, *rays, T(np.full(n, 622.0)))
    b = TTr.trace_surfaces(TTr.surface_scalars(t.host), t.kinds, *rays,
                           T(np.full(n, 622.0)))
    for k in ("x", "y", "vx", "vy", "vz"):
        assert torch.equal(a[k], b[k])
    assert dataclasses.is_dataclass(t)
