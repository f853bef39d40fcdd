"""Per-CCD state: built from the pointing and the detector, or read back
from an exported file.

  * `build_ccd_state` builds a CCD's state with no JAX: the camera, the
    astrometry, the telescope and its perturbations, the float64 host
    trace and the TAN-SIP WCS, the optics context, tree rings, the
    silicon, the atmosphere's screen spec and second-kick table, the
    profile tables, the readout parameters, the vignetting grid, and the
    bench catalog's field angles and pooling modes.  Every step runs on
    the host in numpy / float64, as in the JAX package; only the readout
    parameters go to `device`.
  * `load_ccd_state` reads the bench fixture: bench.py main()'s state for
    R22_S11 as the JAX package exported it
    (`imsim_tpu_torch/data/bench_r22_s11.npz`, written by `python
    tests/test_torch_state.py` where JAX is installed), through the
    `*_from_numpy` converters, which read containers attribute by
    attribute and never import JAX;
  * `synthetic_scene` reproduces bench.build_synthetic_host's numpy
    draws with the field angles from the state.

The visit and per-CCD steps (`visit_factory`, `ccd_optics`,
`runner_silicon`, `second_kick`, `profile_tables`) are shared with the
instance-catalog path (config/runner.py), which adds the catalog half:
the scene from the catalog and its SEDs, the sky model's level and
gradient, and the fringe map in y.
"""
from __future__ import annotations

import dataclasses
import os
import time
from types import SimpleNamespace

import numpy as np
import torch

from .electronics.camera import get_camera
from .electronics.readout import CcdReadout
from .image.photon_pooling import PoolingConfig, classify_objects, make_psf_mtf
from .image.scene import WL_CDF_K, DeviceScene, SceneHost
from .image.vignetting import Vignetting
from .optics.loader import load_telescope
from .optics.telescope import Telescope, surf_matrix
from .optics.wcs_factory import make_wcs_factory
from .photons.optics_ops import OpticsContext, make_optics_context
from .photons.profiles import (ProfileTables, SersicPoly, exp_disk_poly,
                               sersic_poly2d)
from .psf.atmosphere import (AtmConfig, AtmScreens, ScreenSpec,
                             second_kick_table, screen_spec)
from .sensor.silicon import (SiliconParams, absorption_length_table,
                             vendor_bf_kernel)
from .sensor.treerings import TreeRings
from .utils.lookup import PolyCDF

BENCH_STATE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "data", "bench_r22_s11.npz")

_CTX_F32 = ("bore_alt", "bore_az", "j01", "j11", "crot", "srot", "k1_ref",
            "k2_ref", "det_cx_mm", "det_cy_mm", "det_crot", "det_srot")
_CTX_F64 = ("latitude", "pressure_kpa", "temperature_k", "h2o_kpa")
_POLY = ("c_core", "c_tail", "u_split", "s_lo", "s_hi")
_SERSIC = ("D_core", "D_tail", "n_lo", "n_hi", "u_split", "s_lo", "s_hi")
_READOUT = ("vendor", "gains", "read_noises", "bias_levels", "xtalk",
            "full_well")


def _f32(v) -> float:
    return float(np.float32(np.asarray(v)))


# ---- containers -----------------------------------------------------------

def scene_from_numpy(scene, device) -> DeviceScene:
    """DeviceScene from an object with `params` and `wl_cheb` arrays and,
    where it has them, `wl_icdf`, `labs_icdf` and `aux_cloud`."""
    def t(name):
        a = getattr(scene, name, None)
        return None if a is None else torch.tensor(
            np.asarray(a, np.float32), device=device)

    return DeviceScene(params=t("params"), wl_cheb=t("wl_cheb"),
                       wl_icdf=t("wl_icdf"), labs_icdf=t("labs_icdf"),
                       aux_cloud=t("aux_cloud"))


def host_from_numpy(host, device) -> SceneHost:
    """SceneHost from the JAX package's SceneHost (or a look-alike)."""
    return SceneHost(scene=scene_from_numpy(host.scene, device),
                     flux=np.asarray(host.flux, np.float64),
                     nominal_flux=np.asarray(host.nominal_flux, np.float64),
                     n_objects=int(host.n_objects),
                     pix_x=getattr(host, "pix_x", None),
                     pix_y=getattr(host, "pix_y", None))


def telescope_from_numpy(tel) -> Telescope:
    """The (S, 16+K) surface matrix + kinds from a Telescope's arrays."""
    return Telescope(
        surf=surf_matrix(np.asarray(tel.z0), np.asarray(tel.c),
                         np.asarray(tel.kappa), np.asarray(tel.coefs),
                         np.asarray(tel.aper), np.asarray(tel.shift),
                         np.asarray(tel.rot)),
        kinds=tuple(int(k) for k in np.asarray(tel.kinds)))


def optics_context_from_numpy(ctx) -> OpticsContext:
    kw = {k: _f32(getattr(ctx, k)) for k in _CTX_F32}
    kw.update({k: float(np.asarray(getattr(ctx, k))) for k in _CTX_F64})
    return OpticsContext(det_nx=int(np.asarray(ctx.det_nx)),
                         det_ny=int(np.asarray(ctx.det_ny)), **kw)


def silicon_from_numpy(sil) -> SiliconParams:
    waves = getattr(sil, "tr_waves", None)
    env = getattr(sil, "tr_env", None)
    center = np.asarray(sil.treering_center, np.float32)
    abs_y = getattr(sil, "abs_y", None)
    tr_y = getattr(sil, "treering_y", None)
    return SiliconParams(
        thickness_um=float(np.asarray(sil.thickness_um)),
        pixel_um=float(np.asarray(sil.pixel_um)),
        diffusion_um=float(np.asarray(sil.diffusion_um)),
        bf_kernel=np.array(sil.bf_kernel, np.float32),
        treering_center=(float(center[0]), float(center[1])),
        tr_waves=None if waves is None else np.asarray(waves, np.float32),
        tr_env=None if env is None else np.asarray(env, np.float32),
        tr_active=bool(np.asarray(sil.tr_active)),
        abs_y=absorption_length_table().y if abs_y is None
        else np.array(abs_y, np.float32),
        treering_y=None if tr_y is None else np.array(tr_y, np.float32),
        treering_rmax=float(np.asarray(getattr(sil, "treering_rmax",
                                               8000.0))))


def polycdf_from_numpy(poly) -> PolyCDF:
    return PolyCDF(np.asarray(poly.c_core, np.float32),
                   np.asarray(poly.c_tail, np.float32),
                   float(np.asarray(poly.u_split)),
                   float(np.asarray(poly.s_lo)),
                   float(np.asarray(poly.s_hi)))


def sersic_from_numpy(tab) -> SersicPoly:
    """From the tuple profiles.sersic_poly2d() returns."""
    D_core, D_tail, n_lo, n_hi, u_split, s_lo, s_hi = tab
    return SersicPoly(np.asarray(D_core, np.float32),
                      np.asarray(D_tail, np.float32), float(n_lo),
                      float(n_hi), float(u_split), float(s_lo), float(s_hi))


def screens_from_numpy(screens, device) -> AtmScreens:
    """AtmScreens on `device` from an AtmScreens' gradient fields."""
    return AtmScreens(
        grad=torch.as_tensor(np.asarray(screens.grad, np.float32),
                             device=device),
        winds=np.asarray(screens.winds, np.float32),
        scale=float(screens.scale), size=float(screens.size),
        t0=float(screens.t0),
        weights=None if screens.weights is None
        else tuple(float(w) for w in screens.weights))


def readout_from_numpy(ro, device) -> CcdReadout:
    """CcdReadout on `device` from an object with the _READOUT
    attributes (vendor, 16 gains, read noises [ADU], bias levels [ADU],
    the 16 x 16 crosstalk and the full well [e-]); the chain's other
    parameters keep the JAX package's CcdReadout defaults."""
    return CcdReadout(str(np.asarray(ro.vendor)), np.asarray(ro.gains),
                      np.asarray(ro.read_noises),
                      np.asarray(ro.bias_levels), np.asarray(ro.xtalk),
                      float(np.asarray(ro.full_well)), device=device)


def screen_spec_from_numpy(screens, r0_500: float, L0: float,
                           kcrit: float) -> ScreenSpec:
    """ScreenSpec from an AtmScreens (weights, winds, size, scale, t0)
    and the synthesis constants of its AtmConfig: r0_500 already scaled
    by airmass, L0 and kcrit in 1/r0 units."""
    w = np.asarray(screens.weights, np.float64)
    return ScreenSpec(weights=tuple(float(v) for v in w),
                      winds=np.asarray(screens.winds, np.float32),
                      r0_layer=r0_500 * w ** (-3.0 / 5.0), L0=float(L0),
                      kcrit_rad=float(kcrit) / r0_500,
                      size=float(screens.size), scale=float(screens.scale),
                      t0=float(screens.t0))


# ---- the bench CCD state --------------------------------------------------

@dataclasses.dataclass
class CcdState:
    det_name: str
    nx: int
    ny: int
    tel: Telescope
    ctx: OpticsContext
    silicon: SiliconParams
    sk_table: PolyCDF
    screen_spec: ScreenSpec
    profiles: ProfileTables
    thx: np.ndarray        # (n_obj,) float32 field angles [rad]
    thy: np.ndarray
    modes: np.ndarray      # (n_obj,) int8 pooling modes at 2e5 e-/px
    seed: int              # synthetic-scene seed the angles belong to
    total_photons: float
    n_bright: int
    readout: CcdReadout
    sky_level: float       # photons / arcsec^2
    vig_coarse: np.ndarray  # (gh, gw) float32 vignetting at stride vig_step
    vig_step: int
    # the CCD's TAN-SIP WCS and the visit's WCS factory (a built state;
    # an exported state carries neither)
    wcs: object = None
    wcs_factory: object = None

    def field_angles(self, x, y):
        """Pixel (x, y) -> the camera-frame field angles [rad] through
        the CCD's own WCS (a built state only)."""
        if self.wcs is None:
            raise ValueError("an exported state carries no WCS; build the "
                             "state with build_ccd_state")
        return self.wcs_factory.icrf_to_field(*self.wcs.xy_to_radec(x, y))


def bench_columns(seed: int, n_obj: int, total_photons: float,
                  n_bright: int, nx: int, ny: int, field_angles):
    """bench.build_synthetic_host's numpy draws, in its order; field
    angles come from `field_angles(x_pix, y_pix) -> (thx, thy)`.
    Returns (columns dict of unpadded arrays, flux)."""
    rng = np.random.default_rng(seed)
    raw = 10 ** rng.uniform(0.0, 2.4, n_obj) ** 1.35
    flux = raw / raw.sum() * total_photons
    flux = rng.poisson(np.clip(flux, 0, None)).astype(np.float64)
    bright = 10 ** rng.uniform(6.0, 7.3, n_bright)
    flux[:n_bright] = bright
    t = rng.uniform(0, 1, n_obj)
    obj_type = np.where(t < 0.25, 0, np.where(t < 0.95, 1, 2)).astype(
        np.int32)
    obj_type[:n_bright] = 0
    x = rng.uniform(0, nx, n_obj)
    y = rng.uniform(0, ny, n_obj)
    thx, thy = field_angles(x, y)
    hlr = np.clip(rng.lognormal(np.log(0.35), 0.6, n_obj), 0.05, 3.0)
    srs_n = np.where(obj_type == 2, 30.0,
                     np.clip(rng.normal(1.5, 0.9, n_obj), 0.3, 6.2))
    q = rng.uniform(0.3, 1.0, n_obj)
    beta = rng.uniform(0, np.pi, n_obj)
    g1 = rng.normal(0, 0.02, n_obj)
    g2 = rng.normal(0, 0.02, n_obj)
    mu = 1.0 + rng.normal(0, 0.03, n_obj)
    cols = dict(x=thx, y=thy, obj_type=obj_type, p0=hlr, p1=srs_n, p2=q,
                p3=beta, g1=g1, g2=g2, mu=mu)
    return cols, flux, (x, y)


def synthetic_scene(state: CcdState, device, seed=None, n_obj=None,
                    total_photons=None, n_bright=None, field_angles=None,
                    pixel_coords: bool = False) -> SceneHost:
    """bench.build_synthetic_host's scene on `device`, with the objects'
    pixel positions.

    Defaults reproduce the exported bench scene with the state's field
    angles.  Another size needs `field_angles(x, y)` (pixel -> field
    angle).  pixel_coords=True puts the pixel positions in COL_X/COL_Y
    instead (the analytic path's scene; no field angles are needed).
    Every object keeps its drawn flux: render_ccd_pooled's classifier
    sends the bright ones to the FFT pass."""
    seed = state.seed if seed is None else seed
    n_obj = len(state.thx) if n_obj is None else n_obj
    total_photons = state.total_photons if total_photons is None \
        else total_photons
    n_bright = state.n_bright if n_bright is None else n_bright
    if pixel_coords:
        field_angles = lambda x, y: (x, y)  # noqa: E731
    elif field_angles is None:
        if (seed, n_obj, total_photons, n_bright) != (
                state.seed, len(state.thx), state.total_photons,
                state.n_bright):
            raise ValueError("the state's field angles belong to its own "
                             "scene; pass field_angles for another one")
        field_angles = lambda x, y: (state.thx, state.thy)  # noqa: E731
    cols, flux, pix = bench_columns(seed, n_obj, total_photons, n_bright,
                                    state.nx, state.ny, field_angles)
    return _bench_host(cols, flux, pix, device)


def _bench_host(cols, flux, pix, device) -> SceneHost:
    """The bench scene from bench_columns' output: columns padded to a
    power of two, the bench's 552-691 nm wavelength inverse CDF."""
    n_obj = len(flux)
    n_pad = int(2 ** np.ceil(np.log2(n_obj)))
    fills = dict(p1=1.0, p2=1.0, mu=1.0)
    padded = {}
    for k in ("x", "y", "obj_type", "p0", "p1", "p2", "p3", "g1", "g2", "mu"):
        col = np.full(n_pad, fills.get(k, 0.0), np.float32)
        col[:n_obj] = cols[k]
        padded[k] = col
    wl = np.linspace(552.0, 691.0, WL_CDF_K).astype(np.float32)
    scene = DeviceScene.from_columns(
        **padded, wl_icdf=np.broadcast_to(wl, (n_pad, WL_CDF_K)),
        device=device)
    return SceneHost(scene=scene, flux=flux, nominal_flux=flux.copy(),
                     n_objects=n_obj, pix_x=pix[0], pix_y=pix[1])


def load_ccd_state(path: str = BENCH_STATE, device="cuda") -> CcdState:
    """Read an exported CCD state (no JAX needed): the stored leaves of
    each container go through the same *_from_numpy converters."""
    with np.load(path) as z:
        a = {k: z[k] for k in z.files}
    ns = {}
    for key, v in a.items():
        if "." in key:
            p, k = key.split(".", 1)
            ns.setdefault(p, {})[k] = v
    ns = {p: SimpleNamespace(**kv) for p, kv in ns.items()}
    scr = ns["scr"]
    return CcdState(
        det_name=str(a["det_name"]), nx=int(a["nx"]), ny=int(a["ny"]),
        tel=telescope_from_numpy(ns["tel"]),
        ctx=optics_context_from_numpy(ns["ctx"]),
        silicon=silicon_from_numpy(ns["sil"]),
        sk_table=polycdf_from_numpy(ns["sk"]),
        screen_spec=screen_spec_from_numpy(scr, float(scr.r0_500),
                                           float(scr.L0), float(scr.kcrit)),
        profiles=ProfileTables(
            sersic=sersic_from_numpy(
                [getattr(ns["sersic"], k) for k in _SERSIC]),
            exp_disk=polycdf_from_numpy(ns["exp"])),
        thx=ns["scene"].thx, thy=ns["scene"].thy, modes=ns["scene"].modes,
        seed=int(ns["scene"].seed),
        total_photons=float(ns["scene"].total_photons),
        n_bright=int(ns["scene"].n_bright),
        readout=readout_from_numpy(ns["ro"], device),
        sky_level=float(ns["sky"].level), vig_coarse=ns["sky"].vig,
        vig_step=int(ns["sky"].vig_step))


# bench.py main()'s per-CCD choices (tests/test_torch_state.py _BENCH):
# 1e5 objects, 1e8 photons, 24 bright stars, the atmosphere's seed and
# seeing, the sky level and the sky stage's vignetting stride
BENCH_BUILD = dict(seed=0, n_obj=100_000, total_photons=1.0e8, n_bright=24,
                   atm_seed=42 + 271828, fwhm=0.7, sky_level=17_500.0,
                   vig_step=32)
# bench.py main()'s pointing: (30, -20) deg, mjd 60674.2, r band, rotator 0
BENCH_POINTING = dict(ra=float(np.radians(30.0)), dec=float(np.radians(-20.0)),
                      mjd=60674.2, band="r", rotTelPos=0.0)
# the second-kick table's wavelength and the classifier's FFT threshold
SK_WAVELENGTH_NM = 622.0
FFT_SB_THRESH = 2e5


def visit_factory(ra: float, dec: float, mjd: float, band: str = "r",
                  rotTelPos: float = 0.0, perturbations=(), **weather):
    """The visit's telescope (with its perturbations, at rotTelPos [rad])
    and its WCS factory at the boresight (ra, dec) [rad] and mjd (TAI);
    `weather`: make_wcs_factory's keywords (temperature_k, ...)."""
    return make_wcs_factory(ra, dec, mjd, band=band, telescope=load_telescope(
        band=band, perturbations=perturbations, rotTelPos=rotTelPos),
        **weather)


def ccd_optics(fac, ccd):
    """(TAN-SIP WCS, telescope surface matrix, optics context) of one
    CCD; the telescope carries the CCD's focal-height offset, so the
    photons and the fitted WCS share its surface."""
    wcs = fac.get_wcs(ccd)
    design = fac.telescope.for_detector(
        ccd.det_name, z_offset=getattr(ccd, "height_mm", 0.0) * 1e-3)
    return wcs, design.matrix(), make_optics_context(fac, ccd)


def runner_silicon(ccd, tree_rings: TreeRings,
                   strength: float = 1.0) -> SiliconParams:
    """config/runner.prepare_ccd's silicon: the CCD's tree rings and the
    vendor's measured BF kernel at 0.4 x the sensor strength."""
    sil = SiliconParams.make(treering_model=tree_rings.get(ccd.det_name),
                             bf_strength=0.4 * strength)
    return dataclasses.replace(sil, bf_kernel=vendor_bf_kernel(
        ccd.vendor, strength=0.4 * strength))


def second_kick(atm: AtmConfig, wavelength_nm: float) -> PolyCDF:
    """The second kick's gather-free Chebyshev sampler at a wavelength."""
    return PolyCDF.fit(second_kick_table(atm, wavelength_nm))[0]


def profile_tables() -> ProfileTables:
    """The intrinsic-profile samplers (Sersic and exponential disk)."""
    return ProfileTables(sersic=sersic_poly2d(), exp_disk=exp_disk_poly())


def build_ccd_state(det_name: str, ra: float, dec: float, mjd: float,
                    band: str = "r", rotTelPos: float = 0.0,
                    perturbations=(), camera: str = "LsstCamSim",
                    seed: int = BENCH_BUILD["seed"], device="cuda", *,
                    atm_seed: int = BENCH_BUILD["atm_seed"],
                    fwhm: float = BENCH_BUILD["fwhm"],
                    sky_level: float = BENCH_BUILD["sky_level"],
                    vig_step: int = BENCH_BUILD["vig_step"],
                    silicon: str = "bench",
                    timings: dict | None = None) -> CcdState:
    """One CCD's state from its pointing and detector, with no JAX.

    ra, dec: the boresight [rad]; mjd (TAI); band; rotTelPos [rad];
    perturbations: optics.loader.load_telescope's list.  The scene is the
    bench catalog's draws (from `seed`: 1e5 objects, 1e8 photons, 24
    bright stars) over the CCD's frame, its field angles through the
    CCD's own WCS.  The defaults are export_ccd_state's choices, so the
    bench arguments (R22_S11, (30, -20) deg, mjd 60674.2, r band) give
    the state `load_ccd_state()` reads.  silicon="bench" is
    SiliconParams.make with the default BF kernel; "runner" is
    config/runner.prepare_ccd's at its default sensor strength: the
    vendor's measured kernel.  The telescope carries the detector's
    focal-height offset, as the runner's.  `timings`, if given,
    receives each step's host seconds."""
    if silicon not in ("bench", "runner"):
        raise ValueError(f"silicon must be 'bench' or 'runner', not "
                         f"{silicon!r}")
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        if timings is not None:
            timings[name] = now - clock[0]
        clock[0] = now

    ccd = get_camera(camera)[det_name]
    nx, ny = ccd.bounds.width, ccd.bounds.height
    fac = visit_factory(ra, dec, mjd, band, rotTelPos, perturbations)
    wcs, tel, ctx = ccd_optics(fac, ccd)
    lap("wcs")

    def field_angles(x, y):
        return fac.icrf_to_field(*wcs.xy_to_radec(x, y))

    B = BENCH_BUILD
    cols, flux, pix = bench_columns(seed, B["n_obj"], B["total_photons"],
                                    B["n_bright"], nx, ny, field_angles)
    pcfg = PoolingConfig(xsize=nx, ysize=ny, fft_sb_thresh=FFT_SB_THRESH,
                         fwhm=fwhm, noise_var=sky_level * 0.04)
    # the classifier reads the scene's columns on the host
    modes = classify_objects(_bench_host(cols, flux, pix, "cpu"), pcfg,
                             make_psf_mtf(pcfg))
    lap("scene")

    if silicon == "runner":
        sil = runner_silicon(ccd, TreeRings())
    else:
        sil = SiliconParams.make(treering_model=TreeRings().get(det_name))
    atm = AtmConfig(fwhm=fwhm)
    sk = second_kick(atm, SK_WAVELENGTH_NM)
    lap("tables")
    state = CcdState(
        det_name=det_name, nx=nx, ny=ny, tel=tel, ctx=ctx,
        silicon=sil, sk_table=sk, screen_spec=screen_spec(atm_seed, atm),
        profiles=profile_tables(), thx=np.asarray(cols["x"], np.float32),
        thy=np.asarray(cols["y"], np.float32),
        modes=np.asarray(modes, np.int8), seed=seed,
        total_photons=float(B["total_photons"]), n_bright=B["n_bright"],
        readout=CcdReadout.from_ccd(ccd, device), sky_level=float(sky_level),
        vig_coarse=Vignetting().coarse_grid(ccd.center_mm, (ny, nx),
                                            vig_step),
        vig_step=vig_step, wcs=wcs, wcs_factory=fac)
    lap("readout")
    return state


def _leaves(obj, path=""):
    """(path, leaf) pairs of a state: dataclass fields and a readout's
    attributes, recursively."""
    if dataclasses.is_dataclass(obj):
        items = {f.name: getattr(obj, f.name)
                 for f in dataclasses.fields(obj)}
    elif isinstance(obj, CcdReadout):
        items = vars(obj)
    else:
        yield path, obj
        return
    for k, v in items.items():
        yield from _leaves(v, f"{path}.{k}" if path else k)


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.cpu().numpy()
    if isinstance(v, (tuple, list)):
        return np.asarray(v)
    return v


def state_mismatches(built: CcdState, ref: CcdState):
    """Gate (n)'s comparison, leaf by leaf: every leaf bit-equal (the
    surface matrix, the optics context, the silicon's arrays, the second
    kick and profile coefficients, the screen spec, the readout, the
    vignetting grid, the modes) except the field angles, which may differ
    by 1 float32 ulp (the torch float64 host trace rounds ~3e-16 m from
    numpy's, which moves the WCS by ~1e-16 rad; ROADMAP C).  The
    exported silicon carries no tabulated ring profile (the
    render reads the rings' waves), so a missing one is skipped, as are
    the built state's WCS and factory.
    Returns ({path: reason}, the field angles' largest ulp gap)."""
    skip = ("wcs", "wcs_factory")
    a = {k: v for k, v in _leaves(built) if k not in skip}
    b = {k: v for k, v in _leaves(ref) if k not in skip}
    bad = {}
    if a.keys() != b.keys():
        bad["fields"] = f"{sorted(a.keys() ^ b.keys())}"
    ulp = 0
    for k in sorted(a.keys() & b.keys()):
        x, y = _host(a[k]), _host(b[k])
        if x is None or y is None:
            if not (k == "silicon.treering_y" or x is y):
                bad[k] = f"{x!r} against {y!r}"
            continue
        if k in ("thx", "thy"):
            gap = np.abs(np.asarray(x, np.float32).view(np.int32).astype(
                np.int64) - np.asarray(y, np.float32).view(np.int32))
            ulp = max(ulp, int(gap.max()))
            if gap.max() > 1:
                bad[k] = f"{int(gap.max())} float32 ulps"
            continue
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            # bitwise: same dtype, shape and bytes (-0.0 is not 0.0)
            same = x.dtype == y.dtype and x.shape == y.shape and \
                np.ascontiguousarray(x).tobytes() == \
                np.ascontiguousarray(y).tobytes()
            if not same:
                bad[k] = (f"{x.dtype}{x.shape} against {y.dtype}{y.shape}" +
                          (f", max gap {np.abs(x - y).max():.3g}"
                           if x.shape == y.shape and x.dtype.kind == "f"
                           else ""))
        elif x != y:
            bad[k] = f"{x!r} against {y!r}"
    return bad, ulp
