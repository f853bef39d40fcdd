"""State carried across from the JAX package.

The card that runs the port has no JAX, so the per-CCD state the JAX
package builds (telescope, optics context, silicon, second-kick and
profile samplers, screen inputs, object field angles) crosses as numpy
data:

  * `*_from_numpy` read the JAX package's containers attribute by
    attribute (np.asarray on each leaf) and return the port's; they
    never import JAX, so they work equally on a namespace of numpy
    arrays loaded from disk;
  * `load_ccd_state` reads bench.py main()'s state for R22_S11 back
    from the committed .npz (`python tests/test_torch_state.py`, where
    JAX is installed, writes it; the port itself never imports the JAX
    package);
  * `synthetic_scene` reproduces bench.build_synthetic_host's numpy
    draws with the field angles from the state.

Beside the optics and sensor state, the bench CCD carries its readout
parameters (R22_S11's gains, read noises, bias levels, crosstalk,
vendor and full well), the bench sky level and the coarse vignetting
grid of its sky stage.  The full-resolution fringe map stays out: it is
host code's output at full size.
"""
from __future__ import annotations

import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import torch

from .electronics.readout import CcdReadout
from .image.scene import WL_CDF_K, DeviceScene, SceneHost, fit_wl_cheb
from .optics.telescope import Telescope, surf_matrix
from .photons.optics_ops import OpticsContext
from .photons.profiles import ProfileTables, SersicPoly
from .psf.atmosphere import AtmScreens, ScreenSpec
from .sensor.silicon import SiliconParams
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
    """DeviceScene from an object with `params` and `wl_cheb` arrays."""
    return DeviceScene(
        params=torch.tensor(np.asarray(scene.params, np.float32),
                            device=device),
        wl_cheb=torch.tensor(np.asarray(scene.wl_cheb, np.float32),
                             device=device))


def host_from_numpy(host, device) -> SceneHost:
    """SceneHost from the JAX package's SceneHost (or a look-alike)."""
    return SceneHost(scene=scene_from_numpy(host.scene, device),
                     flux=np.asarray(host.flux, np.float64),
                     nominal_flux=np.asarray(host.nominal_flux, np.float64),
                     n_objects=int(host.n_objects))


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
    return SiliconParams(
        thickness_um=float(np.asarray(sil.thickness_um)),
        pixel_um=float(np.asarray(sil.pixel_um)),
        diffusion_um=float(np.asarray(sil.diffusion_um)),
        bf_kernel=np.array(sil.bf_kernel, np.float32),
        treering_center=(float(center[0]), float(center[1])),
        tr_waves=None if waves is None else np.asarray(waves, np.float32),
        tr_env=None if env is None else np.asarray(env, np.float32),
        tr_active=bool(np.asarray(sil.tr_active)))


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
                    total_photons=None, n_bright=None,
                    field_angles=None) -> SceneHost:
    """bench.build_synthetic_host's scene on `device`, with the objects'
    pixel positions.

    Defaults reproduce the exported bench scene with the state's field
    angles.  Another size needs `field_angles(x, y)` (pixel -> field
    angle).  Every object keeps its drawn flux: render_ccd_pooled's
    classifier sends the bright ones to the FFT pass."""
    seed = state.seed if seed is None else seed
    n_obj = len(state.thx) if n_obj is None else n_obj
    total_photons = state.total_photons if total_photons is None \
        else total_photons
    n_bright = state.n_bright if n_bright is None else n_bright
    if field_angles is None:
        if (seed, n_obj, total_photons, n_bright) != (
                state.seed, len(state.thx), state.total_photons,
                state.n_bright):
            raise ValueError("the state's field angles belong to its own "
                             "scene; pass field_angles for another one")
        field_angles = lambda x, y: (state.thx, state.thy)  # noqa: E731
    cols, flux, (px, py) = bench_columns(seed, n_obj, total_photons,
                                         n_bright, state.nx, state.ny,
                                         field_angles)
    n_pad = int(2 ** np.ceil(np.log2(n_obj)))
    fills = dict(p1=1.0, p2=1.0, mu=1.0)
    params = np.zeros((n_pad, 10), np.float32)
    for i, k in enumerate(("x", "y", "obj_type", "p0", "p1", "p2", "p3",
                           "g1", "g2", "mu")):
        col = np.full(n_pad, fills.get(k, 0.0), np.float32)
        col[:n_obj] = cols[k]
        params[:, i] = col
    wl = np.linspace(552.0, 691.0, WL_CDF_K).astype(np.float32)
    wl_cheb = fit_wl_cheb(np.broadcast_to(wl, (n_pad, WL_CDF_K)).astype(
        np.float64))
    scene = DeviceScene(params=torch.as_tensor(params, device=device),
                        wl_cheb=torch.as_tensor(wl_cheb, device=device))
    return SceneHost(scene=scene, flux=flux, nominal_flux=flux.copy(),
                     n_objects=n_obj, pix_x=px, pix_y=py)


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
