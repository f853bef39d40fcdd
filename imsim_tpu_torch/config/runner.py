"""Visit runner: a YAML config to rendered CCDs on disk
(imsim_tpu/config/runner.py counterpart).

  load_config -> build_visit_context: each input.<name> section through
  config.registry.INPUT_TYPES (opsim metadata, telescope with its FEA /
  AOS terms, atmosphere with doOpt, sky model, tree rings, vignetting),
  the WCS factory, bandpass and camera
  -> per CCD (output.det_num / only_dets, split over -n/-j jobs):
     prepare_ccd (host: WCS and optics, catalog cull, SEDs and scene with
     field angles, silicon, pooling configuration, sky level, second
     kick, spikes) -> render_one_ccd on the caller's device (the pooled
     render with K1, K2, K3 and the FFT pass, checkpointed per batch;
     sky with gradient, vignetting and fringing; cosmic rays; the readout
     to raw amps) -> write_outputs (eimage FITS, RICE raw amp FITS, the
     truth catalog, the opd / sag / user-registered extra outputs).

`run_visit_iter` prefetches the next CCD's host preparation in a worker
thread while the main thread renders (its scene is uploaded by the main
thread), and with `output.io_workers` hands the file writes (RICE encode
and disk, which release the GIL) to a thread pool.  `output.mesh` renders
the CCDs over the ranks of a device mesh (parallel.visit).  Every device
step runs on the caller's device, "cuda" unless the caller says
otherwise.  The host steps are the JAX package's numpy in its order, so
a CCD's preparation equals the JAX runner's bit for bit
(tests/test_torch_instcat_ccd.py, chip_smoke gates (o) and (r)).
"""
from __future__ import annotations

import dataclasses
import functools
import os
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import convert
from ..catalog import opsim as opsim_mod
from ..catalog.bandpass import rubin_bandpass, rubin_bandpass_from_files
from ..catalog.instcat import read_instcat
from ..catalog.skycat import SkyCatalogInterface
from ..electronics.camera import PIXEL_SIZE_MM, get_camera
from ..electronics.readout import CcdReadout
from ..image import scene as scene_mod
from ..image.ccd_render import add_sky_and_noise
from ..image.cosmic_rays import CosmicRayCatalog, paint_cosmic_rays
from ..image.diffraction_fft import spike_kernel
from ..image.photon_pooling import PoolingConfig, render_ccd_pooled
from ..image.sky import CCD_Fringing, SkyGradient, SkyModel, \
    sensor_fringing_seed
from ..image.sky_sed import fringing_amplitude, load_sky_sed
from ..image.vignetting import Vignetting
from ..io.checkpoint import Checkpointer
from ..io.fits import HDU, read_fits, write_fits
from ..meta_data import data_dir
from ..meta_data import resolve_data_path as _data
from ..optics.astrometry import RUBIN_LAT
from ..optics.wcs_factory import make_wcs_factory
from ..photons.diffraction import field_rotation_sincos
from ..psf.atmosphere import AtmConfig, AtmScreens, load_screens, \
    make_screens, save_screens
from ..sensor.sensor_model import _kernel_cached, resolve_sensor_model
from ..sensor.silicon import SiliconParams
from ..sensor.treerings import TreeRings
from ..utils import trace
from ..utils.grid import coarse_shape
from ..utils.rng import ATM_SEED_OFFSET, stream
from .interpreter import ConfigView, deep_resolve, load_config
from .registry import EXTRA_OUTPUT_TYPES, INPUT_TYPES, register_extra_output

DEG = np.pi / 180.0


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _Clock:
    """Seconds per named step into `seconds`.  With `span`, each step is
    also the span `<span>.<step>` of the CCD `ccd` (utils.trace.Steps).
    With a device, a step's end synchronises it while tracing is on, so
    the step's seconds hold its device work; off, they are the host's
    seconds of launching it.  Only the render thread passes a device."""

    def __init__(self, seconds: dict, device=None, *, span=None, ccd=None):
        self.seconds, self.device = seconds, device
        self.steps = None if span is None else trace.Steps(
            span, ccd=ccd, device=device)
        self.t = time.perf_counter()

    def __call__(self, name):
        if self.device is not None and trace.on():
            _sync(self.device)
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self.t
        self.t = now
        if self.steps is not None:
            self.steps.mark(name)


# Host wall-clock accumulators [s] of the per-CCD steps that the prefetch
# thread and the IO pool move off the render thread: prep_s (prepare_ccd),
# readout_s (the device readout and the pull of the eimage and amps to
# the host) and io_s (file writes only).  Reset and read them around a
# visit to see how much host work the overlap hides.
HOST_TIMERS = {"prep_s": 0.0, "readout_s": 0.0, "io_s": 0.0}
_TIMER_LOCK = threading.Lock()


def reset_host_timers():
    with _TIMER_LOCK:
        for k in HOST_TIMERS:
            HOST_TIMERS[k] = 0.0


def _timed(key, span, ccd=None):
    """Add the function's host seconds to HOST_TIMERS[key], and record
    it as the span `span`; ccd(*args, **kwargs) names its CCD (else the
    enclosing span's)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            det = ccd(*args, **kwargs) if ccd is not None and trace.on() \
                else None
            t0 = time.perf_counter()
            try:
                with trace.span(span, ccd=det):
                    return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                with _TIMER_LOCK:
                    HOST_TIMERS[key] += dt
        return wrapper
    return deco


def _ccd_of_det(ctx, det, *args, **kwargs):
    return _det(ctx, det)[0]


def _ccd_of_result(ctx, result, *args, **kwargs):
    return result["det_name"]


@dataclasses.dataclass
class VisitContext:
    """Everything the visit's CCDs share."""

    cfg: dict
    view: ConfigView
    opsim: opsim_mod.OpsimData
    camera: object
    telescope: object           # optics.loader.LoadedTelescope
    wcs_factory: object
    bandpass: object
    sky_model: SkyModel
    tree_rings: TreeRings
    vignetting: Vignetting
    atm_cfg: AtmConfig | None
    screen_spec: object | None
    boresight: tuple
    seed: int
    seconds: dict
    _screens: dict = dataclasses.field(default_factory=dict)

    def screens(self, device) -> AtmScreens:
        """The atmosphere's screens on `device`, once per device: loaded
        from input.atm_psf.save_file where that file exists, else made
        from the visit's seed + 271828 (and saved there when it is set;
        numpy adds '.npz' to a name without it, which is then never
        found, as in the JAX package)."""
        key = str(torch.device(device))
        if key not in self._screens:
            spec = self.screen_spec
            if spec.save_file and os.path.isfile(spec.save_file):
                scr = load_screens(spec.save_file, t0=spec.t0, device=device)
            else:
                scr = make_screens(spec, device, gen=stream(
                    self.seed + ATM_SEED_OFFSET, "screens", device=device))
                if spec.save_file:
                    save_screens(spec.save_file, scr)
            self._screens[key] = scr
        return self._screens[key]


def build_visit_context(cfg: dict, logger=None) -> VisitContext:
    """The visit-scoped inputs from a config tree (load_config's): every
    input.<name> section goes through INPUT_TYPES, so replacing a
    registry entry swaps that input's implementation.  `seconds` holds
    the host seconds of the header and of the rest."""
    seconds = {}
    clock = _Clock(seconds)
    view = ConfigView(cfg)
    ods = INPUT_TYPES["opsim_data"](
        cfg.get("input", {}).get("opsim_data"), view)
    view.state["opsim_data"] = ods
    band = ods.get("band", "r")
    seed = int(ods.get("seed", 42))
    clock("header")
    # with the visit's metadata known, $-expressions and @-references
    # anywhere in the tree collapse to values
    cfg = deep_resolve(view, cfg)
    view.cfg = cfg

    # the telescope, then the atmosphere (doOpt changes the telescope, so
    # it runs before the WCS factory traces it)
    in_cfg = cfg.get("input", {}) or {}
    telescope = INPUT_TYPES["telescope"](in_cfg.get("telescope"), view)
    view.state["telescope"] = telescope
    atm_cfg, spec = INPUT_TYPES["atm_psf"](in_cfg.get("atm_psf"), view)

    ra = float(ods.get("fieldRA", 0.0)) * DEG
    dec = float(ods.get("fieldDec", 0.0)) * DEG
    view.state["boresight"] = (ra, dec)
    wcfg = cfg.get("image", {}).get("wcs", {}) or {}
    weather = {}
    if wcfg.get("pressure") is not None:
        weather["pressure_kpa"] = float(wcfg["pressure"])
    if wcfg.get("temperature") is not None:
        weather["temperature_k"] = float(wcfg["temperature"])
    if wcfg.get("H2O_pressure") is not None:
        weather["h2o_pressure_kpa"] = float(wcfg["H2O_pressure"])
    if wcfg.get("order") is not None:
        weather["order"] = int(wcfg["order"])
    if wcfg.get("dut1") is not None:
        weather["dut1"] = float(wcfg["dut1"])
    if wcfg.get("eop_file"):
        weather["eop"] = _data(wcfg["eop_file"])
    fac = make_wcs_factory(ra, dec, float(ods.get("mjd_mid", 60674.0)),
                           band=band, telescope=telescope, **weather)

    # bandpass, sky, sensors, vignetting
    bp_cfg = cfg.get("image", {}).get("bandpass", {}) or {}
    tp_dir = _data(bp_cfg.get("throughputs_dir"))
    airmass = float(ods.get("airmass", 1.0))
    if tp_dir:
        bandpass = rubin_bandpass_from_files(band, tp_dir, airmass=airmass)
    else:
        bandpass = rubin_bandpass(band, airmass=airmass)
    sky_sed = None
    sed_file = (cfg.get("image", {}) or {}).get("sky_sed_file")
    if sed_file:
        sky_sed = load_sky_sed(_data(sed_file))
    view.state["bandpass"] = bandpass
    view.state["sky_sed"] = sky_sed
    sky_model = INPUT_TYPES["sky_model"](in_cfg.get("sky_model"), view)
    view.state["sky_model"] = sky_model
    tree_rings = INPUT_TYPES["tree_rings"](in_cfg.get("tree_rings"), view)
    view.state["tree_rings"] = tree_rings
    vignetting = INPUT_TYPES["vignetting"](in_cfg.get("vignetting"), view)

    cam_name = cfg.get("output", {}).get("camera", "LsstCamSim")
    r_cfg0 = cfg.get("output", {}).get("readout", {}) or {}
    camera = get_camera(
        cam_name, bias_levels_file=_data(r_cfg0.get("bias_levels_file")),
        overrides_file=_data(r_cfg0.get("camera_overrides_file")))
    ctx = VisitContext(cfg=cfg, view=view, opsim=ods, camera=camera,
                       telescope=telescope, wcs_factory=fac,
                       bandpass=bandpass, sky_model=sky_model,
                       tree_rings=tree_rings, vignetting=vignetting,
                       atm_cfg=atm_cfg, screen_spec=spec,
                       boresight=(ra, dec), seed=seed, seconds=seconds)
    clock("visit")
    return ctx


def parse_photon_ops(ops_list):
    """stamp.photon_ops -> (apply_dcr, apply_diffraction,
    field_rotation): PhotonDCR present, RubinDiffraction[Optics] present,
    and no op with disable_field_rotation.  No list: the full chain."""
    if ops_list is None:
        return True, True, True
    op_types = {str(o.get("type")) for o in ops_list if isinstance(o, dict)}
    apply_dcr = "PhotonDCR" in op_types
    apply_diff = bool({"RubinDiffractionOptics",
                       "RubinDiffraction"} & op_types)
    field_rot = not any(isinstance(o, dict)
                        and o.get("disable_field_rotation")
                        for o in ops_list)
    return apply_dcr, apply_diff, field_rot


def _det_list(ctx: VisitContext):
    """The visit's detector numbers: output.only_dets (names), else
    output.det_num (a number, a list or a List / Sequence value), else
    the first output.nfiles; then job `job` of `njobs` takes every
    njobs-th."""
    out_cfg = ctx.cfg.get("output", {})
    only = out_cfg.get("only_dets")
    if only:
        dets = [ctx.camera.det_num(d) for d in only]
    else:
        dets = out_cfg.get("det_num")
        if isinstance(dets, dict):
            dets = ctx.view.resolve(dets)
        if dets is None:
            dets = list(range(int(out_cfg.get("nfiles",
                                              len(ctx.camera.det_names)))))
        if isinstance(dets, (int, np.integer)):
            dets = [dets]
        dets = [int(d) for d in dets]
    njobs = int(out_cfg.get("njobs", 1))
    job = int(out_cfg.get("job", 1))
    if njobs > 1:
        dets = dets[job - 1::njobs]
    return dets


def _format_name(template, ctx, det_name, det_num):
    """A file-name template: {visit}/{band}/{det_name}/{det_num}
    placeholders, or a {type: FormattedStr, ...} node resolved with the
    current detector in scope."""
    if isinstance(template, dict):
        saved = {k: ctx.view.state.get(k) for k in ("det_name", "det_num")}
        ctx.view.state["det_name"] = det_name
        ctx.view.state["det_num"] = det_num
        try:
            template = ctx.view.resolve(template)
        finally:
            ctx.view.state.update(saved)
    return str(template).format(
        visit=int(ctx.opsim.get("observationId", 0)),
        band=ctx.opsim.get("band", "r"), det_name=det_name,
        det_num=det_num)


class WindowWCS:
    """A CCD's WCS seen through its central (h, w) window: pixel
    coordinates shifted by the window's corner (x0, y0)."""

    def __init__(self, wcs, x0: int, y0: int):
        self.wcs, self.x0, self.y0 = wcs, x0, y0

    def radec_to_xy(self, ra, dec):
        x, y = self.wcs.radec_to_xy(ra, dec)
        return np.asarray(x, float) - self.x0, np.asarray(y, float) - self.y0

    def xy_to_radec(self, x, y):
        return self.wcs.xy_to_radec(np.asarray(x, float) + self.x0,
                                    np.asarray(y, float) + self.y0)


@dataclasses.dataclass
class CcdPrep:
    """One CCD's host preparation: what the device render, the sky stage
    and the readout need.  `device`: where its scene and readout live
    (None until upload_prep)."""

    det_name: str
    det_num: int
    ccd: object
    wcs: object
    octx: object
    tel32: object
    bandpass: object
    use_optics: bool
    host: object | None
    table: object | None
    silicon: object | None
    pcfg: PoolingConfig
    sky_level: float
    ra_c: float
    dec_c: float
    sk_table: object | None
    spikes: dict | None
    fft_vign: object | None
    ckpt: Checkpointer | None
    exptime: float
    profiles: object
    readout: CcdReadout | None
    window: tuple | None
    seconds: dict
    device: object = None


def _field_rotation_deg(ts, altitude, azimuth):
    """The field rotation angle [deg] at the times ts [s]."""
    s, c = field_rotation_sincos(torch.as_tensor(ts, dtype=torch.float64),
                                 RUBIN_LAT, altitude, azimuth)
    return np.degrees(torch.atan2(s, c).numpy())


def _det(ctx, det):
    """(det_name, det_num) from either."""
    if isinstance(det, str):
        return det, ctx.camera.det_num(det)
    return ctx.camera.det_name(int(det)), int(det)


def _readout_for(ctx, ccd, device) -> CcdReadout | None:
    """output.readout's chain for a CCD on `device`, or None when the
    readout is off."""
    r_cfg = ctx.cfg.get("output", {}).get("readout", {}) or {}
    if not r_cfg.get("enabled", True):
        return None
    opt = {k: float(r_cfg[k]) for k in ("full_well", "read_noise",
                                        "bias_level")
           if r_cfg.get(k) is not None}
    return CcdReadout.from_ccd(
        ccd, device, readout_time=float(r_cfg.get("readout_time", 2.0)),
        dark_current=float(r_cfg.get("dark_current", 0.02)),
        scti=float(r_cfg.get("scti", 1e-6)),
        pcti=float(r_cfg.get("pcti", 1e-6)), **opt)


def _sky_catalog_table(sky_cfg, wcs, nx, ny, seconds, clock):
    """input.sky_catalog: the CCD's objects from skyCatalogs files (a
    flat parquet / CSV catalog or the native yaml) culled to its box
    widened by edge_pix, less those without an SED file under
    skip_missing_sed; the SED directories (sed_dir, else
    $SIMS_SED_LIBRARY_DIR, plus the native catalog's sed_file_root
    ones); build_scene's pad_to (approx_nobjects rounded up to a power
    of two, when it holds every object) and max_flux.  The native
    catalog's inline tophat SEDs are timed apart from the cull."""
    skycat = SkyCatalogInterface(
        _data(sky_cfg["file_name"]), columns=sky_cfg.get("columns"),
        obj_types=tuple(sky_cfg["obj_types"])
        if sky_cfg.get("obj_types") else None,
        apply_dc2_dilation=bool(sky_cfg.get("apply_dc2_dilation", False)),
        skycatalog_root=sky_cfg.get("skycatalog_root"))
    table = skycat.to_object_table(
        wcs=wcs, xsize=nx, ysize=ny,
        edge_pix=float(sky_cfg.get("edge_pix", 100)))
    sed_dirs = sky_cfg.get("sed_dir") or \
        os.environ.get("SIMS_SED_LIBRARY_DIR", ".")
    if isinstance(sed_dirs, str):
        sed_dirs = [sed_dirs]
    if skycat.native is not None:
        sed_dirs = list(sed_dirs) + skycat.native.sed_dirs_hint()
    if sky_cfg.get("skip_missing_sed"):
        table = scene_mod.filter_missing_seds(table, sed_dirs)
    clock("cull")
    if skycat.native is not None:
        t_sed = skycat.native.seconds["tophat seds"]
        seconds["cull"] -= t_sed
        seconds["tophat seds"] = seconds.get("tophat seds", 0.0) + t_sed
    approx = sky_cfg.get("approx_nobjects")
    pad_to = None
    if approx and int(approx) >= len(table):
        pad_to = max(int(2 ** np.ceil(np.log2(max(int(approx), 1)))), 16)
    return table, sed_dirs, dict(pad_to=pad_to,
                                 max_flux=sky_cfg.get("max_flux"))


def _silicon(ctx, ccd, det_name):
    """image.sensor: the Silicon sensor with the CCD's tree rings and,
    unless isotropic_kernel, the vendor's measured BF kernel at 0.4 x
    strength; None for any other sensor type."""
    img_cfg = ctx.cfg.get("image", {})
    sensor_cfg = img_cfg.get("sensor", {}) or {}
    if sensor_cfg.get("type", "Silicon") != "Silicon":
        return None
    strength = float(sensor_cfg.get("strength", 1.0))
    model_name = sensor_cfg.get("sensor_model")
    if model_name:
        # a Poisson solver's vertex file (a path or a model name; the
        # '{vendor}' placeholder picks the CCD's): its own kernel at
        # `strength`, looked up in sensor_model_dir, then the data dir's
        # sensor_models/ and the data dir itself
        dirs = [sensor_cfg.get("sensor_model_dir", ".")]
        if data_dir():
            dirs += [os.path.join(data_dir(), "sensor_models"), data_dir()]
        path = resolve_sensor_model(
            str(model_name).format(vendor=ccd.vendor.lower()), dirs)
        return dataclasses.replace(SiliconParams.make(
            treering_model=ctx.tree_rings.get(det_name),
            bf_strength=0.4 * strength), bf_kernel=_kernel_cached(
                path, 4, strength))
    if sensor_cfg.get("isotropic_kernel", False):
        return SiliconParams.make(treering_model=ctx.tree_rings.get(
            det_name), bf_strength=0.4 * strength)
    return convert.runner_silicon(ccd, ctx.tree_rings, strength)


@_timed("prep_s", "prep", _ccd_of_det)
def prepare_ccd(ctx: VisitContext, det, *, window=None, device="cuda",
                upload: bool = True) -> CcdPrep:
    """The host preparation of one CCD (`det`: its name or number): WCS
    and optics, the instance catalog's cull and scene with field angles,
    the silicon, the pooling configuration, the sky level at the CCD
    centre, the second kick, the spike kernel (calibrated on `device`),
    the FFT stamps' vignetting and the checkpointer.  upload=False keeps
    the scene on the host and builds no readout: upload_prep does both
    (the visit's prefetch thread prepares, the render thread uploads).
    window=(h, w): the CCD's central h x w pixels as a frame of their
    own (rehearsals and tests).  A PSF other than AtmosphericPSF renders
    through the analytic path."""
    cfg = ctx.cfg
    seconds = {}
    det_name, det_num = _det(ctx, det)
    clock = _Clock(seconds, span="prep", ccd=det_name)
    ccd = ctx.camera[det_name]
    nx, ny = ccd.bounds.width, ccd.bounds.height
    exptime = float(ctx.opsim.get("exptime", 30.0))
    img_cfg = cfg.get("image", {})
    stamp_cfg = cfg.get("stamp", {}) or {}
    wcs, tel32, octx = convert.ccd_optics(ctx.wcs_factory, ccd)
    if window is not None:
        h, w = (int(v) for v in window)
        if (nx - w) % 2 or (ny - h) % 2:
            raise ValueError(f"window {window} is not centred on the "
                             f"{ny} x {nx} frame")
        wcs = WindowWCS(wcs, (nx - w) // 2, (ny - h) // 2)
        octx = dataclasses.replace(octx, det_nx=w, det_ny=h)
        nx, ny = w, h
    # the per-detector QE bandpass from measured throughput files
    bandpass = ctx.bandpass
    bp_cfg = img_cfg.get("bandpass", {}) or {}
    if bp_cfg.get("det_qe") and bp_cfg.get("throughputs_dir"):
        bandpass = rubin_bandpass_from_files(
            ctx.opsim.get("band", "r"), _data(bp_cfg["throughputs_dir"]),
            airmass=float(ctx.opsim.get("airmass", 1.0)),
            camera=ctx.camera.camera_name, det_name=det_name)
    psf_cfg = cfg.get("psf", {}) or {}
    use_optics = psf_cfg.get("type", "AtmosphericPSF") == "AtmosphericPSF"
    clock("wcs")

    # ---- catalog -> scene ----------------------------------------------
    cat_cfg = cfg.get("input", {}).get("instance_catalog", {}) or {}
    sky_cfg = cfg.get("input", {}).get("sky_catalog", {}) or {}
    host = table = None
    scene_kw = {}
    if sky_cfg.get("file_name"):
        table, sed_dirs, scene_kw = _sky_catalog_table(sky_cfg, wcs, nx, ny,
                                                       seconds, clock)
    elif cat_cfg.get("file_name"):
        table = read_instcat(
            _data(cat_cfg["file_name"]), wcs=wcs, xsize=nx, ysize=ny,
            edge_pix=float(cat_cfg.get("edge_pix", 100)),
            sort_mag=bool(cat_cfg.get("sort_mag", True)),
            flip_g2=bool(cat_cfg.get("flip_g2", True)),
            min_source=cat_cfg.get("min_source"),
            skip_invalid=bool(cat_cfg.get("skip_invalid", True)))
        # image.nobjects caps the (magnitude-sorted) objects
        n_cap = img_cfg.get("nobjects")
        if n_cap is not None and len(table) > int(n_cap):
            table = table.select(np.arange(len(table)) < int(n_cap))
        clock("cull")
        sed_dirs = cat_cfg.get("sed_dir") or \
            os.environ.get("SIMS_SED_LIBRARY_DIR", ".")
        if isinstance(sed_dirs, str):
            sed_dirs = [sed_dirs]
    if table is not None:
        host = scene_mod.build_scene(
            table, bandpass, sed_dirs, exptime=exptime,
            rng=np.random.default_rng(ctx.seed + det_num),
            device=device if upload else "cpu", **scene_kw)
        if use_optics:
            # the optics chain takes field angles in COL_X / COL_Y; pix_x
            # and pix_y keep the pixels
            thx, thy = ctx.wcs_factory.icrf_to_field(table.ra, table.dec)
            n = len(table)
            params = host.scene.params
            params[:n, 0] = torch.as_tensor(np.asarray(thx, np.float32),
                                            device=params.device)
            params[:n, 1] = torch.as_tensor(np.asarray(thy, np.float32),
                                            device=params.device)
        clock("scene")
    elif "scene_host" in ctx.view.state:
        host = ctx.view.state["scene_host"]

    silicon = _silicon(ctx, ccd, det_name)

    # ---- pooling configuration -------------------------------------------
    ckpt = None
    ck_cfg = cfg.get("input", {}).get("checkpoint", {}) or {}
    if ck_cfg.get("dir"):
        # visit, band and detector in the name, so visits sharing a
        # directory never resume each other's files
        fname = (ck_cfg.get("file_name")
                 or "checkpoint_{visit:08d}-{band}-{det_name}.npz")
        ckpt = Checkpointer(_format_name(fname, ctx, det_name, det_num),
                            dir=ck_cfg["dir"])
    apply_dcr, apply_diff, field_rot = parse_photon_ops(
        stamp_cfg.get("photon_ops"))
    method = str(stamp_cfg.get("method", "auto"))
    pcfg = PoolingConfig(
        xsize=nx, ysize=ny, exptime=exptime,
        apply_dcr=apply_dcr, apply_diffraction=apply_diff,
        diffraction_field_rotation=field_rot,
        nbatch=int(img_cfg.get("nbatch", 8)),
        # stamp.maxN is the reference's photon-batch cap
        batch_size=int(stamp_cfg.get(
            "maxN", img_cfg.get("batch_size", 8_000_000))),
        nsub=int(img_cfg.get("nsubbatch", 4)),
        faint_thresh=float(stamp_cfg.get(
            "max_flux_simple", stamp_cfg.get("faint_thresh", 100.0))),
        fft_sb_thresh=float(stamp_cfg.get("fft_sb_thresh", 0.0))
        if method == "auto" else 0.0,
        force_fft=method == "fft",
        pixel_scale=float(img_cfg.get("pixel_scale", 0.2)),
        fwhm=float(ctx.opsim.get("FWHMeff", 0.8)),
        nbatch_per_checkpoint=int(img_cfg.get("nbatch_per_checkpoint", 1)),
        chromatic_exponent=float(
            (cfg.get("input", {}).get("atm_psf", {}) or {})
            .get("exponent", -0.3)) if ctx.atm_cfg is not None else 0.0,
        wl_ref=float(bandpass.effective_wavelength))
    # the per-pixel sky level: a number, or the sky model at the CCD
    # centre (the {type: SkyLevel} node)
    sky_val = img_cfg.get("sky_level")
    ra_c, dec_c = wcs.xy_to_radec((nx - 1) / 2.0, (ny - 1) / 2.0)
    if isinstance(sky_val, (int, float)):
        sky_level = float(sky_val)
    elif sky_val is not None:
        sky_level = ctx.sky_model.get_sky_level(float(ra_c), float(dec_c))
    else:
        sky_level = 0.0
    pcfg.noise_var = float(sky_level)

    sk_table = None
    if ctx.atm_cfg is not None:
        sk_table = convert.second_kick(ctx.atm_cfg,
                                       bandpass.effective_wavelength)
    if psf_cfg.get("type", "AtmosphericPSF") == "DoubleGaussianPSF":
        pcfg = dataclasses.replace(pcfg, psf_table=_double_gaussian_table(
            psf_cfg, ctx.opsim))

    # ---- spikes of the FFT stars ------------------------------------------
    spikes = None
    dfft_cfg = stamp_cfg.get("diffraction_fft", {}) or {}
    if pcfg.fft_sb_thresh > 0 and dfft_cfg.get("enabled", True):
        alt = min(float(ctx.opsim.get("altitude", 90.0)), 89.9) * DEG
        az = float(ctx.opsim.get("azimuth", 0.0)) * DEG
        ts = np.linspace(0.0, max(exptime, 1e-3), 24)
        thetas = _field_rotation_deg(ts, alt, az)
        kw_n = {}
        if dfft_cfg.get("spike_length_cutoff"):
            half = int(min(float(dfft_cfg["spike_length_cutoff"]), 2048))
            kw_n["n"] = 2 * max(half, 16) + 1
        kern = spike_kernel(
            wavelength_nm=float(bandpass.effective_wavelength),
            pixel_scale=pcfg.pixel_scale,
            alpha_deg=45.0 - float(ctx.opsim.get("rotTelPos", 0.0)),
            rot_thetas_deg=tuple(np.round(thetas, 3)), device=device, **kw_n)
        spikes = dict(kernel=kern, sat=float(dfft_cfg.get(
            "brightness_threshold", ccd.full_well)))

    # the FFT stamps' vignetting at the objects
    fft_vign = None
    if host is not None and pcfg.fft_sb_thresh > 0 and \
            host.pix_x is not None:
        yy_mm = (np.asarray(host.pix_y) - (ny - 1) / 2) * PIXEL_SIZE_MM \
            + ccd.center_mm[1]
        xx_mm = (np.asarray(host.pix_x) - (nx - 1) / 2) * PIXEL_SIZE_MM \
            + ccd.center_mm[0]
        fft_vign = ctx.vignetting(np.hypot(xx_mm, yy_mm))
    clock("state")
    prep = CcdPrep(det_name=det_name, det_num=det_num, ccd=ccd, wcs=wcs,
                   octx=octx, tel32=tel32, bandpass=bandpass,
                   use_optics=use_optics, host=host, table=table,
                   silicon=silicon, pcfg=pcfg, sky_level=sky_level,
                   ra_c=float(ra_c), dec_c=float(dec_c), sk_table=sk_table,
                   spikes=spikes, fft_vign=fft_vign, ckpt=ckpt,
                   exptime=exptime, profiles=convert.profile_tables(),
                   readout=None,
                   window=None if window is None else (ny, nx),
                   seconds=seconds)
    return upload_prep(ctx, prep, device) if upload else prep


def upload_prep(ctx: VisitContext, prep: CcdPrep, device) -> CcdPrep:
    """The prep with its scene on `device` and its readout chain built
    there (the render thread's half of prepare_ccd)."""
    device = torch.device(device)
    host = prep.host
    if host is not None and host.scene.params.device != device:
        scene = host.scene
        moved = {f.name: getattr(scene, f.name).to(device)
                 for f in dataclasses.fields(scene)
                 if isinstance(getattr(scene, f.name), torch.Tensor)}
        host = dataclasses.replace(
            host, scene=dataclasses.replace(scene, **moved))
    return dataclasses.replace(prep, host=host, device=device,
                               readout=_readout_for(ctx, prep.ccd, device))


def _double_gaussian_table(psf_cfg: dict, opsim):
    """DoubleGaussianPSF's radial table: the reference's psf.fwhm shape
    (LSE-40 eq. 30), else fwhm1 / fwhm2 / wgt1 (fwhm1 the opsim
    FWHMgeom)."""
    from ..photons.profiles import radial_cdf_from_mtf

    if psf_cfg.get("fwhm") is not None:
        alpha = float(psf_cfg["fwhm"]) / 2.3835
        pix = float(psf_cfg.get("pixel_scale", 0.2))
        s1 = np.sqrt(max(alpha ** 2 - pix ** 2 / 12.0, 1e-8))
        s2 = np.sqrt(max(4 * alpha ** 2 - pix ** 2 / 12.0, 1e-8))
        w1 = 1.0 / 1.1
        f1, f2 = 2.3548200450309493 * s1, 2.3548200450309493 * s2
    else:
        f1 = float(psf_cfg.get("fwhm1", opsim.get("FWHMgeom", 0.6)))
        f2 = float(psf_cfg.get("fwhm2", 2 * f1))
        w1 = float(psf_cfg.get("wgt1", 0.8))
        s1 = f1 / 2.3548200450309493
        s2 = f2 / 2.3548200450309493

    def T(k):
        return (w1 * np.exp(-0.5 * (s1 * k) ** 2)
                + (1 - w1) * np.exp(-0.5 * (s2 * k) ** 2))

    return radial_cdf_from_mtf(T, r_max=8 * f2, k_max=40.0 / f1)


def _angular_sep(ra0, dec0, ra1, dec1):
    """Great-circle separation (radians in, radians out)."""
    s = (np.sin(0.5 * (dec1 - dec0)) ** 2
         + np.cos(dec0) * np.cos(dec1)
         * np.sin(0.5 * (ra1 - ra0)) ** 2)
    return 2.0 * np.arcsin(np.sqrt(np.clip(s, 0.0, 1.0)))


def sky_noise_pieces(ctx: VisitContext, prep: CcdPrep, vig_step: int = 32,
                     device=None):
    """(sky_level, gradient (a, b, c), vignetting on the stride-vig_step
    grid, vig_step, fringe map or None) for the sky stage, or None when
    the sky level is 0.  The fringe map (E2V, image.apply_fringing: the
    template's "$band == 'y'") is host numpy float32, the JAX package's;
    with a device it is uploaded there once."""
    if prep.sky_level <= 0:
        return None
    img_cfg = ctx.cfg.get("image", {})
    ccd = prep.ccd
    ny, nx = prep.pcfg.ysize, prep.pcfg.xsize
    grad = (0.0, 0.0, 1.0)
    if img_cfg.get("apply_sky_gradient", True):
        sg = SkyGradient(ctx.sky_model, prep.wcs, prep.ra_c, prep.dec_c, nx)
        grad = tuple(float(np.float32(v / sg.sky_level_center))
                     for v in (sg.a, sg.b, sg.c))
    gh, gw = coarse_shape((ny, nx), vig_step)
    vig = np.ones((gh, gw), np.float32)
    if img_cfg.get("apply_vignetting", True):
        vig = ctx.vignetting.coarse_grid(ccd.center_mm, (ny, nx), vig_step)
    fringe = None
    if img_cfg.get("apply_fringing", True) and ccd.vendor == "E2V":
        bore_ra, bore_dec = ctx.boresight
        off_deg = np.degrees(_angular_sep(float(bore_ra), float(bore_dec),
                                         prep.ra_c, prep.dec_c))
        fr = CCD_Fringing(
            sensor_fringing_seed(ccd.getSerial(),
                                 int(ctx.opsim.get("observationId", 0))),
            boresight_offset_deg=float(off_deg))
        skyline = None
        sk_file = _data(img_cfg.get("fringing_skyline_file"))
        if sk_file:
            # the first HDU with data
            for _, data in read_fits(sk_file):
                if data is not None:
                    skyline = np.asarray(data, float)
                    break
        amp = fringing_amplitude(ctx.sky_model.sky_sed, ctx.bandpass)
        fringe = fr.fringing_map((ny, nx), amplitude=amp,
                                 skyline_surface=skyline)
        if device is not None:
            fringe = torch.as_tensor(fringe, device=device)
    return prep.sky_level, grad, vig, vig_step, fringe


def _cosmic_ray_catalog(ctx):
    """output.cosmic_ray_catalog: a measured span catalog (FITS; its
    header rate is CRs / CCD / s) or a saved footprint bank (.npz);
    None: the synthesized default."""
    path = _data(ctx.cfg.get("output", {}).get("cosmic_ray_catalog"))
    if not path:
        return None
    if str(path).endswith((".fits", ".fits.gz")):
        return CosmicRayCatalog.read_catalog_fits(path)[0]
    return CosmicRayCatalog.load(path)


def _render_flat(ctx, det_name, det_num, device):
    """The LSST_Flat image type: a detector-sized flat (image.xsize /
    ysize override), counts_per_pixel or countrate_per_pixel x exptime
    (80,000 e-/px by default) in iterations of max_counts_per_iter (alias
    counts_per_iter); with image.sed, wavelengths from that SED through
    the silicon (build_flat_photons)."""
    from ..catalog.sed import _cached_raw_sed
    from ..image.flat import FlatConfig, build_flat, build_flat_photons
    from ..image.scene import _wavelength_icdf

    img_cfg = ctx.cfg.get("image", {})
    ccd = ctx.camera[det_name]
    nx = int(img_cfg.get("xsize", ccd.bounds.width))
    ny = int(img_cfg.get("ysize", ccd.bounds.height))
    exptime = float(ctx.opsim.get("exptime", 30.0))
    sp = SiliconParams.make(treering_model=ctx.tree_rings.get(det_name))
    if "counts_per_pixel" in img_cfg:
        cpp = float(img_cfg["counts_per_pixel"])
    elif "countrate_per_pixel" in img_cfg:
        cpp = float(img_cfg["countrate_per_pixel"]) * exptime
    else:
        cpp = 80_000.0
    fcfg = FlatConfig(
        counts_per_pixel=cpp,
        counts_per_iter=float(img_cfg.get(
            "max_counts_per_iter", img_cfg.get("counts_per_iter", 1000.0))),
        xsize=nx, ysize=ny, exptime=exptime)
    if img_cfg.get("sed"):
        sed_dir = ((ctx.cfg.get("input", {}).get("instance_catalog", {})
                    or {}).get("sed_dir", "."))
        sed = _cached_raw_sed(os.path.join(sed_dir, img_cfg["sed"]))
        icdf = _wavelength_icdf(sed, ctx.bandpass)
        return build_flat_photons(ctx.seed + det_num, fcfg, icdf, sp,
                                  device=device)
    return build_flat(ctx.seed + det_num, fcfg, sp, device=device)


def render_one_ccd(ctx: VisitContext, det, device="cuda", *,
                   prep: CcdPrep | None = None, window=None,
                   tally: dict | None = None, write: bool = False,
                   logger=None) -> dict:
    """One CCD (`det`: its name or number) on `device`: the pooled render
    (K1, K2, K3 and the FFT pass, checkpointed with input.checkpoint),
    the sky and its noise, the cosmic rays, and the readout to raw amps
    when output.readout is on; an LSST_Flat config renders the flat.
    prep: a CcdPrep made ahead (uploaded here if it is still on the host;
    else made here, with `window`); tally: render_ccd_pooled's charge
    tally (a new dict by default).  write: pull the eimage and amps to
    the host and write the CCD's files (write_outputs).

    Returns dict(det_name, det_num, image (the render), eimage, amps
    (16, raw_ny, raw_nx) int32 ADU or None, modes, realized, pieces,
    tally, prep, host, table, wcs, ccd, seconds: seconds per step, the
    device synchronized at each step's end while tracing is on; spans
    `ccd` and, under it, `ccd.upload` and the steps `ccd.<step>`)."""
    device = torch.device(device)
    seconds = {}
    det_name, det_num = _det(ctx, det)
    with trace.span("ccd", ccd=det_name, device=device):
        if (ctx.cfg.get("image", {}) or {}).get("type") == "LSST_Flat":
            return _render_flat_ccd(ctx, det_name, det_num, device, seconds,
                                    write, logger)
        if prep is None:
            prep = prepare_ccd(ctx, det_name, window=window, device=device)
            seconds.update(prep.seconds)
        elif prep.device is None or torch.device(prep.device) != device:
            with trace.span("ccd.upload", device=device):
                prep = upload_prep(ctx, prep, device)
        clock = _Clock(seconds, device, span="ccd", ccd=det_name)
        pieces = sky_noise_pieces(ctx, prep, device=device)
        clock("sky pieces")
        pcfg = prep.pcfg
        tally = {} if tally is None else tally
        realized = modes = None
        if prep.host is not None and prep.host.n_objects > 0:
            optics = prep.use_optics
            track = bool((ctx.cfg.get("output", {}).get("truth", {})
                          or {}).get("enabled", True))
            image, modes, realized = render_ccd_pooled(
                ctx.seed + det_num, prep.host, pcfg, silicon=prep.silicon,
                tel=prep.tel32 if optics else None,
                ctx=prep.octx if optics else None,
                screens=ctx.screens(device) if optics else None,
                sk_table=prep.sk_table if optics else None,
                profiles=prep.profiles, spikes=prep.spikes,
                track_realized=track, fft_vign=prep.fft_vign, tally=tally,
                checkpointer=prep.ckpt)
        else:
            image = torch.zeros((pcfg.ysize, pcfg.xsize),
                                dtype=torch.float32, device=device)
        clock("render")
        return finish_ccd(ctx, prep, image, modes, realized, pieces, tally,
                          seconds, clock, write=write, logger=logger)


def _render_flat_ccd(ctx, det_name, det_num, device, seconds, write, logger):
    """render_one_ccd of an LSST_Flat config: the flat, its readout."""
    clock = _Clock(seconds, device, span="ccd", ccd=det_name)
    ccd = ctx.camera[det_name]
    flat = _render_flat(ctx, det_name, det_num, device)
    clock("flat")
    result = dict(det_name=det_name, det_num=det_num, image=flat,
                  eimage=flat, amps=None, modes=None, realized=None,
                  pieces=None, tally=None, prep=None, host=None,
                  table=None, wcs=ctx.wcs_factory.get_wcs(ccd), ccd=ccd,
                  seconds=seconds)
    readout = _readout_for(ctx, ccd, device)
    if readout is not None:
        result["amps"] = _run_readout(ctx, readout, flat, det_num,
                                      exptime=float(ctx.opsim.get(
                                          "exptime", 30.0)))
        clock("readout")
    if write:
        prepare_readout(ctx, result)
        write_outputs(ctx, result, logger)
    return result


def finish_ccd(ctx: VisitContext, prep: CcdPrep, image, modes, realized,
               pieces, tally, seconds: dict, clock, *, write: bool = False,
               logger=None) -> dict:
    """A rendered CCD's last stages on its device: the sky and its noise
    (`pieces` from sky_noise_pieces), the cosmic rays and the readout to
    raw amps; returns render_one_ccd's result dict (and with `write`, its
    files written).  `clock` takes each stage's seconds into `seconds`."""
    device = image.device
    det_name, det_num = prep.det_name, prep.det_num
    pcfg = prep.pcfg
    if pieces is not None:
        level, grad, vig, vstep, fringe = pieces
        n_cfg = ctx.cfg.get("image", {}).get("noise", {}) or {}
        eimage = add_sky_and_noise(
            stream(ctx.seed, "sky", det_num, device=device), image,
            float(np.float32(level)), grad, vig, pcfg.pixel_scale,
            read_noise=float(n_cfg.get("read_noise", 0.0)),
            gain=float(n_cfg.get("gain", 1.0)), vig_step=vstep,
            fringe=fringe)
    else:
        eimage = image.clone()    # the cosmic rays paint in place
    clock("sky")
    rate = float(ctx.cfg.get("output", {}).get("cosmic_ray_rate", 0.0))
    if rate > 0:
        eimage = paint_cosmic_rays(eimage, prep.exptime,
                                   seed=ctx.seed * 189 + det_num,
                                   ccd_rate=rate,
                                   catalog=_cosmic_ray_catalog(ctx))
    clock("cosmic rays")
    amps = None
    if prep.readout is not None:
        frame = eimage
        if prep.window is not None:
            # a window is read out at its place in the CCD's full frame
            full = torch.zeros((prep.ccd.bounds.height,
                                prep.ccd.bounds.width), dtype=eimage.dtype,
                               device=device)
            y0 = (full.shape[0] - eimage.shape[0]) // 2
            x0 = (full.shape[1] - eimage.shape[1]) // 2
            full[y0:y0 + eimage.shape[0], x0:x0 + eimage.shape[1]] = eimage
            frame = full
        amps = _run_readout(ctx, prep.readout, frame, det_num, prep.exptime)
        clock("readout")
    result = dict(det_name=det_name, det_num=det_num, image=image,
                  eimage=eimage, amps=amps, modes=modes, realized=realized,
                  pieces=pieces, tally=tally, prep=prep, host=prep.host,
                  table=prep.table, wcs=prep.wcs, ccd=prep.ccd,
                  seconds=seconds)
    if write:
        prepare_readout(ctx, result)
        write_outputs(ctx, result, logger)
    return result


@_timed("readout_s", "readout.run")
def _run_readout(ctx, readout: CcdReadout, frame, det_num, exptime):
    """The device readout chain -> (16, raw_ny, raw_nx) int32 amps
    (synchronized while tracing is on, so readout_s then holds its
    device time)."""
    amps = readout.run(stream(ctx.seed, "readout", det_num,
                              device=frame.device), frame, exptime)
    if trace.on():
        _sync(frame.device)
    return amps


@_timed("readout_s", "ccd.pull", _ccd_of_result)
def prepare_readout(ctx: VisitContext, result) -> None:
    """Pull the eimage and the amps to the host (numpy) in `result`, so
    write_outputs is pure host IO that a worker thread can take."""
    for k in ("eimage", "amps"):
        if isinstance(result.get(k), torch.Tensor):
            result[k] = result[k].cpu().numpy()


def eimage_header(ctx: VisitContext, det_name, wcs):
    """The eimage keywords with rotSkyPos = rotTelPos - the parallactic
    angle (electronics.headers.eimage_header)."""
    from ..electronics.headers import eimage_header as _eh

    q = float(ctx.wcs_factory.obs.parallactic_angle())
    ccd = ctx.camera[det_name]
    return _eh(ctx.opsim, det_name, ccd.getSerial(), ccd.vendor,
               ctx.cfg.get("output", {}).get("camera", "LsstCamSim"),
               wcs, np.degrees(q))


# output keys that are not extra outputs
_BUILTIN_OUTPUT_KEYS = {
    "readout", "opd", "sag", "truth", "photon_pooling_truth", "camera",
    "dir", "file_name", "nfiles", "det_num", "only_dets", "mesh",
    "io_workers", "njobs", "job", "prefetch", "process_info",
    "cosmic_ray_rate", "cosmic_ray_catalog", "truth_realized"}


@_timed("io_s", "io.write", _ccd_of_result)
def write_outputs(ctx: VisitContext, result, logger=None):
    """The CCD's files under output.dir: the eimage FITS (with the
    output.header extras), the RICE raw amp file (with
    readout.added_keywords), and the extra outputs: opd and sag when
    their sections are present, truth (or photon_pooling_truth), and any
    other output.<key> whose type is a registered extra output.  The
    eimage and amps must be host arrays (prepare_readout)."""
    from ..electronics.headers import amp_header, raw_primary_header

    cfg = ctx.cfg
    out_cfg = cfg.get("output", {})
    outdir = out_cfg.get("dir", "output")
    det_name, det_num = result["det_name"], result["det_num"]
    wcs, ccd = result["wcs"], result["ccd"]
    camera_name = out_cfg.get("camera", "LsstCamSim")

    fname = _format_name(out_cfg.get("file_name", "eimage.fits"), ctx,
                         det_name, det_num)
    ehdr = eimage_header(ctx, det_name, wcs)
    for k, v in (out_cfg.get("header") or {}).items():
        ehdr[str(k)[:8].upper()] = ctx.view.resolve(v)
    write_fits(os.path.join(outdir, fname),
               [HDU(np.asarray(result["eimage"], np.float32), header=ehdr)])

    r_cfg = out_cfg.get("readout", {}) or {}
    if r_cfg.get("enabled", True):
        amps = result["amps"]
        phdr = raw_primary_header(eimage_header(ctx, det_name, wcs),
                                  ccd.getSerial(), camera_name)
        for k, v in (r_cfg.get("added_keywords") or {}).items():
            phdr[str(k)[:8].upper()] = ctx.view.resolve(v)
        hdus = [HDU(None, header=phdr, is_primary=True)]
        for k, aname in enumerate(ccd.amp_names):
            hdus.append(HDU(amps[k], header=amp_header(ccd, ccd[aname], wcs),
                            compress="rice"))
        rname = _format_name(r_cfg.get("file_name", "amp.fits"), ctx,
                             det_name, det_num)
        write_fits(os.path.join(outdir, rname), hdus)

    for name in ("opd", "sag"):
        if name in out_cfg:
            EXTRA_OUTPUT_TYPES[name](ctx, result, out_cfg.get(name) or {},
                                     det_name, det_num, outdir)
    if "photon_pooling_truth" in out_cfg:
        EXTRA_OUTPUT_TYPES["photon_pooling_truth"](
            ctx, result, out_cfg["photon_pooling_truth"] or {}, det_name,
            det_num, outdir)
    if "truth" in out_cfg or "photon_pooling_truth" not in out_cfg:
        EXTRA_OUTPUT_TYPES["truth"](ctx, result, out_cfg.get("truth") or {},
                                    det_name, det_num, outdir)
    for key, node in out_cfg.items():
        if key in _BUILTIN_OUTPUT_KEYS or not isinstance(node, dict):
            continue
        handler = EXTRA_OUTPUT_TYPES.get(node.get("type", key))
        if handler is not None:
            handler(ctx, result, node, det_name, det_num, outdir)
    if logger:
        logger.info("wrote outputs for %s", det_name)


@register_extra_output("opd")
def _extra_opd(ctx, result, node, det_name, det_num, outdir):
    """OPD maps with each field's Zernike coefficients in AZ_### cards."""
    if not node.get("enabled", True):
        return
    from ..optics.opd import (OBSCURATION, annular_zernikes,
                              opd_fits_header, opd_map)

    fields = node.get("fields", [[0.0, 0.0]])
    wl = float(node.get("wavelength", ctx.bandpass.effective_wavelength))
    design = ctx.wcs_factory.telescope.fiducial
    eps = float(node.get("eps", OBSCURATION))
    jmax = int(node.get("jmax", 28))
    sph_rad = node.get("sphereRadius")
    hdus = [HDU(None, is_primary=True)]
    for fx_deg, fy_deg in fields:
        thx, thy = fx_deg * DEG, fy_deg * DEG
        img, _, _, _ = opd_map(design, thx, thy, wl,
                               nx=int(node.get("nx", 255)))
        hdr = opd_fits_header(thx, thy, wl, jmax=jmax, eps=eps)
        if sph_rad is not None:
            hdr["SPH_RAD"] = float(sph_rad)
        zk = annular_zernikes(design, thx, thy, wl, jmax=jmax, eps=eps,
                              nx=65)
        for j, c in enumerate(zk, start=1):
            hdr[f"AZ_{j:03d}"] = float(c)
        hdus.append(HDU(np.nan_to_num(img).astype(np.float32), header=hdr))
    oname = _format_name(node.get("file_name", "opd.fits"), ctx, det_name,
                         det_num)
    write_fits(os.path.join(outdir, oname), hdus)


@register_extra_output("sag")
def _extra_sag(ctx, result, node, det_name, det_num, outdir):
    """Surface sag maps, one HDU per surface."""
    if not node.get("enabled", True):
        return
    from ..optics.opd import surface_sag_map

    design = ctx.wcs_factory.telescope.fiducial
    hdus = [HDU(None, is_primary=True)]
    for sname in node.get("surfaces", ["M1", "M2", "M3"]):
        sag, _, u = surface_sag_map(design, sname,
                                    nx=int(node.get("nx", 255)))
        hdus.append(HDU(np.nan_to_num(sag).astype(np.float32),
                        header={"SURFACE": sname, "UNITS": "m",
                                "RMAX": float(u[-1])}, name=sname))
    sname_out = _format_name(node.get("file_name", "sag.fits"), ctx,
                             det_name, det_num)
    write_fits(os.path.join(outdir, sname_out), hdus)


@register_extra_output("truth")
@register_extra_output("photon_pooling_truth")
def _extra_truth(ctx, result, node, det_name, det_num, outdir):
    """The truth ("centroid") catalog: object_id ra dec x y nominal_flux
    phot_flux fft_flux realized_flux mode, phot / fft split by rendering
    mode, realized accumulated over the pooled batches."""
    if not node.get("enabled", True) or result["host"] is None:
        return
    host = result["host"]
    tname = _format_name(node.get("file_name", "centroid.txt"), ctx,
                         det_name, det_num)
    path = os.path.join(outdir, tname)
    table = result.get("table")
    if host.pix_x is not None:
        xs, ys = host.pix_x, host.pix_y
    else:
        params = host.scene.params[:host.n_objects].cpu().numpy()
        xs, ys = params[:, 0], params[:, 1]
    n = host.n_objects
    ras = np.degrees(table.ra) if table is not None else np.zeros(n)
    decs = np.degrees(table.dec) if table is not None else np.zeros(n)
    ids = table.id if table is not None and len(
        getattr(table, "id", ())) == n else np.arange(n)
    modes = result["modes"]
    realized = result.get("realized")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("# object_id ra dec x y nominal_flux phot_flux "
                "fft_flux realized_flux mode\n")
        for i in range(n):
            m = int(modes[i]) if modes is not None else 1
            phot = host.flux[i] if m != 0 else 0.0
            fft = host.flux[i] if m == 0 else 0.0
            real = realized[i] if realized is not None else host.flux[i]
            f.write(f"{ids[i]} {ras[i]:.8f} {decs[i]:.8f} "
                    f"{xs[i]:.4f} {ys[i]:.4f} "
                    f"{host.nominal_flux[i]:.2f} {phot:.0f} "
                    f"{fft:.0f} {real:.2f} {m}\n")


def run_visit_iter(cfg_or_path, overrides=(), device="cuda", logger=None):
    """Render a visit, yielding each CCD's result as soon as its files
    are written (or handed to the IO pool), so a caller never holds more
    than the CCDs in flight (visit_loop).  With output.process_info:
    {file_name: ...} a per-detector process catalog is written at the
    end (with several ranks, one a rank: `.rank<r>` after the name).

    output.mesh renders the CCDs over the ranks of a ('ccd', 'phot')
    mesh (parallel.visit.run_visit_mesh); a rank then yields the CCDs
    whose files it wrote."""
    cfg = load_config(cfg_or_path, overrides)
    is_flat = (cfg.get("image", {}) or {}).get("type") == "LSST_Flat"
    ctx = build_visit_context(cfg, logger)
    out_cfg = ctx.cfg.get("output", {}) or {}
    dets = _det_list(ctx)
    pi_cfg = out_cfg.get("process_info") or {}
    if out_cfg.get("mesh") and not is_flat:
        from ..parallel.visit import run_visit_mesh

        results = run_visit_mesh(ctx, dets, out_cfg["mesh"], logger,
                                 device=device)
    else:
        results = visit_loop(
            ctx, dets, lambda det_num, prep: render_one_ccd(
                ctx, det_num, device, prep=prep, logger=logger),
            device, logger, prefetch=not is_flat)
    for result in results:
        if pi_cfg:
            from ..utils.process_info import record_det_row

            record_det_row(result["det_name"], logger)
        yield result

    if pi_cfg:
        from ..utils.process_info import write_det_catalog

        fname = _format_name(pi_cfg.get("file_name",
                                        "process_info_{visit}.txt"),
                             ctx, "all", 0)
        if dist.is_initialized() and dist.get_world_size() > 1:
            fname += f".rank{dist.get_rank()}"
        write_det_catalog(os.path.join(out_cfg.get("dir", "output"), fname))


def visit_loop(ctx: VisitContext, dets, render, device, logger=None,
               prefetch: bool = True):
    """Render `dets` in turn with render(det_num, prep) -> result (None:
    nothing for this process to write) and write each result's files.

    The next CCD's host preparation runs in a worker thread while the
    main thread renders (output.prefetch: false turns it off; so does
    prefetch=False, and one-CCD lists never prefetch); render uploads
    it.  With output.io_workers >= 1 and more than one CCD, the file
    writes go to that many threads, at most 2 x io_workers CCDs pending.
    The worker threads run no device collective.  The render thread's
    waits for a preparation and for the IO backlog are the spans
    `visit.wait_prep` and `visit.wait_io`."""
    out_cfg = ctx.cfg.get("output", {}) or {}
    io_workers = int(out_cfg.get("io_workers", 0))

    def preps_ahead():
        """(det, host prep or None): the next CCD's prep runs in a worker
        thread while this one renders."""
        if not prefetch or len(dets) <= 1 \
                or out_cfg.get("prefetch", True) is False:
            for det_num in dets:
                yield det_num, None
            return
        from concurrent.futures import ThreadPoolExecutor

        def host_prep(det_num):
            return prepare_ccd(ctx, det_num, device=device, upload=False)

        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(host_prep, dets[0])
            for k, det_num in enumerate(dets):
                with trace.span("visit.wait_prep",
                                ccd=_det(ctx, det_num)[0]):
                    prep = fut.result()
                if k + 1 < len(dets):
                    fut = pool.submit(host_prep, dets[k + 1])
                yield det_num, prep

    if io_workers <= 0 or len(dets) <= 1:
        for det_num, prep in preps_ahead():
            result = render(det_num, prep)
            if result is not None:
                prepare_readout(ctx, result)
                write_outputs(ctx, result, logger)
                yield result
        return
    from concurrent.futures import ThreadPoolExecutor

    def write_and_release(result):
        # each pending write holds a (16, raw_ny, raw_nx) int32 stack:
        # drop it once the file is on disk
        write_outputs(ctx, result, logger)
        result.pop("amps", None)

    def wait_io(det_name, fut):
        with trace.span("visit.wait_io", ccd=det_name):
            fut.result()                           # IO errors surface

    futures = []
    with ThreadPoolExecutor(max_workers=io_workers) as pool:
        for det_num, prep in preps_ahead():
            while len(futures) >= 2 * io_workers:
                wait_io(*futures.pop(0))
            result = render(det_num, prep)
            if result is None:
                continue
            prepare_readout(ctx, result)           # device, main thread
            futures.append((result["det_name"],
                            pool.submit(write_and_release, result)))
            yield result
        for f in futures:
            wait_io(*f)


def run_visit(cfg_or_path, overrides=(), device="cuda", logger=None):
    """Render a visit (`python -m imsim_tpu_torch user.yaml` as a call);
    returns the per-CCD results with host eimages.  The render's device
    image, tally, sky pieces and prep are dropped, and beyond the first
    16 CCDs the eimage too unless output.keep_images: true (the files
    hold everything)."""
    cfg = load_config(cfg_or_path, overrides)
    keep = (cfg.get("output", {}) or {}).get("keep_images")
    results = []
    for result in run_visit_iter(cfg, device=device, logger=logger):
        result = dict(result, image=None, tally=None, pieces=None,
                      prep=None)
        if keep is False or (keep is not True and len(results) >= 16):
            result["eimage"] = None
            result.pop("amps", None)
        results.append(result)
    return results
