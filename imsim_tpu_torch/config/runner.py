"""The runner's per-CCD path for an instance catalog (counterpart of
imsim_tpu/config/runner.py's build_visit_context, prepare_ccd,
_sky_noise_pieces and render_one_ccd), without the YAML interpreter:

  opsim header -> visit context (telescope, WCS factory, bandpass, sky
  model, tree rings, vignetting, atmosphere, camera)
  -> per CCD: WCS cull of the catalog -> SEDs through the bandpass ->
     scene with field angles -> silicon, pooling, sky level, second kick,
     spikes -> pooled render (K1, K2, K3 and the FFT pass) -> sky with
     its gradient, vignetting and (y, E2V) fringing -> cosmic rays ->
     readout to raw amps.

The config defaults are the JAX package's templates, as Python constants
(`DEFAULTS`); `overrides` changes them by the same dotted keys.  The
host steps are the JAX package's numpy in its order (the scene, the
field angles, the sky level and gradient are bit-equal to its runner's,
tests/test_torch_instcat_ccd.py); the device steps run on the caller's
device.  No FITS file is written (the writers are ROADMAP A6).
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from .. import convert
from ..catalog import opsim as opsim_mod
from ..catalog.bandpass import rubin_bandpass, rubin_bandpass_from_files
from ..catalog.instcat import read_instcat
from ..electronics.camera import PIXEL_SIZE_MM, get_camera
from ..electronics.readout import CcdReadout
from ..image import scene as scene_mod
from ..image.ccd_render import add_sky_and_noise
from ..image.cosmic_rays import paint_cosmic_rays
from ..image.diffraction_fft import spike_kernel
from ..image.photon_pooling import PoolingConfig, render_ccd_pooled
from ..image.sky import CCD_Fringing, SkyGradient, SkyModel, \
    sensor_fringing_seed
from ..image.sky_sed import fringing_amplitude, load_sky_sed
from ..image.vignetting import Vignetting
from ..io.fits import read_fits
from ..optics.astrometry import RUBIN_LAT
from ..photons.diffraction import field_rotation_sincos
from ..psf.atmosphere import AtmConfig, make_screens, screen_spec
from ..sensor.treerings import TreeRings
from ..utils.grid import coarse_shape
from ..utils.rng import ATM_SEED_OFFSET, stream

DEG = np.pi / 180.0

# The JAX package's template values, by dotted config key; each cites its
# template line (imsim-config.yaml unless named) or the JAX runner's line
# that reads it.  The runner reads no other key; the template's sensor
# (Silicon, :60) and photon ops (PhotonDCR and RubinDiffractionOptics,
# :84-86: PoolingConfig's defaults) are fixed.  A file key takes a path
# as given (the JAX runner also looks a bare name up in its data
# directory).
DEFAULTS = {
    "input.instance_catalog.edge_pix": 100,        # -instcat.yaml:9
    "input.instance_catalog.sort_mag": True,       # -instcat.yaml:10
    "input.instance_catalog.flip_g2": True,        # -instcat.yaml:11
    "input.instance_catalog.skip_invalid": True,   # runner.py:517
    "input.instance_catalog.min_source": None,     # runner.py:516
    "input.atm_psf.L0": 25.0,                      # :25
    "input.atm_psf.kcrit": 0.2,                    # :26
    "input.atm_psf.screen_size": 819.2,            # :27
    "input.atm_psf.screen_scale": 0.8,             # :28
    "input.atm_psf.exponent": -0.3,                # :29
    "image.pixel_scale": 0.2,                      # :43
    "image.nbatch": 8,                             # :44
    "image.nsubbatch": 4,                          # :45
    "image.batch_size": 8_000_000,                 # :48
    "image.nobjects": None,                        # runner.py:523
    # {type: SkyLevel} (:51): the sky model at the CCD centre; a number
    # sets the level [photons/arcsec^2]
    "image.sky_level": "SkyLevel",
    "image.noise.gain": 1.0,                       # :54
    # measured throughput files (rubin_bandpass_from_files) in place of
    # the analytic bandpass, runner.py:132-142
    "image.bandpass.throughputs_dir": None,
    # a loaded sky spectrum for the sky model and the fringe amplitude
    # ('default': data/sky_library.npz), runner.py:144-151
    "image.sky_sed_file": None,
    # a measured OH-skyline surface (FITS) for the fringe map,
    # runner.py:799-809
    "image.fringing_skyline_file": None,
    "image.noise.read_noise": 0.0,                 # :55
    "image.apply_sky_gradient": True,              # :56
    "image.apply_fringing": None,                  # :57, "$band == 'y'"
    "image.apply_vignetting": True,                # :58
    "image.sensor.strength": 1.0,                  # runner.py:554
    "image.wcs.temperature": 280.0,                # :70
    "image.wcs.pressure": None,                    # :71
    "image.wcs.H2O_pressure": 1.0,                 # :72
    "psf.type": "AtmosphericPSF",                  # :75
    # DoubleGaussianPSF's keys (runner.py:661-680)
    "psf.fwhm": None, "psf.pixel_scale": 0.2, "psf.fwhm1": None,
    "psf.fwhm2": None, "psf.wgt1": 0.8,
    "stamp.fft_sb_thresh": 200000.0,               # :79
    "stamp.diffraction_fft.enabled": True,         # :82
    "stamp.max_flux_simple": 100.0,                # :87
    "output.camera": "LsstCamSim",                 # :91
    "output.cosmic_ray_rate": 0.2,                 # :97
    "output.readout.readout_time": 2.0,            # :100
    "output.readout.dark_current": 0.02,           # :101
    "output.readout.bias_level": 1000.0,           # :102
    "output.readout.scti": 1.0e-6,                 # :103
    "output.readout.pcti": 1.0e-6,                 # :104
}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _Clock:
    """Seconds per named step into `seconds` (the device synchronized at
    each step's end, so a step's time holds its device work)."""

    def __init__(self, seconds: dict, device=None):
        self.seconds, self.device = seconds, device
        self.t = time.perf_counter()

    def __call__(self, name):
        if self.device is not None:
            _sync(self.device)
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self.t
        self.t = now


@dataclasses.dataclass
class VisitContext:
    """Everything the visit's CCDs share."""

    cfg: dict
    opsim: opsim_mod.OpsimData
    catalog: str | None
    sed_dirs: tuple
    camera: object
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

    def screens(self, device):
        """The atmosphere's screens on `device` (made once per device
        from the visit's seed + 271828)."""
        key = str(torch.device(device))
        if key not in self._screens:
            self._screens[key] = make_screens(
                self.screen_spec, device, gen=stream(
                    self.seed + ATM_SEED_OFFSET, "screens", device=device))
        return self._screens[key]


def build_visit_context(opsim, *, catalog: str | None = None,
                        camera: str | None = None, sed_dirs=None,
                        overrides: dict | None = None) -> VisitContext:
    """The visit-scoped inputs (runner.py:75-171 with registry.py's
    loaders): `opsim` is an OpsimData, or the path of an instance
    catalog whose header gives it (and which is then the catalog).
    sed_dirs: the SED library's directories (default
    $SIMS_SED_LIBRARY_DIR, else '.'); camera: output.camera; overrides:
    {dotted key: value} over DEFAULTS."""
    seconds = {}
    clock = _Clock(seconds)
    if isinstance(opsim, (str, os.PathLike)):
        catalog = str(opsim) if catalog is None else catalog
        opsim = opsim_mod.read_instcat_header(str(opsim))
    clock("header")
    cfg = dict(DEFAULTS)
    for key, value in (overrides or {}).items():
        if key not in DEFAULTS:
            raise KeyError(f"unknown config key {key!r}; known: "
                           f"{sorted(DEFAULTS)}")
        cfg[key] = value
    if camera is not None:
        cfg["output.camera"] = camera
    ods = opsim
    band = ods.get("band", "r")
    seed = int(ods.get("seed", 42))
    if sed_dirs is None:
        sed_dirs = os.environ.get("SIMS_SED_LIBRARY_DIR", ".")
    if isinstance(sed_dirs, (str, os.PathLike)):
        sed_dirs = [sed_dirs]

    # the atmosphere (registry.py:319-363): rawSeeing, the header's
    # altitude and exposure time; its seed is the visit's + 271828
    atm_cfg = spec = None
    if cfg["psf.type"] == "AtmosphericPSF":
        atm_cfg = AtmConfig(
            fwhm=float(ods.get("rawSeeing", 0.7)), L0=cfg["input.atm_psf.L0"],
            kcrit=cfg["input.atm_psf.kcrit"],
            screen_size=float(cfg["input.atm_psf.screen_size"]),
            screen_scale=float(cfg["input.atm_psf.screen_scale"]),
            altitude_deg=float(ods.get("altitude", 90.0)),
            exptime=float(ods.get("exptime", 30.0)), t0=0.0)
        spec = screen_spec(seed + ATM_SEED_OFFSET, atm_cfg)

    # the telescope and the WCS factory at the exposure's midpoint
    # (runner.py:98-129, registry.py:301-316)
    ra = float(ods.get("fieldRA", 0.0)) * DEG
    dec = float(ods.get("fieldDec", 0.0)) * DEG
    weather = {}
    if cfg["image.wcs.pressure"] is not None:
        weather["pressure_kpa"] = float(cfg["image.wcs.pressure"])
    if cfg["image.wcs.temperature"] is not None:
        weather["temperature_k"] = float(cfg["image.wcs.temperature"])
    if cfg["image.wcs.H2O_pressure"] is not None:
        weather["h2o_pressure_kpa"] = float(cfg["image.wcs.H2O_pressure"])
    fac = convert.visit_factory(
        ra, dec, float(ods.get("mjd_mid", 60674.0)), band,
        float(ods.get("rotTelPos", 0.0)) * np.pi / 180, **weather)

    # bandpass and sky model (runner.py:132-154, registry.py:366-399):
    # opsim's moonPhase is percent illuminated, K&S want the phase angle
    airmass = float(ods.get("airmass", 1.0))
    if cfg["image.bandpass.throughputs_dir"]:
        bandpass = rubin_bandpass_from_files(
            band, str(cfg["image.bandpass.throughputs_dir"]), airmass=airmass)
    else:
        bandpass = rubin_bandpass(band, airmass=airmass)
    sky_sed = None
    if cfg["image.sky_sed_file"]:
        sky_sed = load_sky_sed(str(cfg["image.sky_sed_file"]))
    f = np.clip(float(ods.get("moonPhase", 0.0)) / 100.0, 0.0, 1.0)
    alpha_deg = float(np.degrees(np.arccos(2.0 * f - 1.0)))
    sky_model = SkyModel(
        float(ods.get("exptime", 30.0)), ods.get("mjd_mid", 60674.0),
        bandpass, airmass=airmass,
        moon_phase_deg=alpha_deg,
        moon_alt_rad=float(ods.get("moonAlt", -28.65)) * DEG,
        moon_ra=float(ods.get("moonRA", 0.0)) * DEG,
        moon_dec=float(ods.get("moonDec", 0.0)) * DEG,
        sun_alt_rad=float(ods.get("sunAlt", -57.3)) * DEG, sky_sed=sky_sed)
    ctx = VisitContext(
        cfg=cfg, opsim=ods, catalog=catalog, sed_dirs=tuple(sed_dirs),
        camera=get_camera(cfg["output.camera"]), wcs_factory=fac,
        bandpass=bandpass, sky_model=sky_model, tree_rings=TreeRings(),
        vignetting=Vignetting(), atm_cfg=atm_cfg, screen_spec=spec,
        boresight=(ra, dec), seed=seed, seconds=seconds)
    clock("visit")
    return ctx


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
    """One CCD's host preparation (runner.py:240-267): what the device
    render, the sky stage and the readout need."""

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
    silicon: object
    pcfg: PoolingConfig
    sky_level: float
    ra_c: float
    dec_c: float
    sk_table: object | None
    spikes: dict | None
    fft_vign: object | None
    exptime: float
    profiles: object
    readout: CcdReadout
    window: tuple | None
    seconds: dict


def _field_rotation_deg(ts, altitude, azimuth):
    """The field rotation angle [deg] at the times ts [s]."""
    s, c = field_rotation_sincos(torch.as_tensor(ts, dtype=torch.float64),
                                 RUBIN_LAT, altitude, azimuth)
    return np.degrees(torch.atan2(s, c).numpy())


def prepare_ccd(ctx: VisitContext, det_name: str, *, window=None,
                device="cuda") -> CcdPrep:
    """The host preparation of one CCD (runner.py:425-745, the instance-
    catalog branch): WCS and optics, the catalog's cull and scene with
    field angles (on `device`), the silicon, the pooling configuration,
    the sky level at the CCD centre, the second kick, the spike kernel
    and the FFT stamps' vignetting.  window=(h, w): the CCD's central h x
    w pixels as a frame of their own (for rehearsals and tests).  A PSF
    other than AtmosphericPSF renders through the analytic path
    (runner.py:455-458, 657-686)."""
    cfg = ctx.cfg
    seconds = {}
    clock = _Clock(seconds)
    det_num = ctx.camera.det_num(det_name)
    ccd = ctx.camera[det_name]
    nx, ny = ccd.bounds.width, ccd.bounds.height
    exptime = float(ctx.opsim.get("exptime", 30.0))
    wcs, tel32, octx = convert.ccd_optics(ctx.wcs_factory, ccd)
    if window is not None:
        h, w = (int(v) for v in window)
        if (nx - w) % 2 or (ny - h) % 2:
            raise ValueError(f"window {window} is not centred on the "
                             f"{ny} x {nx} frame")
        wcs = WindowWCS(wcs, (nx - w) // 2, (ny - h) // 2)
        octx = dataclasses.replace(octx, det_nx=w, det_ny=h)
        nx, ny = w, h
    bandpass = ctx.bandpass
    use_optics = cfg["psf.type"] == "AtmosphericPSF"
    clock("wcs")

    # ---- catalog -> scene (runner.py:509-544) -------------------------
    table = read_instcat(
        ctx.catalog, wcs=wcs, xsize=nx, ysize=ny,
        edge_pix=float(cfg["input.instance_catalog.edge_pix"]),
        sort_mag=bool(cfg["input.instance_catalog.sort_mag"]),
        flip_g2=bool(cfg["input.instance_catalog.flip_g2"]),
        min_source=cfg["input.instance_catalog.min_source"],
        skip_invalid=bool(cfg["input.instance_catalog.skip_invalid"]))
    n_cap = cfg["image.nobjects"]
    if n_cap is not None and len(table) > int(n_cap):
        table = table.select(np.arange(len(table)) < int(n_cap))
    clock("cull")
    host = scene_mod.build_scene(
        table, bandpass, ctx.sed_dirs, exptime=exptime,
        rng=np.random.default_rng(ctx.seed + det_num), device=device)
    if use_optics:
        # the optics chain takes field angles in COL_X / COL_Y; pix_x and
        # pix_y keep the pixels
        thx, thy = ctx.wcs_factory.icrf_to_field(table.ra, table.dec)
        n = len(table)
        host.scene.params[:n, 0] = torch.as_tensor(
            np.asarray(thx, np.float32), device=host.scene.params.device)
        host.scene.params[:n, 1] = torch.as_tensor(
            np.asarray(thy, np.float32), device=host.scene.params.device)
    clock("scene")

    # ---- silicon (runner.py:549-592) ------------------------------------
    silicon = convert.runner_silicon(ccd, ctx.tree_rings,
                                     float(cfg["image.sensor.strength"]))

    # ---- pooling configuration (runner.py:606-645) ----------------------
    pcfg = PoolingConfig(
        xsize=nx, ysize=ny, exptime=exptime, nbatch=int(cfg["image.nbatch"]),
        batch_size=int(cfg["image.batch_size"]),
        nsub=int(cfg["image.nsubbatch"]),
        faint_thresh=float(cfg["stamp.max_flux_simple"]),
        fft_sb_thresh=float(cfg["stamp.fft_sb_thresh"]),
        pixel_scale=float(cfg["image.pixel_scale"]),
        fwhm=float(ctx.opsim.get("FWHMeff", 0.8)),
        chromatic_exponent=float(cfg["input.atm_psf.exponent"])
        if ctx.atm_cfg is not None else 0.0,
        wl_ref=float(bandpass.effective_wavelength))
    # the per-pixel sky level: the sky model at the CCD centre (the
    # {type: SkyLevel} node stays unresolved, so the runner's elif runs)
    sky_val = cfg["image.sky_level"]
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
    # every other PSF renders through the analytic path: Kolmogorov at
    # FWHMeff, or DoubleGaussianPSF's table
    if cfg["psf.type"] == "DoubleGaussianPSF":
        pcfg = dataclasses.replace(pcfg, psf_table=_double_gaussian_table(
            cfg, ctx.opsim))

    # ---- spikes of the FFT stars (runner.py:692-726) --------------------
    spikes = None
    if pcfg.fft_sb_thresh > 0 and cfg["stamp.diffraction_fft.enabled"]:
        alt = min(float(ctx.opsim.get("altitude", 90.0)), 89.9) * DEG
        az = float(ctx.opsim.get("azimuth", 0.0)) * DEG
        ts = np.linspace(0.0, max(exptime, 1e-3), 24)
        thetas = _field_rotation_deg(ts, alt, az)
        kern = spike_kernel(
            wavelength_nm=float(bandpass.effective_wavelength),
            pixel_scale=pcfg.pixel_scale,
            alpha_deg=45.0 - float(ctx.opsim.get("rotTelPos", 0.0)),
            rot_thetas_deg=tuple(np.round(thetas, 3)), device=device)
        spikes = dict(kernel=kern, sat=float(ccd.full_well))

    # the FFT stamps' vignetting at the objects (runner.py:730-737)
    fft_vign = None
    if pcfg.fft_sb_thresh > 0 and host.pix_x is not None:
        yy_mm = (np.asarray(host.pix_y) - (ny - 1) / 2) * PIXEL_SIZE_MM \
            + ccd.center_mm[1]
        xx_mm = (np.asarray(host.pix_x) - (nx - 1) / 2) * PIXEL_SIZE_MM \
            + ccd.center_mm[0]
        fft_vign = ctx.vignetting(np.hypot(xx_mm, yy_mm))

    # the readout's parameters (runner.py:869-879)
    r = {k: cfg[f"output.readout.{k}"] for k in (
        "readout_time", "dark_current", "scti", "pcti", "bias_level")}
    readout = CcdReadout.from_ccd(ccd, device, **r)
    clock("state")
    return CcdPrep(det_name=det_name, det_num=det_num, ccd=ccd, wcs=wcs,
                   octx=octx, tel32=tel32, bandpass=bandpass,
                   use_optics=use_optics, host=host, table=table,
                   silicon=silicon, pcfg=pcfg, sky_level=sky_level,
                   ra_c=float(ra_c), dec_c=float(dec_c), sk_table=sk_table,
                   spikes=spikes, fft_vign=fft_vign, exptime=exptime,
                   profiles=convert.profile_tables(), readout=readout,
                   window=None if window is None else (ny, nx),
                   seconds=seconds)


def _double_gaussian_table(cfg, opsim):
    """DoubleGaussianPSF's radial table (runner.py:661-686)."""
    from ..photons.profiles import radial_cdf_from_mtf

    if cfg["psf.fwhm"] is not None:
        alpha = float(cfg["psf.fwhm"]) / 2.3835
        pix = float(cfg["psf.pixel_scale"])
        s1 = np.sqrt(max(alpha ** 2 - pix ** 2 / 12.0, 1e-8))
        s2 = np.sqrt(max(4 * alpha ** 2 - pix ** 2 / 12.0, 1e-8))
        w1 = 1.0 / 1.1
        f1, f2 = 2.3548200450309493 * s1, 2.3548200450309493 * s2
    else:
        f1 = float(cfg["psf.fwhm1"] if cfg["psf.fwhm1"] is not None
                   else opsim.get("FWHMgeom", 0.6))
        f2 = float(cfg["psf.fwhm2"] if cfg["psf.fwhm2"] is not None
                   else 2 * f1)
        w1 = float(cfg["psf.wgt1"])
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
    the sky level is 0 (runner.py:748-820).  The fringe map (y on E2V)
    is host numpy float32, the JAX package's; with a device it is
    uploaded there once."""
    if prep.sky_level <= 0:
        return None
    cfg = ctx.cfg
    ccd = prep.ccd
    ny, nx = prep.pcfg.ysize, prep.pcfg.xsize
    grad = (0.0, 0.0, 1.0)
    if cfg["image.apply_sky_gradient"]:
        sg = SkyGradient(ctx.sky_model, prep.wcs, prep.ra_c, prep.dec_c, nx)
        grad = tuple(float(np.float32(v / sg.sky_level_center))
                     for v in (sg.a, sg.b, sg.c))
    gh, gw = coarse_shape((ny, nx), vig_step)
    vig = np.ones((gh, gw), np.float32)
    if cfg["image.apply_vignetting"]:
        vig = ctx.vignetting.coarse_grid(ccd.center_mm, (ny, nx), vig_step)
    fringe = None
    apply_fringing = cfg["image.apply_fringing"]
    if apply_fringing is None:
        apply_fringing = ctx.opsim.get("band", "r") == "y"
    if apply_fringing and ccd.vendor == "E2V":
        bore_ra, bore_dec = ctx.boresight
        off_deg = np.degrees(_angular_sep(float(bore_ra), float(bore_dec),
                                         prep.ra_c, prep.dec_c))
        fr = CCD_Fringing(
            sensor_fringing_seed(ccd.getSerial(),
                                 int(ctx.opsim.get("observationId", 0))),
            boresight_offset_deg=float(off_deg))
        skyline = None
        if cfg["image.fringing_skyline_file"]:
            # the first HDU with data
            for _, data in read_fits(str(cfg["image.fringing_skyline_file"])):
                if data is not None:
                    skyline = np.asarray(data, float)
                    break
        amp = fringing_amplitude(ctx.sky_model.sky_sed, ctx.bandpass)
        fringe = fr.fringing_map((ny, nx), amplitude=amp,
                                 skyline_surface=skyline)
        if device is not None:
            fringe = torch.as_tensor(fringe, device=device)
    return prep.sky_level, grad, vig, vig_step, fringe


def render_one_ccd(ctx: VisitContext, det_name: str, device="cuda", *,
                   prep: CcdPrep | None = None, window=None,
                   tally: dict | None = None) -> dict:
    """One CCD from the instance catalog (runner.py:343-391 and the
    readout of :869-884) on `device`: the pooled render with the FFT
    pass, the sky and its noise, the cosmic rays, the readout to raw
    amps.  prep: a CcdPrep made ahead (else made here, with `window`);
    tally: render_ccd_pooled's charge tally.  Returns dict(det_name,
    det_num, image (the render), eimage, amps (16, raw_ny, raw_nx) int32
    ADU, modes, realized, pieces, prep, seconds: host seconds per step,
    the device synchronized at each step's end)."""
    device = torch.device(device)
    seconds = {}
    if prep is None:
        prep = prepare_ccd(ctx, det_name, window=window, device=device)
        seconds.update(prep.seconds)
    clock = _Clock(seconds, device)
    pieces = sky_noise_pieces(ctx, prep, device=device)
    clock("sky pieces")
    pcfg, det_num = prep.pcfg, prep.det_num
    realized = modes = None
    if prep.host is not None and prep.host.n_objects > 0:
        optics = prep.use_optics
        image, modes, realized = render_ccd_pooled(
            ctx.seed + det_num, prep.host, pcfg, silicon=prep.silicon,
            tel=prep.tel32 if optics else None,
            ctx=prep.octx if optics else None,
            screens=ctx.screens(device) if optics else None,
            sk_table=prep.sk_table if optics else None,
            profiles=prep.profiles, spikes=prep.spikes, track_realized=True,
            fft_vign=prep.fft_vign, tally=tally)
    else:
        image = torch.zeros((pcfg.ysize, pcfg.xsize), dtype=torch.float32,
                            device=device)
    clock("render")
    if pieces is not None:
        level, grad, vig, vstep, fringe = pieces
        eimage = add_sky_and_noise(
            stream(ctx.seed, "sky", det_num, device=device), image,
            float(np.float32(level)), grad, vig, pcfg.pixel_scale,
            read_noise=float(ctx.cfg["image.noise.read_noise"]),
            gain=float(ctx.cfg["image.noise.gain"]), vig_step=vstep,
            fringe=fringe)
    else:
        eimage = image.clone()    # the cosmic rays paint in place
    clock("sky")
    rate = float(ctx.cfg["output.cosmic_ray_rate"])
    if rate > 0:
        eimage = paint_cosmic_rays(eimage, prep.exptime,
                                   seed=ctx.seed * 189 + det_num,
                                   ccd_rate=rate)
    clock("cosmic rays")
    frame = eimage
    if prep.window is not None:
        # a window is read out at its place in the CCD's full frame
        full = torch.zeros((prep.ccd.bounds.height, prep.ccd.bounds.width),
                           dtype=eimage.dtype, device=device)
        y0 = (full.shape[0] - eimage.shape[0]) // 2
        x0 = (full.shape[1] - eimage.shape[1]) // 2
        full[y0:y0 + eimage.shape[0], x0:x0 + eimage.shape[1]] = eimage
        frame = full
    amps = prep.readout.run(stream(ctx.seed, "readout", det_num,
                                   device=device), frame, prep.exptime)
    clock("readout")
    return dict(det_name=prep.det_name, det_num=det_num, image=image,
                eimage=eimage, amps=amps, modes=modes, realized=realized,
                pieces=pieces, prep=prep, seconds=seconds)
