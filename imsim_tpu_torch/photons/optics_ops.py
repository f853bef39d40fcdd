"""Device photon ops: DCR, spider diffraction, ray trace, silicon
refraction (imsim_tpu/photons/optics_ops.py counterpart).

`field_to_sensor` draws the chain's random numbers from the caller's
generators and hands the whole chain to the K2 wrapper
(`ops.raychain.field_to_sensor`): the CUDA kernel on a CUDA tensor, the
plain composition `field_to_sensor_plain` below on a CPU tensor.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..optics import geometry as G
from ..optics.trace import rays_from_field, trace
from ..utils import rng
from . import diffraction as D
from .ops import ARCSEC, silicon_index  # noqa: F401

# trace frame -> focal-plane DVCS (imsim_tpu.optics.wcs_factory.FOCAL_FRAME)
FOCAL_FRAME = ((0.0, 1.0), (-1.0, 0.0))


@dataclasses.dataclass(frozen=True)
class OpticsContext:
    """Per-visit scalars of the photon chain (float32 values held as
    python floats; built by `make_optics_context` from a WCS factory, or
    read from an exported state by convert.optics_context_from_numpy)."""

    bore_alt: float       # observed boresight altitude [rad]
    bore_az: float
    j01: float            # alt-az -> camera field Jacobian (the
    j11: float            #   column the zenith-ward DCR kick uses)
    crot: float           # cos/sin rotTelPos
    srot: float
    k1_ref: float         # refraction coefficients at the WCS wavelength
    k2_ref: float
    det_cx_mm: float      # detector centre in the focal plane
    det_cy_mm: float
    det_crot: float       # cos/sin of the detector yaw
    det_srot: float
    det_nx: int
    det_ny: int
    latitude: float
    pressure_kpa: float
    temperature_k: float
    h2o_kpa: float


def _f32(v) -> float:
    return float(np.float32(v))


def make_optics_context(wcs_factory, ccd) -> OpticsContext:
    """The visit's scalars for one CCD, on the host: the observed
    boresight, the alt-az -> camera field Jacobian measured from the
    factory's own observed -> field chain (so DCR and spider kicks land
    where the written WCS expects them), the rotator, the refraction
    coefficients at the WCS wavelength (the weather the Observation
    used) and the detector's place and yaw, each rounded to float32 as
    the JAX package's make_optics_context rounds them."""
    obs = wcs_factory.obs
    J = wcs_factory.altaz_to_field_jacobian()
    rtp = wcs_factory.telescope.rotTelPos
    yaw = np.radians(getattr(ccd, "rot_deg", 0.0))
    return OpticsContext(
        bore_alt=_f32(obs.bore_alt), bore_az=_f32(obs.bore_az),
        j01=_f32(J[0, 1]), j11=_f32(J[1, 1]),
        crot=_f32(np.cos(rtp)), srot=_f32(np.sin(rtp)),
        k1_ref=_f32(obs.k1), k2_ref=_f32(obs.k2),
        det_cx_mm=_f32(ccd.center_mm[0]), det_cy_mm=_f32(ccd.center_mm[1]),
        det_crot=_f32(np.cos(yaw)), det_srot=_f32(np.sin(yaw)),
        det_nx=ccd.bounds.width, det_ny=ccd.bounds.height,
        latitude=float(obs.lat), pressure_kpa=float(obs.pressure_kpa),
        temperature_k=float(obs.temperature_k),
        h2o_kpa=float(obs.h2o_pressure_kpa))


def dcr_kick(ctx: OpticsContext, thx, thy, wavelength_nm):
    """Differential chromatic refraction as a zenith-ward field-angle
    kick R(lambda) - R(lambda_ref)."""
    v = ctx.j01 * thx + ctx.j11 * thy
    alt = ctx.bore_alt + v
    xi = G.air_index_excess(wavelength_nm, ctx.pressure_kpa,
                            ctx.temperature_k, ctx.h2o_kpa)
    beta = 0.001254
    k1 = xi * (1.0 - beta)
    k2 = -xi * (beta + xi * 0.5)
    tz = torch.tan(torch.clamp(0.5 * np.pi - alt, 0.0, 1.5))
    dalt = (k1 - ctx.k1_ref) * tz + (k2 - ctx.k2_ref) * tz**3
    return thx + ctx.j01 * dalt, thy + ctx.j11 * dalt


def silicon_refraction(vx, vy, wavelength_nm):
    """Slopes (dx/dz, dy/dz) of the exit ray refracted into the silicon:
    Snell's law in slope form, (v/n) / t_z (the XLA formula of
    imsim_tpu.photons.optics_ops.silicon_refraction)."""
    inv = 1.0 / silicon_index(wavelength_nm)
    tx = vx * inv
    ty = vy * inv
    tz = torch.sqrt(torch.clamp(1.0 - tx * tx - ty * ty, min=1e-6))
    return tx / tz, ty / tz


def field_to_sensor_plain(tel, ctx: OpticsContext, thx, thy, pupil_u,
                          pupil_v, wavelength_nm, time_s, flux, normal,
                          apply_dcr=True, apply_diffraction=True,
                          field_rotation=True):
    """Plain composition of the chain: field angles -> detector pixels
    and in-silicon slopes.  Returns (x_pix, y_pix, dxdz, dydz, flux)
    with vignetted flux zeroed."""
    if apply_dcr:
        thx, thy = dcr_kick(ctx, thx, thy, wavelength_nm)
    if apply_diffraction:
        z = torch.zeros_like(thx)
        dthx, dthy = D.apply_diffraction(
            pupil_u, pupil_v, z, z, wavelength_nm, normal, t=time_s,
            latitude=ctx.latitude, altitude=ctx.bore_alt,
            azimuth=ctx.bore_az, enable_field_rotation=field_rotation)
        # spider-kick frame -> camera field: rotate by -rotTelPos
        thx = thx + (ctx.crot * dthx + ctx.srot * dthy)
        thy = thy + (-ctx.srot * dthx + ctx.crot * dthy)
    rays = rays_from_field(thx, thy, pupil_u, pupil_v)
    out = trace(tel, *rays, wavelength_nm)
    flux = torch.where(out["vignette"], 0.0, flux)
    (f00, f01), (f10, f11) = FOCAL_FRAME
    fx = f00 * out["x"] + f01 * out["y"]
    fy = f10 * out["x"] + f11 * out["y"]
    ux = fx * 1e3 - ctx.det_cx_mm
    uy = fy * 1e3 - ctx.det_cy_mm
    x_pix = (ctx.det_crot * ux + ctx.det_srot * uy) * 100.0 \
        + (ctx.det_nx - 1) / 2.0
    y_pix = (-ctx.det_srot * ux + ctx.det_crot * uy) * 100.0 \
        + (ctx.det_ny - 1) / 2.0
    dxdz, dydz = silicon_refraction(out["vx"], out["vy"], wavelength_nm)
    return x_pix, y_pix, dxdz, dydz, flux


def field_to_sensor(gen, tel, ctx: OpticsContext, thx, thy, pupil_u,
                    pupil_v, wavelength_nm, time_s, flux,
                    apply_dcr=True, apply_diffraction=True,
                    field_rotation=True, silicon=None, si_gen=None):
    """The fused DCR + diffraction + trace + refraction chain.  Returns
    (x_pix, y_pix, dxdz, dydz, flux).  The diffraction normal comes from
    `gen`; with `silicon` (a SiliconParams) the depth/diffusion draws
    come from `si_gen`, the displacement runs inside the chain, x/y are
    final positions and dxdz/dydz come back as zeros."""
    from ..ops import raychain

    n = thx.shape[0]
    normal = rng.normal(gen, n) if apply_diffraction \
        else torch.zeros_like(thx)
    draws = None
    if silicon is not None:
        from ..sensor.silicon import silicon_draws

        draws = silicon_draws(si_gen, n)
    out = raychain.field_to_sensor(
        tel, ctx, thx, thy, pupil_u, pupil_v, wavelength_nm, time_s, flux,
        normal, apply_dcr=apply_dcr, apply_diffraction=apply_diffraction,
        field_rotation=field_rotation, silicon=silicon, si_draws=draws)
    if silicon is None:
        return out
    x, y, f = out
    z = torch.zeros_like(x)
    return x, y, z, z, f
