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
from .ops import silicon_index

# trace frame -> focal-plane DVCS (imsim_tpu.optics.wcs_factory.FOCAL_FRAME)
FOCAL_FRAME = ((0.0, 1.0), (-1.0, 0.0))


@dataclasses.dataclass(frozen=True)
class OpticsContext:
    """Per-visit scalars of the photon chain (float32 values held as
    python floats; built by the JAX package's make_optics_context and
    carried across by convert.optics_context_from_numpy)."""

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
        u = rng.uniform(si_gen, n, 1e-7, 1.0)
        draws = (u, rng.normal(si_gen, n), rng.normal(si_gen, n))
    out = raychain.field_to_sensor(
        tel, ctx, thx, thy, pupil_u, pupil_v, wavelength_nm, time_s, flux,
        normal, apply_dcr=apply_dcr, apply_diffraction=apply_diffraction,
        field_rotation=field_rotation, silicon=silicon, si_draws=draws)
    if silicon is None:
        return out
    x, y, f = out
    z = torch.zeros_like(x)
    return x, y, z, z, f
