"""K2: the fused per-photon ray chain (replaces imsim_tpu/ops/
raychain.py::field_to_sensor_pallas).

Per photon: DCR kick, spider-diffraction kick from a pre-drawn normal,
entrance ray, 12-surface conic/asphere trace with reflection,
refraction and vignetting, focal frame + detector yaw -> pixels,
silicon-refraction slopes (the XLA formula, with the /t_z), and
optionally the silicon depth/diffusion displacement with passed-in
draws (u, g1, g2).  The CUDA kernel is csrc/raychain.cu; the plain twin
composes photons.optics_ops and sensor.silicon.
"""
from __future__ import annotations

import ctypes
import os
import re

import numpy as np
import torch

from ..optics.telescope import DETECTOR, MIRROR, REFRACT_IN, REFRACT_OUT
from ..photons import diffraction as D
from ..photons.optics_ops import OpticsContext, field_to_sensor_plain \
    as _chain_plain
from ..sensor.silicon import (absorption_cheb, absorption_length_poly,
                              depth_diffusion_displace)
from . import _build

MAX_SURF = 16
TEL_W = 20           # the telescope's surface matrix: 16 + N_COEF (4)
SURF_W = 26          # the kernel's folded per-surface block (below)
N_ABS = 29
MAX_NEWTON = 3       # NEWTON_POLISH + 2 on an asphere


class ChainParams(ctypes.Structure):
    """Mirror of `struct ChainParams` in csrc/raychain.cu (all 4-byte
    fields, no padding; the sizes are checked against the library).
    `surf` holds per surface: c, 1 + kappa, (1 + kappa) c^2,
    (1 + kappa) c^2 / 2, a_i (4), (i + 2) a_i (4), ap_lo^2 (-1 when
    ap_lo <= 0), ap_hi^2, vertex (3), rotation (9)."""

    _fields_ = [
        ("surf", ctypes.c_float * (MAX_SURF * SURF_W)),
        ("kinds", ctypes.c_int * MAX_SURF),
        ("newton", ctypes.c_int * MAX_SURF),
        ("n_surf", ctypes.c_int),
        ("apply_dcr", ctypes.c_int),
        ("apply_diffr", ctypes.c_int),
        ("field_rotation", ctypes.c_int),
        ("fused", ctypes.c_int),
        ("bore_alt", ctypes.c_float), ("j01", ctypes.c_float),
        ("j11", ctypes.c_float), ("k1_ref", ctypes.c_float),
        ("k2_ref", ctypes.c_float),
        ("air_p_mbar", ctypes.c_float), ("air_f1", ctypes.c_float),
        ("air_f2", ctypes.c_float), ("air_f3", ctypes.c_float),
        ("air_w_mbar", ctypes.c_float),
        ("crot", ctypes.c_float), ("srot", ctypes.c_float),
        ("cl", ctypes.c_float), ("sl", ctypes.c_float),
        ("fx", ctypes.c_float), ("fy", ctypes.c_float),
        ("fz", ctypes.c_float), ("h0x", ctypes.c_float),
        ("h0y", ctypes.c_float), ("h0z", ctypes.c_float),
        ("n_h0", ctypes.c_float),
        ("det_cx_mm", ctypes.c_float), ("det_cy_mm", ctypes.c_float),
        ("det_crot", ctypes.c_float), ("det_srot", ctypes.c_float),
        ("det_ox", ctypes.c_float), ("det_oy", ctypes.c_float),
        ("thick_um", ctypes.c_float), ("pix_um", ctypes.c_float),
        ("diff_um", ctypes.c_float),
        ("abs_cheb", ctypes.c_float * N_ABS),
    ]


def surface_block(tel) -> np.ndarray:
    """(S, SURF_W) float32: each surface's constants folded in float64,
    then rounded once (the plain twin folds the same python-float
    subexpressions, e.g. (1 + kappa) c^2, before they meet a tensor)."""
    S, K = len(tel.kinds), tel.n_coef
    m = tel.surf.astype(np.float64)
    c, kappa, coefs = m[:, 0], m[:, 1], m[:, 2:2 + K]
    ap_lo, ap_hi = m[:, 2 + K], m[:, 3 + K]
    k1 = 1.0 + kappa
    blk = np.concatenate([
        c[:, None], k1[:, None], (k1 * c * c)[:, None],
        (c * c * k1 * 0.5)[:, None], coefs,
        coefs * np.arange(2, K + 2, dtype=np.float64),
        np.where(ap_lo > 0, ap_lo * ap_lo, -1.0)[:, None],
        (ap_hi * ap_hi)[:, None], m[:, 4 + K:16 + K]], axis=1)
    assert blk.shape == (S, SURF_W)
    return blk.astype(np.float32)


def chain_params(tel, ctx: OpticsContext, apply_dcr: bool,
                 apply_diffraction: bool, field_rotation: bool,
                 silicon=None) -> ChainParams:
    """Pack the telescope, the visit scalars and the silicon statics.
    Visit-constant subexpressions are evaluated once here in float64,
    then rounded to float32 (the reference folds the same python-float
    subexpressions at trace time)."""
    S = len(tel.kinds)
    if tel.surf.dtype != np.float32:
        raise ValueError(f"the chain reads the float32 surface matrix, not "
                         f"{tel.surf.dtype} (TelescopeDesign.matrix())")
    newton = [tel.newton_steps(i) for i in range(S)]
    if S > MAX_SURF or tel.surf.shape[1] != TEL_W \
            or not all(1 <= n <= MAX_NEWTON for n in newton):
        raise ValueError(f"telescope {tel.surf.shape} (Newton steps "
                         f"{newton}) exceeds the kernel's {MAX_SURF} "
                         f"surfaces of width {TEL_W}, 1-{MAX_NEWTON} steps")
    p = ChainParams()
    surf = np.zeros((MAX_SURF, SURF_W), np.float32)
    surf[:S] = surface_block(tel)
    p.surf[:] = surf.ravel().tolist()
    p.kinds[:S] = [int(k) for k in tel.kinds]
    p.newton[:S] = newton
    p.n_surf = S
    p.apply_dcr = int(apply_dcr)
    p.apply_diffr = int(apply_diffraction)
    p.field_rotation = int(field_rotation)
    p.fused = int(silicon is not None)
    p.bore_alt, p.j01, p.j11 = ctx.bore_alt, ctx.j01, ctx.j11
    p.k1_ref, p.k2_ref = ctx.k1_ref, ctx.k2_ref
    # air_index_excess weather factors (optics.geometry)
    p_mbar = ctx.pressure_kpa * 10.0
    t_c = ctx.temperature_k - 273.15
    p.air_p_mbar = p_mbar
    p.air_f1 = 1.0 + (1.049 - 0.0157 * t_c) * 1e-6 * p_mbar
    p.air_f2 = 720.883 * (1.0 + 0.003661 * t_c)
    p.air_f3 = 1.0 + 0.003661 * t_c
    p.air_w_mbar = ctx.h2o_kpa * 10.0
    p.crot, p.srot = ctx.crot, ctx.srot
    fr = D.field_rotation_frame(ctx.latitude, ctx.bore_alt, ctx.bore_az)
    for k in ("cl", "sl", "fx", "fy", "fz", "h0x", "h0y", "h0z", "n_h0"):
        setattr(p, k, fr[k])
    p.det_cx_mm, p.det_cy_mm = ctx.det_cx_mm, ctx.det_cy_mm
    p.det_crot, p.det_srot = ctx.det_crot, ctx.det_srot
    p.det_ox = (ctx.det_nx - 1) / 2.0
    p.det_oy = (ctx.det_ny - 1) / 2.0
    if silicon is not None:
        p.thick_um = silicon.thickness_um
        p.pix_um = silicon.pixel_um
        p.diff_um = silicon.diffusion_um
        p.abs_cheb[:] = absorption_cheb().tolist()
    return p


def stage_ops() -> dict:
    """Operations per photon of each stage of csrc/raychain.cu, from the
    `ops[stage] = n` notes beside the code they count (the counting rule
    is in the source's header)."""
    with open(os.path.join(_build.CSRC, "raychain.cu")) as f:
        return {k: int(v) for k, v in
                re.findall(r"ops\[(\w+)\] = (\d+)", f.read())}


def chain_flops(p: ChainParams) -> int:
    """Operations per photon of the CUDA chain for the packed `p` (its
    surface kinds, Newton counts and stage flags).  Per surface:
    to_local + root + steps * (newton [+ asphere]) + hit, then (not on
    the detector) normal [+ normal_asphere] + mirror or refract +
    to_global."""
    F = stage_ops()
    n = F["entrance"] + F["silica"] + F["pixels"] + F["slopes"]
    n += F["dcr"] if p.apply_dcr else 0
    if p.apply_diffr:
        n += F["diffraction"] + (F["field_rotation"] if p.field_rotation
                                 else 0)
    n += F["silicon"] if p.fused else 0
    for k in range(p.n_surf):
        steps = p.newton[k]
        n += F["to_local"] + F["root"] + F["hit"] + steps * (
            F["newton"] + (F["asphere"] if steps > 1 else 0))
        kind = p.kinds[k]
        if kind == DETECTOR:
            break
        n += F["normal"] + F["to_global"] + (F["normal_asphere"]
                                             if steps > 1 else 0)
        if kind == MIRROR:
            n += F["mirror"]
        elif kind in (REFRACT_IN, REFRACT_OUT):
            n += F["refract"]
    return n


def field_to_sensor_plain(tel, ctx, thx, thy, pu, pv, wl, t, flux, normal,
                          *, apply_dcr=True, apply_diffraction=True,
                          field_rotation=True, silicon=None,
                          si_draws=None):
    """Plain twin: the optics_ops composition, plus the silicon
    depth/diffusion displacement when `silicon` is given."""
    x, y, dxdz, dydz, f = _chain_plain(
        tel, ctx, thx, thy, pu, pv, wl, t, flux, normal,
        apply_dcr=apply_dcr, apply_diffraction=apply_diffraction,
        field_rotation=field_rotation)
    if silicon is None:
        return x, y, dxdz, dydz, f
    labs = absorption_length_poly(wl)
    return depth_diffusion_displace(
        *si_draws, x, y, dxdz, dydz, f, labs, silicon.thickness_um,
        silicon.pixel_um, silicon.diffusion_um)


def field_to_sensor_cuda(tel, ctx, thx, thy, pu, pv, wl, t, flux, normal,
                         *, apply_dcr=True, apply_diffraction=True,
                         field_rotation=True, silicon=None, si_draws=None):
    """Launch the CUDA kernel: 8 (+3) float32 (N,) inputs, 5 (or 3)
    outputs."""
    n = thx.shape[0]
    ins = [thx, thy, pu, pv, wl, t, flux, normal]
    names = ["thx", "thy", "pupil_u", "pupil_v", "wavelength", "time",
             "flux", "normal"]
    if silicon is not None:
        ins += list(si_draws)
        names += ["u", "g1", "g2"]
    for a, nm in zip(ins, names):
        _build.require(a, nm, (n,))
        if a.device != thx.device:
            raise ValueError(f"{nm}: on {a.device}, thx on {thx.device}")
    lib = _build.library()
    if lib.imsim_chain_params_size() != ctypes.sizeof(ChainParams):
        raise RuntimeError("ChainParams layout differs from the library's")
    fn = lib.imsim_field_to_sensor
    fn.argtypes = [ctypes.c_void_p] * 16 + [
        ctypes.c_longlong, ctypes.POINTER(ChainParams), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    p = chain_params(tel, ctx, apply_dcr, apply_diffraction, field_rotation,
                     silicon)
    n_out = 3 if silicon is not None else 5
    outs = [torch.empty_like(thx) for _ in range(n_out)]
    in_ptrs = [a.data_ptr() for a in ins] + [None] * (11 - len(ins))
    if silicon is not None:
        out_ptrs = [outs[0].data_ptr(), outs[1].data_ptr(), None, None,
                    outs[2].data_ptr()]
    else:
        out_ptrs = [o.data_ptr() for o in outs]
    status = fn(*in_ptrs, *out_ptrs, n, ctypes.byref(p),
                _build.stream_ptr(thx))
    _build.check(status, "field_to_sensor")
    _build.count_launch("field_to_sensor")
    return tuple(outs)


# Agreement of two evaluations of the chain (kernel vs plain twin, or
# the port vs the JAX package).  The spider kick has sigma
# atan(1 / (2 k dist)) ~ 5e-8 m rad / dist, so the f32 rounding of the
# pupil coordinate (~1e-6 m at the 4 m pupil scale) moves a photon by
# kick * 1e-6 m / dist: under 0.05 px only beyond ~2.3 mm from every
# spider edge.  Photons closer than NEAR_EDGE_M (~0.4% of the pupil)
# can also sit at a tie between two edges, where rounding picks either
# edge's normal and flips the kick's direction.  A tie (the two nearest
# edges within diffraction.TIE_M) flips it at any distance.  Both kinds
# are held to a sanity bar of three times their own kick, and the count
# of near-edge photons beyond 10% of the kick is reported.
NEAR_EDGE_M = 3e-3
PIXEL_RAD = 0.2 / 3600 * np.pi / 180    # 0.2 arcsec per 10 um pixel


def chain_gaps(ref, out, ctx, pupil_u, pupil_v, wavelength_nm, time_s,
               normal, apply_diffraction=True, field_rotation=True,
               margin=64) -> dict:
    """Compare two chain outputs (5-tuples, or fused 3-tuples) on the
    photons both land that lie on or within `margin` px of the detector:
    vignette mismatch, largest |dx|, |dy| (and slope) gap away from the
    spider edges and their ties, and near an edge or at a tie the
    largest excess of the gap over three times the photon's own
    diffraction kick."""
    rl, ol = ref[-1] > 0, out[-1] > 0
    x, y = ref[0], ref[1]
    on = rl & ol & (x > -margin) & (x < ctx.det_nx + margin) \
        & (y > -margin) & (y < ctx.det_ny + margin)
    tie = torch.zeros_like(on)
    if apply_diffraction:
        rot = (time_s if field_rotation else None, ctx.latitude,
               ctx.bore_alt, ctx.bore_az)
        dist = D.spider_distance(pupil_u, pupil_v, *rot)
        k = 2 * np.pi / (wavelength_nm * 1e-9)
        kick_px = torch.atan(1.0 / (2.0 * k * torch.clamp(dist, min=1e-9))) \
            * normal.abs() / PIXEL_RAD
        near = dist < NEAR_EDGE_M
        far = torch.nonzero(on & ~near)[:, 0]
        two = D.two_nearest_edges(pupil_u[far], pupil_v[far],
                                  None if rot[0] is None else rot[0][far],
                                  *rot[1:])
        tie[far] = (two[1] - two[0]) < D.TIE_M
    else:
        kick_px = torch.zeros_like(x)
        near = torch.zeros_like(on)
    dxy = torch.maximum((out[0] - x).abs(), (out[1] - y).abs())
    kicked = on & (near | tie)
    strict = on & ~near & ~tie
    gaps = dict(landed=float(rl.float().mean()),
                vignette_mismatch=float((rl != ol).float().mean()),
                n_on=int(on.sum()), n_near_edge=int((on & near).sum()),
                n_tie=int(tie.sum()),
                n_near_edge_over_10pct=int(
                    (kicked & (dxy > 0.35 + 0.1 * kick_px)).sum()),
                dxy=float(dxy[strict].max()),
                near_edge_excess=float((dxy - 3.0 * kick_px)[kicked].max())
                if bool(kicked.any()) else 0.0)
    if len(ref) == 5:
        gaps["dslope"] = float(torch.maximum(
            (out[2] - ref[2]).abs(), (out[3] - ref[3]).abs())[strict].max())
    return gaps


def gaps_ok(gaps: dict, fused: bool) -> bool:
    """The bar of tests/test_optics.py: vignette mismatch < 5e-4 (fused
    form < 1e-3), |dx|, |dy| <= 0.35 px, |dslope| <= 5e-4 (away from the
    spider edges and their ties; there 0.35 px + 3 kicks)."""
    return (gaps["vignette_mismatch"] < (1e-3 if fused else 5e-4)
            and gaps["n_on"] > 1000 and gaps["dxy"] <= 0.35
            and gaps["near_edge_excess"] <= 0.35
            and gaps.get("dslope", 0.0) <= 5e-4)


def field_to_sensor(tel, ctx, thx, thy, pu, pv, wl, t, flux, normal, *,
                    apply_dcr=True, apply_diffraction=True,
                    field_rotation=True, silicon=None, si_draws=None):
    """The chain for one photon batch.  Returns (x, y, dxdz, dydz, flux),
    or with `silicon` (x, y, flux) displaced to final positions.  CUDA
    tensors: the kernel; CPU tensors: the plain twin."""
    kw = dict(apply_dcr=apply_dcr, apply_diffraction=apply_diffraction,
              field_rotation=field_rotation, silicon=silicon,
              si_draws=si_draws)
    if thx.is_cuda:
        return field_to_sensor_cuda(tel, ctx, thx, thy, pu, pv, wl, t,
                                    flux, normal, **kw)
    if thx.device.type != "cpu":
        raise ValueError(f"field_to_sensor: unsupported device {thx.device}")
    return field_to_sensor_plain(tel, ctx, thx, thy, pu, pv, wl, t, flux,
                                 normal, **kw)
