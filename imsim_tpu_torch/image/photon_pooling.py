"""Pooled-photon CCD render (imsim_tpu/image/photon_pooling.py
counterpart): classify -> photon->object map -> per batch (rows via K1,
shoot_full with the K2 chain, silicon accumulate with the K3 stencil).

The FFT bright-star branch, checkpointing and the analytic-PSF path are
ROADMAP queue A items; a config that asks for them raises
NotImplementedError.  Batch sizes, slot layouts and the
photon->object assignment are identical to the JAX package's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.scanrows import align_batch, scan_slot_prefix
from ..sensor.silicon import SiliconParams, accumulate_silicon
from ..sensor.simple import accumulate
from ..utils.rng import stream
from . import render
from .scene import COL_TYPE, SceneHost

FFT, PHOT, FAINT = 0, 1, 2


@dataclasses.dataclass
class PoolingConfig:
    """The JAX package's PoolingConfig fields that the pooled photon
    pass reads (same names and defaults)."""

    xsize: int = 4096
    ysize: int = 4096
    exptime: float = 30.0
    nbatch: int = 8
    batch_size: int = 8_000_000
    nsub: int = 4
    faint_thresh: float = 100.0
    fft_sb_thresh: float = 0.0
    pupil_pairing: int = 4
    screen_share: int = 4
    chromatic_exponent: float = -0.3
    wl_ref: float = 622.0
    apply_dcr: bool = True
    apply_diffraction: bool = True
    diffraction_field_rotation: bool = True
    force_fft: bool = False


def classify_objects(host: SceneHost, cfg: PoolingConfig) -> np.ndarray:
    """Mode partition without the FFT branch: FAINT below faint_thresh
    photons, PHOT otherwise."""
    if cfg.force_fft or cfg.fft_sb_thresh > 0:
        raise NotImplementedError(
            "the FFT bright-star branch is not ported yet (ROADMAP queue A: "
            "FFT branch); render with fft_sb_thresh=0 and force_fft=False")
    modes = np.full(host.n_objects, PHOT, np.int8)
    modes[host.flux[:host.n_objects] < cfg.faint_thresh] = FAINT
    return modes


def pick_nbatch(total: int, cfg: PoolingConfig) -> int:
    """Copy of imsim_tpu's pick_nbatch: enough batches that each fits
    batch_size, at least cfg.nbatch when there are photons for it."""
    need = max(-(-total // cfg.batch_size), 1)
    return max(need, min(cfg.nbatch, max(total, 1)))


def member_offsets(pair: int, share: int) -> np.ndarray:
    """Ordinal offsets of the two-level block layout's members (copy of
    imsim_tpu's member_offsets): slot block beta = h*share + r holds
    ordinals j = (pair*share)*q + pair*r + h."""
    return np.array([pair * r + h
                     for h in range(pair) for r in range(share)], np.int32)


def pooled_plan(host: SceneHost, modes, cfg: PoolingConfig):
    """Per-object cumulative counts (FFT-mode objects excluded), total
    photons, batch count and padded batch size (copy of imsim_tpu's
    pooled_plan).  Returns (cum int32 (scene.n,), total, nb, batch_size)."""
    sel = np.asarray(modes) != FFT
    counts = np.where(sel, host.flux[:host.n_objects], 0).astype(np.int64)
    total = int(counts.sum())
    if total >= 2 ** 31:
        raise ValueError(
            f"visit photon total {total:.3e} exceeds the int32 pooled-"
            f"pass capacity (2.1e9 photons/CCD); check catalog "
            f"normalization or split the exposure into snaps")
    pair = max(cfg.pupil_pairing, 1)
    share = max(cfg.screen_share, 1) if pair > 1 else 1
    nb = pick_nbatch(total, cfg) if total > 0 else 1
    batch_size = int(np.ceil(max(total, 1) / nb))
    batch_size = -(-batch_size // (pair * share)) * (pair * share)
    batch_size = align_batch(batch_size, pair, share)
    cum = np.zeros(host.scene.n, np.int32)
    if host.n_objects:
        cum[:host.n_objects] = np.cumsum(counts)
        cum[host.n_objects:] = cum[host.n_objects - 1]
    return cum, total, nb, batch_size


def build_obj_map(cum: torch.Tensor, total: int, nb: int, batch_size: int,
                  pair: int = 1, share: int = 1) -> torch.Tensor:
    """(batch_size, nb) int32 photon->object map for the whole visit:
    object i's first global photon receives i (scatter-max), a running
    max fills the gaps; then the two-level slot relayout."""
    n_total = batch_size * nb
    n_obj = cum.shape[0]
    starts = torch.cat([cum.new_zeros(1), cum[:-1]]).to(torch.int64)
    keep = starts < n_total
    marks = torch.zeros(n_total, dtype=torch.int32, device=cum.device)
    marks.scatter_reduce_(
        0, starts[keep],
        torch.arange(n_obj, dtype=torch.int32, device=cum.device)[keep],
        reduce="amax")
    obj_flat = torch.cummax(marks, dim=0).values
    g = torch.arange(n_total, device=cum.device)
    obj_flat = torch.where(g < total, obj_flat, n_obj - 1).to(torch.int32)
    if pair == 1 and share == 1:
        return obj_flat.reshape(batch_size, nb)
    mp = batch_size // (pair * share)
    return obj_flat.reshape(mp, share, pair, nb).permute(
        2, 1, 0, 3).reshape(batch_size, nb)


def batch_from_obj_map(obj_map: torch.Tensor, total: int, b: int, nb: int,
                       batch_size: int, pair: int = 1, share: int = 1):
    """Batch b's (obj_idx, weight): one column of the visit map and the
    alive test on each slot's global photon index."""
    obj = obj_map[:, b].contiguous()
    dev = obj_map.device
    if pair == 1 and share == 1:
        s = torch.arange(batch_size, device=dev)
        alive = (b + nb * s) < total
    else:
        pe = pair * share
        mp = batch_size // pe
        q = torch.arange(mp, device=dev)
        off = torch.as_tensor(member_offsets(pair, share), device=dev)
        j = (pe * q)[None, :] + off[:, None]
        alive = (b + nb * j.reshape(batch_size)) < total
    return obj, alive.to(torch.float32)


def _first_ordinals(cum: torch.Tensor, b: int, nb: int) -> torch.Tensor:
    """First photon ordinal of each object within batch b (objects
    wholly before the batch telescope into ordinal 0)."""
    starts = torch.cat([cum.new_zeros(1), cum[:-1]]).to(torch.int64)
    return torch.clamp(-torch.div(b - starts, nb, rounding_mode="floor"),
                       min=0)


def _deltas(params: torch.Tensor) -> torch.Tensor:
    return params - torch.cat([params.new_zeros((1, params.shape[1])),
                               params[:-1]])


def materialize_rows(params: torch.Tensor, cum: torch.Tensor, b: int,
                     nb: int, batch_size: int, pair: int = 1,
                     share: int = 1) -> torch.Tensor:
    """(batch_size, C) per-photon parameters without a row gather:
    scatter each object's delta row at its first ordinal of batch b,
    cumsum in ordinal order, relayout to the slot order (the plain
    reference of materialize_rows_T)."""
    C = params.shape[1]
    j0 = _first_ordinals(cum, b, nb)
    keep = j0 < batch_size
    rows = torch.zeros((batch_size, C), dtype=params.dtype,
                       device=params.device)
    rows.index_add_(0, j0[keep], _deltas(params)[keep])
    rows = torch.cumsum(rows, dim=0)
    pe = pair * share
    if pe == 1:
        return rows
    mp = batch_size // pe
    return rows.reshape(mp, share, pair, C).permute(2, 1, 0, 3).reshape(
        batch_size, C)


def slot_deltas(params: torch.Tensor, cum: torch.Tensor, b: int, nb: int,
                batch_size: int, pair: int = 1,
                share: int = 1) -> torch.Tensor:
    """(C, pe, mp) slot planes holding each object's delta row at the
    slot of its first photon ordinal in batch b (deltas of objects that
    start past the batch are dropped)."""
    C = params.shape[1]
    pe = pair * share
    mp = batch_size // pe
    j0 = _first_ordinals(cum, b, nb)
    q = torch.div(j0, pe, rounding_mode="floor")
    keep = q < mp
    mu = j0[keep] % pe
    beta = (mu % pair) * share + torch.div(mu, pair, rounding_mode="floor")
    d = torch.zeros((C, pe * mp), dtype=params.dtype, device=params.device)
    d.index_add_(1, beta * mp + q[keep], _deltas(params)[keep].T)
    return d.reshape(C, pe, mp)


def materialize_rows_T(params: torch.Tensor, cum: torch.Tensor, b: int,
                       nb: int, batch_size: int, pair: int = 1,
                       share: int = 1) -> torch.Tensor:
    """materialize_rows in the photon-minor slot layout (C, batch_size):
    the object deltas are scattered straight into the slot planes and K1
    resolves the ordinal-order prefix."""
    d = slot_deltas(params, cum, b, nb, batch_size, pair, share)
    return scan_slot_prefix(d, pair, share).reshape(params.shape[1],
                                                    batch_size)


def render_ccd_pooled(seed: int, host: SceneHost, cfg: PoolingConfig,
                      silicon: SiliconParams | None = None, tel=None,
                      ctx=None, screens=None, sk_table=None, *,
                      profiles, tally: dict | None = None):
    """Render one CCD eimage on the scene's device through the full
    optics chain (render.shoot_full) and, with `silicon`, the silicon
    sensor (else the ideal binner).  Returns (image, modes); the JAX
    package's per-object realized-flux tracking is not ported.

    profiles: the intrinsic-profile samplers (photons.profiles.
    ProfileTables).  tally: optional dict that receives "in_frame" (the
    flux binned inside the frame) and "pooled" (photons shot), as
    float64 device scalars."""
    if tel is None or ctx is None:
        raise NotImplementedError(
            "the analytic-PSF path (render.shoot) is not ported yet "
            "(ROADMAP queue A); pass tel and ctx")
    dev = host.scene.device
    modes = classify_objects(host, cfg)
    image = torch.zeros((cfg.ysize, cfg.xsize), dtype=torch.float32,
                        device=dev)
    cum, total, nb, batch_size = pooled_plan(host, modes, cfg)
    if total == 0:
        return image, modes
    pair = cfg.pupil_pairing
    share = max(cfg.screen_share, 1) if pair > 1 else 1
    cum_dev = torch.as_tensor(cum, device=dev)
    obj_map = build_obj_map(cum_dev, total, nb, batch_size, pair, share)
    mat = torch.cat([host.scene.params, host.scene.wl_cheb], dim=1)
    # static tree-ring field, once per CCD, folded into every batch's
    # continuity update; the depth/diffusion displacement then fuses
    # into the K2 chain
    tr_field = None
    if silicon is not None and silicon.tr_active:
        from ..sensor.silicon import tree_ring_field
        tr_field = tree_ring_field(silicon, (cfg.ysize, cfg.xsize), dev)
    families = tuple(sorted(set(
        host.scene.params[:host.n_objects, COL_TYPE].to(torch.int64)
        .tolist())))
    for b in range(nb):
        image = _pooled_batch_step(
            stream(seed, "photons", b, device=dev),
            stream(seed, "si", b, device=dev), obj_map, cum_dev, mat, total,
            b, nb, batch_size, tel, ctx, screens, sk_table, silicon, image,
            cfg, pair, share, tr_field, families, profiles, tally)
    return image, modes


def _pooled_batch_step(gen, si_gen, obj_map, cum, mat, total, b, nb,
                       batch_size, tel, ctx, screens, sk_table, silicon,
                       image, cfg: PoolingConfig, pair, share, tr_field,
                       families, profiles, tally):
    obj_idx, weight = batch_from_obj_map(obj_map, total, b, nb, batch_size,
                                         pair, share)
    row = materialize_rows_T(mat, cum, b, nb, batch_size, pair, share)
    photons = render.shoot_full(
        gen, row, obj_idx, weight, tel, ctx, profiles, families,
        screens=screens, sk_table=sk_table, exptime=cfg.exptime,
        pupil_pairing=pair, screen_share=share,
        chromatic_exponent=cfg.chromatic_exponent, wl_ref=cfg.wl_ref,
        apply_dcr=cfg.apply_dcr, apply_diffraction=cfg.apply_diffraction,
        diffraction_field_rotation=cfg.diffraction_field_rotation,
        silicon=silicon, si_gen=si_gen)
    if tally is not None:
        tally["pooled"] = tally.get("pooled", 0.0) \
            + weight.sum(dtype=torch.float64)
    if silicon is not None:
        return accumulate_silicon(photons, image, silicon, nsub=cfg.nsub,
                                  tr_field=tr_field, tally=tally)
    return accumulate(photons, image, tally)
