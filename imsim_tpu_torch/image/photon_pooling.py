"""Pooled-photon CCD render (imsim_tpu/image/photon_pooling.py
counterpart): classify -> FFT pass (bright stars and galaxies) ->
photon->object map -> per batch (rows via K1, shoot_full with the K2
chain, silicon accumulate with the K3 stencil).

Checkpointing and the analytic-PSF path are ROADMAP queue A items; a
config that asks for the analytic PSF raises NotImplementedError.
Batch sizes, slot layouts, the photon->object assignment and the FFT
branch's stamp sizes and buckets are identical to the JAX package's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.scanrows import align_batch, scan_slot_prefix
from ..sensor.silicon import SiliconParams, accumulate_silicon
from ..sensor.simple import accumulate
from ..utils.rng import poisson_approx, stream
from . import fft_render as F
from . import render
from .render import KNOTS, POINT, SERSIC
from .scene import (COL_G1, COL_G2, COL_MU, COL_P0, COL_P1, COL_P2, COL_P3,
                    COL_TYPE, COL_X, COL_Y, SceneHost)

FFT, PHOT, FAINT = 0, 1, 2


@dataclasses.dataclass
class PoolingConfig:
    """The JAX package's PoolingConfig fields that the pooled photon
    pass and the FFT branch read (same names and defaults)."""

    xsize: int = 4096
    ysize: int = 4096
    exptime: float = 30.0
    nbatch: int = 8
    batch_size: int = 8_000_000
    nsub: int = 4
    faint_thresh: float = 100.0
    fft_sb_thresh: float = 0.0    # e-/pixel peak; 0 disables the FFT branch
    pixel_scale: float = 0.2
    fwhm: float = 0.8
    gauss_fwhm: float = 0.3
    pupil_pairing: int = 4
    screen_share: int = 4
    chromatic_exponent: float = -0.3
    wl_ref: float = 622.0
    # per-pixel noise variance (sky counts): the stamp-sizing folding
    # threshold noise_var / flux
    noise_var: float = 0.0
    apply_dcr: bool = True
    apply_diffraction: bool = True
    diffraction_field_rotation: bool = True
    # render every FFT-capable object through the Fourier branch
    force_fft: bool = False


def classify_objects(host: SceneHost, cfg: PoolingConfig,
                     psf_mtf=None) -> np.ndarray:
    """Mode partition: FAINT below faint_thresh photons, FFT above the
    predicted peak surface brightness fft_sb_thresh (extended objects at
    their peak after convolution with the PSF), PHOT otherwise; with
    force_fft every non-faint point, Sersic or knot object is FFT."""
    n = host.n_objects
    modes = np.full(n, PHOT, np.int8)
    modes[host.flux[:n] < cfg.faint_thresh] = FAINT
    if not cfg.force_fft and not (cfg.fft_sb_thresh > 0
                                  and psf_mtf is not None):
        return modes
    params = host.scene.params[:n].cpu().numpy()
    obj_type = params[:, COL_TYPE].astype(np.int32)
    if cfg.force_fft:
        capable = ((obj_type == POINT) | (obj_type == SERSIC)
                   | (obj_type == KNOTS))
        modes[(modes == PHOT) & capable] = FFT
        return modes
    peak = F.peak_surface_brightness(host.flux[:n], psf_mtf, cfg.pixel_scale)
    cand = peak > cfg.fft_sb_thresh
    modes[cand & (obj_type == POINT)] = FFT
    for i in np.nonzero(cand & ((obj_type == SERSIC)
                                | (obj_type == KNOTS)))[0]:
        n_s = 1.0 if obj_type[i] == KNOTS else params[i, COL_P1]
        fac = F.galaxy_peak_factor(psf_mtf, n_s, params[i, COL_P0])
        if peak[i] * fac > cfg.fft_sb_thresh:
            modes[i] = FFT
    return modes


def make_psf_mtf(cfg: PoolingConfig):
    """PSF MTF table of the FFT branch (None when it is disabled)."""
    if cfg.fft_sb_thresh <= 0:
        return None
    r0_500 = 0.9758834 * 500e-9 / (cfg.fwhm * np.pi / 180 / 3600)
    return F.psf_mtf_table(622.0, r0_500, gauss_fwhm=cfg.gauss_fwhm)


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
                      profiles, spikes=None, track_realized: bool = False,
                      fft_vign=None, tally: dict | None = None):
    """Render one CCD eimage on the scene's device: the FFT pass over
    the bright objects, then the pooled photons through the full optics
    chain (render.shoot_full) and, with `silicon`, the silicon sensor
    (else the ideal binner).  Returns (image, modes, realized): realized
    (scene.n,) float64 numpy holds the FFT pass's per-object flux and,
    with track_realized, each object's pooled photon flux through the
    optics.

    profiles: the intrinsic-profile samplers (photons.profiles.
    ProfileTables).  spikes: dict(kernel=(n, n), sat=full well) for the
    saturation spike overlay of FFT objects; fft_vign: (n_objects,)
    vignetting factor of the FFT flux.  tally: optional dict that
    receives "fft" (the charge the FFT pass added), "in_frame" (the
    pooled flux binned inside the frame) and "pooled" (photons shot), as
    float64 device scalars."""
    if tel is None or ctx is None:
        raise NotImplementedError(
            "the analytic-PSF path (render.shoot) is not ported yet "
            "(ROADMAP queue A); pass tel and ctx")
    dev = host.scene.device
    psf_mtf = make_psf_mtf(cfg)
    modes = classify_objects(host, cfg, psf_mtf)
    image = torch.zeros((cfg.ysize, cfg.xsize), dtype=torch.float32,
                        device=dev)
    realized = torch.zeros(host.scene.n, dtype=torch.float64, device=dev)
    if np.any(modes == FFT):
        image, realized[:host.n_objects] = _fft_pass(
            image, host, modes, cfg, psf_mtf, seed, spikes=spikes,
            vign=fft_vign)
    if tally is not None:
        # the pass runs on an empty frame: its sum is what it added
        tally["fft"] = image.sum(dtype=torch.float64)
    cum, total, nb, batch_size = pooled_plan(host, modes, cfg)
    if total == 0:
        return image, modes, realized.cpu().numpy()
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
            cfg, pair, share, tr_field, families, profiles, tally,
            realized if track_realized else None)
    return image, modes, realized.cpu().numpy()


def _pooled_batch_step(gen, si_gen, obj_map, cum, mat, total, b, nb,
                       batch_size, tel, ctx, screens, sk_table, silicon,
                       image, cfg: PoolingConfig, pair, share, tr_field,
                       families, profiles, tally, realized):
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
    if realized is not None:
        # per-object flux through the optics (the reference's pooled
        # truth accumulation): one scatter per batch
        realized.index_add_(0, obj_idx, photons.flux.to(torch.float64))
    if tally is not None:
        tally["pooled"] = tally.get("pooled", 0.0) \
            + weight.sum(dtype=torch.float64)
    if silicon is not None:
        return accumulate_silicon(photons, image, silicon, nsub=cfg.nsub,
                                  tr_field=tr_field, tally=tally)
    return accumulate(photons, image, tally)


# ---- the FFT pass ---------------------------------------------------------

@dataclasses.dataclass
class StarInputs:
    """star_field's inputs for the FFT-mode stars of a CCD (host values;
    flux, x, y float32 numpy)."""

    ids: np.ndarray
    cheb: np.ndarray
    k_max: float
    flux: np.ndarray
    x: np.ndarray
    y: np.ndarray
    kernel: np.ndarray | None
    sat: float
    Npad: int
    pad: int
    margin: int

    def args(self, device):
        """star_field's positional arguments up to Npad."""
        def t(a):
            return torch.as_tensor(a, device=device)

        return (self.cheb, self.k_max, t(self.flux), t(self.x), t(self.y),
                self.kernel, self.sat)


@dataclasses.dataclass
class GalaxyBucket:
    """One stamp bucket of FFT-mode galaxies: stamp size N, Sersic index,
    object ids, stamp corners and render_fft_stamps's inputs (numpy)."""

    N: int
    n_s: float
    ids: np.ndarray
    x0: np.ndarray
    y0: np.ndarray
    flux: np.ndarray
    sub_dx: np.ndarray
    sub_dy: np.ndarray
    gal_A: np.ndarray


def fft_plan(host: SceneHost, modes, cfg: PoolingConfig, psf_mtf,
             spikes=None, vign=None):
    """Host bookkeeping of the FFT pass: (StarInputs or None, galaxy
    buckets in the reference's order).  Stamps sit at the objects' pixel
    positions (host.pix_x/y; else COL_X/COL_Y)."""
    if psf_mtf is None:
        raise ValueError("the FFT pass needs the PSF MTF: set fft_sb_thresh "
                         "> 0 (force_fft alone leaves it unset)")
    n = host.n_objects
    idx = np.nonzero(np.asarray(modes) == FFT)[0]
    params = host.scene.params[:n].cpu().numpy()
    if host.pix_x is not None:
        xs_all = np.asarray(host.pix_x, float)
        ys_all = np.asarray(host.pix_y, float)
    else:
        xs_all = params[:, COL_X].astype(float)
        ys_all = params[:, COL_Y].astype(float)
    obj_type = params[:, COL_TYPE].astype(np.int32)
    flux = host.flux[:n].astype(np.float64)
    if vign is not None:
        flux = flux * np.asarray(vign, float)
    H, W = cfg.ysize, cfg.xsize
    is_gal = (obj_type == SERSIC) | (obj_type == KNOTS)
    stars = None
    star_ids = idx[~is_gal[idx]]
    if len(star_ids):
        pad = max(F.stamp_bucket(flux[i], psf_mtf, cfg.pixel_scale,
                                 noise_var=cfg.noise_var)
                  for i in star_ids) // 2
        kern, sat, margin = None, 0.0, 0
        if spikes is not None:
            kern = np.asarray(spikes["kernel"], np.float32)
            sat = float(spikes["sat"])
            margin = kern.shape[0] // 2
        pad = max(pad, margin)
        # the fit residual (~1.3e-4) is the Airy table's own radial
        # binning jitter
        cheb, k_max, cheb_err = F.mtf_cheb(psf_mtf)
        if not cheb_err < 5e-4:
            raise ValueError(f"PSF MTF Chebyshev fit error {cheb_err}")
        stars = StarInputs(
            ids=star_ids, cheb=cheb, k_max=float(np.float32(k_max)),
            flux=flux[star_ids].astype(np.float32),
            x=np.clip(xs_all[star_ids], -pad, W - 1 + pad).astype(
                np.float32),
            y=np.clip(ys_all[star_ids], -pad, H - 1 + pad).astype(
                np.float32),
            kernel=kern, sat=float(np.float32(sat)),
            Npad=F.good_fft_size(max(H, W) + 2 * pad), pad=pad,
            margin=margin)

    groups: dict[tuple, list[int]] = {}
    for i in idx[is_gal[idx]]:
        n_s = 1.0 if obj_type[i] == KNOTS else round(float(params[i, COL_P1]),
                                                     1)
        mtf_i = F.combined_mtf_table(psf_mtf, F.sersic_mtf_table(n_s),
                                     gal_scale=float(params[i, COL_P0]))
        N = F.stamp_bucket(flux[i], mtf_i, cfg.pixel_scale,
                           noise_var=cfg.noise_var)
        groups.setdefault((N, n_s), []).append(i)
    buckets = []
    for (N, n_s), ids in sorted(groups.items(),
                                key=lambda kv: (kv[0][0], str(kv[0][1]))):
        ids = np.asarray(ids)
        xs, ys = xs_all[ids], ys_all[ids]
        p = params[ids]
        buckets.append(GalaxyBucket(
            N=N, n_s=n_s, ids=ids,
            x0=np.clip(np.floor(xs).astype(int) - N // 2, -N, W),
            y0=np.clip(np.floor(ys).astype(int) - N // 2, -N, H),
            flux=flux[ids].astype(np.float32),
            sub_dx=(xs - np.floor(xs)).astype(np.float32),
            sub_dy=(ys - np.floor(ys)).astype(np.float32),
            gal_A=F.lens_matrix(p[:, COL_P2], p[:, COL_P3], p[:, COL_G1],
                                p[:, COL_G2], p[:, COL_MU],
                                p[:, COL_P0]).astype(np.float32)))
    return stars, buckets


def galaxy_stamps(bucket: GalaxyBucket, psf_mtf, cfg: PoolingConfig,
                  spikes=None, device="cuda") -> torch.Tensor:
    """The noiseless (B, N, N) stamps of one bucket on `device`: PSF x
    galaxy MTF synthesis, negatives clipped, spike overlay."""
    from .diffraction_fft import apply_spikes

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    B = len(bucket.ids)
    gt = F.sersic_mtf_table(bucket.n_s)
    stamps = F.render_fft_stamps(
        t(psf_mtf.y).expand(B, -1), t(np.full(B, psf_mtf.dx)),
        t(bucket.flux), t(np.ones(B)), t(np.zeros(B)), t(bucket.sub_dx),
        t(bucket.sub_dy), bucket.N, cfg.pixel_scale,
        gal_y=t(gt.y).expand(B, -1).contiguous(), gal_dx=float(gt.dx),
        gal_A=t(bucket.gal_A))
    # FFT numerics ring negative
    stamps = torch.clamp(stamps, min=0.0)
    if spikes is not None:
        stamps = apply_spikes(stamps, spikes["kernel"],
                              float(np.float32(spikes["sat"])))
    return stamps


def _fft_pass(image, host: SceneHost, modes, cfg, psf_mtf, seed: int,
              spikes=None, vign=None):
    """Render all FFT-mode objects into `image` on its device: the stars
    in one Fourier synthesis (fft_render.star_field_pass), the galaxies
    bucketed by stamp size (batched stamps -> clip -> spikes -> Poisson
    -> slice adds).  Noise streams derive from the visit seed: bucket 0
    of "fftnoise" is the star field's, 1 + i the i-th galaxy bucket's.

    Returns (image, realized (n_objects,) float64 on the device): the
    stars' expected in-frame flux, the galaxies' stamp sums after
    noise."""
    dev = image.device
    H, W = image.shape
    realized = torch.zeros(host.n_objects, dtype=torch.float64, device=dev)
    stars, buckets = fft_plan(host, modes, cfg, psf_mtf, spikes, vign)
    if stars is not None:
        image, r_star = F.star_field_pass(
            image, *stars.args(dev), stream(seed, "fftnoise", 0, device=dev),
            stars.Npad, H, W, stars.pad, cfg.pixel_scale, stars.margin)
        realized[torch.as_tensor(stars.ids, device=dev)] = r_star.to(
            torch.float64)
    for bucket_i, bucket in enumerate(buckets):
        stamps = poisson_approx(
            stream(seed, "fftnoise", 1 + bucket_i, device=dev),
            galaxy_stamps(bucket, psf_mtf, cfg, spikes, dev))
        realized[torch.as_tensor(bucket.ids, device=dev)] = stamps.sum(
            dim=(1, 2), dtype=torch.float64)
        image = F.add_stamps(image, stamps, bucket.x0, bucket.y0)
    return image, realized
