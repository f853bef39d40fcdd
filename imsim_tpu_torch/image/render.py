"""Pooled photon shooting through the full physics chain
(imsim_tpu/image/render.py counterpart: `sample_intrinsic` and
`shoot_full`; the analytic-PSF `shoot` is a ROADMAP queue A item).

Per batch: intrinsic profile + lensing offsets -> Chebyshev wavelength
-> block-paired pupil/time draws -> phase-screen first kick -> second
kick -> fused DCR/diffraction/ray trace/silicon chain (K2).  All random
numbers come from the batch's generators in a fixed order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..photons import profiles as P
from ..photons.batch import PhotonBatch
from ..utils import rng
from .scene import (COL_G1, COL_G2, COL_MU, COL_P0, COL_P1, COL_P2, COL_P3,
                    COL_TYPE, COL_X, COL_Y, N_COLS)

# object type codes (imsim_tpu.catalog.instcat)
POINT, SERSIC, KNOTS = 0, 1, 2

_U32 = 0xFFFFFFFF


def _lcg(v: torch.Tensor) -> torch.Tensor:
    """One step of the knot LCG, uint32 wraparound in int64."""
    return (v * 1664525 + 1013904223) & _U32


def sample_intrinsic(gen, row, obj_idx, profiles: P.ProfileTables,
                     families):
    """Profile + lensing offsets (arcsec) for a pooled batch.  row:
    (N_COLS+, N) per-photon parameters, photon-minor.  families: the
    object-type codes present; absent families' branches and draws are
    skipped.  Streaks and FITS-stamp clouds are not ported yet."""
    missing = set(families) - {POINT, SERSIC, KNOTS}
    if missing:
        raise NotImplementedError(
            f"object types {sorted(missing)} (streaks, FITS stamps) are not "
            f"ported yet (ROADMAP queue A)")
    n = obj_idx.shape[0]
    if SERSIC not in families and KNOTS not in families:
        z = torch.zeros(n, dtype=row.dtype, device=row.device)
        return z, z

    t = row[COL_TYPE].to(torch.int32)
    hlr_as = row[COL_P0]
    srs_n = row[COL_P1]
    # Sersic radii (knots place on an exponential disk, n = 1)
    srs_n_eff = torch.where(t == KNOTS, 1.0, srs_n) if KNOTS in families \
        else srs_n
    r = P.sample_sersic_poly(rng.uniform(gen, n), srs_n_eff,
                             profiles.sersic) * hlr_as
    theta = rng.uniform(gen, n, 0.0, 2 * np.pi)
    dx = torch.where(t == SERSIC, r * torch.cos(theta), 0.0)
    dy = torch.where(t == SERSIC, r * torch.sin(theta), 0.0)

    if KNOTS in families:
        # deterministic per-(object, knot) position: every batch sees
        # the same knot constellation
        npoints = torch.clamp(srs_n, min=1.0).to(torch.int32)
        pick = (rng.uniform(gen, n) * npoints.to(torch.float32)).to(
            torch.int64)
        knot_seed = (obj_idx.to(torch.int64) * 2654435761
                     + pick * 40503) & _U32
        u1 = _lcg(knot_seed)
        u2 = _lcg(u1)
        fu1 = u1.to(torch.float32) * (1.0 / 4294967296.0)
        fu2 = u2.to(torch.float32) * (1.0 / 4294967296.0)
        kr = profiles.exp_disk(fu1) * hlr_as
        kth = fu2 * (2 * np.pi)
        dx = torch.where(t == KNOTS, kr * torch.cos(kth), dx)
        dy = torch.where(t == KNOTS, kr * torch.sin(kth), dy)

    # intrinsic ellipticity, then lensing, for every extended type
    is_ext = (t == SERSIC) | (t == KNOTS)
    ex, ey = P.apply_ellipse(dx, dy, torch.where(is_ext, row[COL_P2], 1.0),
                             torch.where(is_ext, row[COL_P3], 0.0))
    gx, gy = P.apply_shear_mag(ex, ey, row[COL_G1], row[COL_G2],
                               row[COL_MU])
    return torch.where(is_ext, gx, ex), torch.where(is_ext, gy, ey)


def shoot_full(gen, row, obj_idx, weight, tel, ctx,
               profiles: P.ProfileTables, families, screens=None,
               sk_table=None, exptime: float = 30.0,
               pupil_radius: float = 4.18, pupil_obscuration: float = 0.612,
               pupil_pairing: int = 1, screen_share: int = 1,
               chromatic_exponent: float = 0.0, wl_ref: float = 622.0,
               apply_dcr: bool = True, apply_diffraction: bool = True,
               diffraction_field_rotation: bool = True,
               silicon=None, si_gen=None) -> PhotonBatch:
    """Full physics chain for a pooled batch, in detector pixels with
    in-silicon slopes (or, with `silicon`, final displaced positions).
    row: (N_COLS + WL_CHEB_D, n) per-photon parameters, photon-minor
    (photon_pooling.materialize_rows_T).

    pupil_pairing > 1 is block pairing: slots {s, s+m, ...} (m = n/pair)
    share one pupil/time draw and one screen gather; valid only for the
    pooled block-paired layout (photon_pooling.build_obj_map)."""
    from ..photons.optics_ops import field_to_sensor
    from ..psf.atmosphere import first_kick_angles
    from ..utils.lookup import clenshaw_cols

    arcsec = np.pi / 180 / 3600
    n = obj_idx.shape[0]
    thx = row[COL_X]
    thy = row[COL_Y]

    dx_as, dy_as = sample_intrinsic(gen, row, obj_idx, profiles, families)
    thx = thx + dx_as * arcsec
    thy = thy + dy_as * arcsec

    # wavelength: Chebyshev inverse CDF in the arcsin-stretched variable
    u = rng.uniform(gen, n)
    x_u = torch.asin(2.0 * u - 1.0) * (2.0 / np.pi)
    wl = clenshaw_cols(row[N_COLS:], x_u)

    pair = pupil_pairing if n % pupil_pairing == 0 else 1
    share = screen_share if (pair > 1 and n % (pair * screen_share) == 0) \
        else 1
    m = n // pair

    def blk(x):
        # (m,) -> (n,) block broadcast
        return x.repeat(pair) if pair > 1 else x

    u1 = rng.uniform(gen, m)
    u2 = rng.uniform(gen, m)
    r = torch.sqrt(pupil_obscuration**2 * pupil_radius**2
                   + u1 * (1 - pupil_obscuration**2) * pupil_radius**2)
    a = u2 * 2 * np.pi
    pu_h = r * torch.cos(a)
    pv_h = r * torch.sin(a)
    t_h = rng.uniform(gen, m) * exptime

    if screens is not None:
        ddx, ddy = first_kick_angles(pu_h, pv_h, t_h, screens,
                                     theta_x=thx[:m], theta_y=thy[:m],
                                     share=share)
        if chromatic_exponent:
            # ChromaticAtmosphere: kick *= (lambda / wl_ref)^alpha
            scale = torch.exp(chromatic_exponent * torch.log(wl / wl_ref))
            thx = thx + blk(ddx) * scale
            thy = thy + blk(ddy) * scale
        else:
            thx = thx + blk(ddx)
            thy = thy + blk(ddy)
    pu = blk(pu_h)
    pv = blk(pv_h)
    t = blk(t_h)
    if sk_table is not None:
        skx, sky = P.sample_radial(gen, n, sk_table)  # arcsec
        thx = thx + skx * arcsec
        thy = thy + sky * arcsec

    x_pix, y_pix, dxdz, dydz, flux = field_to_sensor(
        gen, tel, ctx, thx.contiguous(), thy.contiguous(), pu, pv, wl, t,
        weight, apply_dcr=apply_dcr, apply_diffraction=apply_diffraction,
        field_rotation=diffraction_field_rotation, silicon=silicon,
        si_gen=si_gen)
    return PhotonBatch(x=x_pix, y=y_pix, flux=flux, wavelength=wl,
                       dxdz=dxdz, dydz=dydz, pupil_u=pu, pupil_v=pv,
                       time=t)
