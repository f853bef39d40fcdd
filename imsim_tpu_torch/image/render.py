"""Pooled photon shooting (imsim_tpu/image/render.py counterpart):
`sample_intrinsic` for every object family, the analytic-PSF `shoot`
and the full physics chain `shoot_full`.

`shoot` (analytic PSF, positions in pixels): intrinsic profile + lensing
offsets -> Kolmogorov (or tabulated) kick + Gaussian kick -> wavelength
and silicon absorption length gathered from the per-object inverse CDF
tables -> uniform annulus pupil -> uniform arrival time.

`shoot_full`, per batch: intrinsic profile + lensing offsets ->
Chebyshev wavelength -> block-paired pupil/time draws -> phase-screen
first kick -> second kick -> fused DCR/diffraction/ray trace/silicon
chain (K2).

All random numbers come from the batch's generators in a fixed order.
The draws of `sample_intrinsic` and `shoot` are a separate step
(`intrinsic_draws`, `shoot_draws`), so the tests feed the port and the
JAX package the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from ..photons import profiles as P
from ..photons.batch import PhotonBatch
from ..utils import rng
from .scene import (COL_G1, COL_G2, COL_MU, COL_P0, COL_P1, COL_P2, COL_P3,
                    COL_TYPE, COL_X, COL_Y, N_COLS, DeviceScene)

# object type codes (imsim_tpu.catalog.instcat)
POINT, SERSIC, KNOTS, STREAK, FITSIMAGE = 0, 1, 2, 3, 4
ALL_FAMILIES = (POINT, SERSIC, KNOTS, STREAK, FITSIMAGE)

_U32 = 0xFFFFFFFF


def _lcg(v: torch.Tensor) -> torch.Tensor:
    """One step of the knot LCG, uint32 wraparound in int64."""
    return (v * 1664525 + 1013904223) & _U32


def _interp_weights(K: int, u: torch.Tensor):
    """Pair index and weight of linear interpolation at u in a K-point
    table on [0, 1] (the index stays inside the table at u = 1)."""
    f = torch.clamp(u, 0.0, 1.0) * (K - 1.000001)
    j = torch.floor(f).to(torch.int64)
    w = f - j
    return torch.clamp(j, max=K - 2), w


def _interp_rows(table: torch.Tensor, rows: torch.Tensor, u: torch.Tensor):
    """Per-photon linear interpolation into per-object tables: table
    (n_obj, K), rows (N,) object indices, u (N,) in [0, 1]; one gather
    of each photon's (lo, hi) pair."""
    K = table.shape[1]
    pairs = torch.stack([table[:, :-1], table[:, 1:]], dim=-1).reshape(-1, 2)
    j, w = _interp_weights(K, u)
    g = pairs[rows.to(torch.int64) * (K - 1) + j]
    return g[:, 0] * (1 - w) + g[:, 1] * w


def _interp_rows2(table_a: torch.Tensor, table_b: torch.Tensor,
                  rows: torch.Tensor, u: torch.Tensor):
    """_interp_rows of two tables at the same (row, u) with one gather of
    a width-4 row: returns (a(u), b(u)) (the wavelength and its
    absorption length)."""
    K = table_a.shape[1]
    quad = torch.stack([table_a[:, :-1], table_a[:, 1:],
                        table_b[:, :-1], table_b[:, 1:]],
                       dim=-1).reshape(-1, 4)
    j, w = _interp_weights(K, u)
    g = quad[rows.to(torch.int64) * (K - 1) + j]
    return (g[:, 0] * (1 - w) + g[:, 1] * w,
            g[:, 2] * (1 - w) + g[:, 3] * w)


def intrinsic_draws(gen, n: int, families) -> dict:
    """sample_intrinsic's uniforms on [0, 1), in order: the Sersic radius
    and angle (Sersic or knot objects present), the knot / cloud-point
    pick (knots or FITS clouds), the streak box (streaks)."""
    d = {}
    if SERSIC in families or KNOTS in families:
        d["u_r"] = rng.uniform(gen, n)
        d["theta"] = rng.uniform(gen, n, 0.0, 2 * np.pi)
    if KNOTS in families or FITSIMAGE in families:
        d["pick"] = rng.uniform(gen, n)
    if STREAK in families:
        d["box_x"] = rng.uniform(gen, n)
        d["box_y"] = rng.uniform(gen, n)
    return d


def sample_intrinsic(gen, row, obj_idx, profiles: P.ProfileTables,
                     families, pixel_scale: float = 1.0, aux_cloud=None,
                     draws: dict | None = None):
    """Profile + lensing offsets for a pooled batch, in arcsec /
    pixel_scale (arcsec at the default 1).  row: (N_COLS+, N) per-photon
    parameters, photon-minor.  families: the object-type codes present;
    absent families' branches and draws are skipped.  aux_cloud: (M,
    CLOUD_K, 2) FITS-stamp point clouds [arcsec].  draws: the
    intrinsic_draws of this batch (default: drawn from `gen`)."""
    n = obj_idx.shape[0]
    if not set(families) & {SERSIC, KNOTS, STREAK, FITSIMAGE}:
        z = torch.zeros(n, dtype=row.dtype, device=row.device)
        return z, z
    if draws is None:
        draws = intrinsic_draws(gen, n, families)

    t = row[COL_TYPE].to(torch.int32)
    hlr_as = row[COL_P0]
    srs_n = row[COL_P1]
    dx = dy = torch.zeros(n, dtype=row.dtype, device=row.device)
    if SERSIC in families or KNOTS in families:
        # Sersic radii (knots place on an exponential disk, n = 1)
        srs_n_eff = torch.where(t == KNOTS, 1.0, srs_n) \
            if KNOTS in families else srs_n
        r = P.sample_sersic_poly(draws["u_r"], srs_n_eff,
                                 profiles.sersic) * hlr_as
        theta = draws["theta"]
        dx = torch.where(t == SERSIC, r * torch.cos(theta), 0.0)
        dy = torch.where(t == SERSIC, r * torch.sin(theta), 0.0)

    if KNOTS in families:
        # deterministic per-(object, knot) position: every batch sees
        # the same knot constellation
        npoints = torch.clamp(srs_n, min=1.0).to(torch.int32)
        pick = (draws["pick"] * npoints.to(torch.float32)).to(torch.int64)
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

    if STREAK in families:
        # uniform box of length p0 and width p1, rotated by p2
        bx0 = (draws["box_x"] - 0.5) * row[COL_P0]
        by0 = (draws["box_y"] - 0.5) * row[COL_P1]
        bpa = row[COL_P2]
        c, s = torch.cos(bpa), torch.sin(bpa)
        dx = torch.where(t == STREAK, bx0 * c - by0 * s, dx)
        dy = torch.where(t == STREAK, bx0 * s + by0 * c, dy)

    if FITSIMAGE in families and aux_cloud is not None \
            and aux_cloud.shape[0] > 1:
        # one point of the object's cloud (COL_P2 is its index)
        M, Kc = aux_cloud.shape[:2]
        cloud_row = torch.clamp(row[COL_P2].to(torch.int64), 0, M - 1)
        pick_c = (draws["pick"] * Kc).to(torch.int64) % Kc
        g = aux_cloud.reshape(-1, 2)[cloud_row * Kc + pick_c]
        dx = torch.where(t == FITSIMAGE, g[:, 0], dx)
        dy = torch.where(t == FITSIMAGE, g[:, 1], dy)

    # intrinsic ellipticity (Sersic and knots; clouds carry theirs), then
    # lensing for every extended type
    is_ell = (t == SERSIC) | (t == KNOTS)
    ex, ey = P.apply_ellipse(dx, dy, torch.where(is_ell, row[COL_P2], 1.0),
                             torch.where(is_ell, row[COL_P3], 0.0))
    is_lensed = is_ell | (t == FITSIMAGE)
    gx, gy = P.apply_shear_mag(ex, ey, row[COL_G1], row[COL_G2],
                               row[COL_MU])
    return (torch.where(is_lensed, gx, ex) / pixel_scale,
            torch.where(is_lensed, gy, ey) / pixel_scale)


def shoot_draws(gen, n: int, families) -> dict:
    """shoot's random numbers, in order: the intrinsic draws, the PSF
    table's radius and angle, the Gaussian kick's two normals, the
    wavelength uniform, the pupil's two uniforms, the arrival time."""
    d = dict(intrinsic=intrinsic_draws(gen, n, families))
    d["psf_u"] = rng.uniform(gen, n)
    d["psf_theta"] = rng.uniform(gen, n, 0.0, 2 * np.pi)
    d["gauss_x"] = rng.normal(gen, n)
    d["gauss_y"] = rng.normal(gen, n)
    d["wl_u"] = rng.uniform(gen, n)
    d["pupil_u1"] = rng.uniform(gen, n)
    d["pupil_u2"] = rng.uniform(gen, n)
    d["time_u"] = rng.uniform(gen, n)
    return d


def shoot(gen, scene: DeviceScene, obj_idx, weight, psf_tables: dict,
          profiles: P.ProfileTables, exptime: float = 30.0,
          pupil_radius: float = 4.18, pupil_obscuration: float = 0.612,
          pixel_scale: float = 0.2, row=None, families=ALL_FAMILIES,
          draws: dict | None = None) -> PhotonBatch:
    """The analytic-PSF photon batch, in pixels (COL_X/COL_Y hold pixel
    positions).  psf_tables: {"kolmogorov": UniformTable in arcsec with
    its y on the device, "gauss_sigma": float arcsec}.  row: (N_COLS+, N)
    per-photon parameters (default: gathered by obj_idx).  draws: the
    shoot_draws of this batch (default: drawn from `gen`)."""
    n = obj_idx.shape[0]
    if draws is None:
        draws = shoot_draws(gen, n, families)
    if row is None:
        row = scene.params[obj_idx.to(torch.int64)].T
    dx, dy = sample_intrinsic(gen, row, obj_idx, profiles, families,
                              pixel_scale, scene.aux_cloud,
                              draws["intrinsic"])
    kx, ky = P.radial_offsets(psf_tables["kolmogorov"], draws["psf_u"],
                              draws["psf_theta"])
    sigma = psf_tables["gauss_sigma"]
    dx = dx + (kx + sigma * draws["gauss_x"]) / pixel_scale
    dy = dy + (ky + sigma * draws["gauss_y"]) / pixel_scale
    x = row[COL_X] + dx
    y = row[COL_Y] + dy

    # wavelength (+ absorption length) from the per-object inverse CDF
    if scene.labs_icdf is not None:
        wl, labs = _interp_rows2(scene.wl_icdf, scene.labs_icdf, obj_idx,
                                 draws["wl_u"])
    else:
        wl = _interp_rows(scene.wl_icdf, obj_idx, draws["wl_u"])
        labs = None

    # uniform annulus pupil, uniform arrival time
    r = torch.sqrt(pupil_obscuration**2 * pupil_radius**2
                   + draws["pupil_u1"] * (1 - pupil_obscuration**2)
                   * pupil_radius**2)
    th = draws["pupil_u2"] * 2 * np.pi
    z = torch.zeros_like(x)
    return PhotonBatch(x=x, y=y, flux=weight, wavelength=wl, dxdz=z, dydz=z,
                       pupil_u=r * torch.cos(th), pupil_v=r * torch.sin(th),
                       time=draws["time_u"] * exptime, abs_len=labs)


def shoot_full(gen, row, obj_idx, weight, tel, ctx,
               profiles: P.ProfileTables, families, screens=None,
               sk_table=None, exptime: float = 30.0,
               pupil_radius: float = 4.18, pupil_obscuration: float = 0.612,
               pupil_pairing: int = 1, screen_share: int = 1,
               chromatic_exponent: float = 0.0, wl_ref: float = 622.0,
               apply_dcr: bool = True, apply_diffraction: bool = True,
               diffraction_field_rotation: bool = True,
               silicon=None, si_gen=None, aux_cloud=None) -> PhotonBatch:
    """Full physics chain for a pooled batch, in detector pixels with
    in-silicon slopes (or, with `silicon`, final displaced positions).
    row: (N_COLS + WL_CHEB_D, n) per-photon parameters, photon-minor
    (photon_pooling.materialize_rows_T); aux_cloud: the scene's FITS-stamp
    point clouds.

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

    dx_as, dy_as = sample_intrinsic(gen, row, obj_idx, profiles, families,
                                    aux_cloud=aux_cloud)
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
