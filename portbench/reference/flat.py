"""The plain reference of the SED photon flat: imSim's LSST_Flat image
type with an SED (imsim/flat.py, LSST_FlatBuilder), written anew from
its description in plain torch and numpy, float32, with TF32 off:

  * photons uniform over the frame, `counts_per_iter` a pixel in each of
    ceil(counts_per_pixel / counts_per_iter) iterations, an iteration
    shot in sub-batches of at most CAP photons (`plan`); the
    brighter-fatter field is recomputed before each sub-batch, so the
    cadence is the photons a pixel between recomputes;
  * each photon's wavelength from the inverse CDF of SED x bandpass (a
    photon density), linear between WL_K points (`wavelength_icdf`);
  * its conversion depth z = -l_abs(lambda) ln u: a photon deeper than
    the silicon is lost; Gaussian diffusion of
    sigma = D sqrt((T - z) / T) over the drift that remains;
  * binning to the nearest pixel (`index_add_`);
  * the sub-batch's charge Q moves by the displacement d of the charge
    collected before it: Q - div(Q d), central differences, periodic at
    the frame's edge (so charge is conserved); d is the brighter-fatter
    part, the SAME correlation (`conv2d`) of that charge with the
    central-difference gradient of the interaction kernel, plus the
    static tree-ring part, the radial displacement dr(r) about the ring
    centre at each pixel centre.

Departures from GalSim's SiliconSensor, which imSim runs: a displacement
field and the continuity update in place of pixel boundaries moved by a
Poisson solution (the port's model); the isotropic default kernel at
strength 0.4, not a measured sensor model; the port's synthetic tree
rings (frozen/treerings.py), no measured ones; photons that arrive
perpendicular to the sensor.

Host tables are frozen copies (frozen/: the absorption table, the
default kernel, the tree-ring model's parameters, the bandpass and SED
readers); the per-photon and per-pixel physics is here.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .frozen import silicon as fsi
from .frozen import treerings as ftr
from .frozen.bandpass import rubin_bandpass
from .frozen.sed import _cached_raw_sed

CAP = 16_777_216    # photons in a sub-batch at most
WL_K = 96           # points of the wavelength inverse CDF
U_MIN = 1e-7        # the depth uniform is kept off 0


@dataclasses.dataclass(frozen=True)
class Silicon:
    thickness_um: float
    pixel_um: float
    diffusion_um: float
    bf_kernel: np.ndarray       # (2R + 1, 2R + 1) per electron
    rings: ftr.TreeRings | None


def silicon(cfg: dict, det: str, bf: bool = True,
            rings: bool = True) -> Silicon:
    """The configuration's silicon (`silicon`: thickness_um, pixel_um,
    diffusion_um, bf_strength) with det's tree rings; bf=False: no
    kernel, rings=False: no tree rings (the planted faults)."""
    s = cfg["silicon"]
    k = fsi.default_bf_kernel(strength=float(s["bf_strength"]))
    return Silicon(float(s["thickness_um"]), float(s["pixel_um"]),
                   float(s["diffusion_um"]),
                   k if bf else np.zeros_like(k),
                   ftr.model(det) if rings else None)


def plan(counts_per_pixel: float, counts_per_iter: float, h: int, w: int):
    """(iterations, sub-batches an iteration, photons a sub-batch)."""
    n_iter = math.ceil(counts_per_pixel / counts_per_iter)
    n_phot = int(counts_per_iter * h * w)
    n_sub = max(1, -(-n_phot // CAP))
    return n_iter, n_sub, -(-n_phot // n_sub)


def _photon_pdf(sed_path: str, band: str, airmass: float):
    bp = rubin_bandpass(band, airmass=airmass)
    sed = _cached_raw_sed(sed_path)
    return bp.wave, np.clip(sed.resample(bp.wave) * bp.throughput, 0.0, None)


def wavelength_icdf(sed_path: str, band: str, airmass: float,
                    k: int = WL_K) -> np.ndarray:
    """The photon wavelengths' inverse CDF at k evenly spaced quantiles,
    from the trapezoid CDF of SED x bandpass."""
    w, p = _photon_pdf(sed_path, band, airmass)
    cdf = np.concatenate([[0.0], np.cumsum(0.5 * (p[1:] + p[:-1])
                                           * np.diff(w))])
    cdf /= cdf[-1]
    # strictly increasing where the pdf is 0
    return np.interp(np.linspace(0, 1, k), cdf + np.arange(len(cdf)) * 1e-14,
                     w).astype(np.float32)


def absorption_length(wl: torch.Tensor) -> torch.Tensor:
    """l_abs [um] at wavelengths [nm]: linear in the frozen table,
    clamped at its ends."""
    tab = torch.as_tensor(fsi.absorption_table(), device=wl.device)
    step = (fsi.ABS_TABLE_MAX_NM - fsi.ABS_TABLE_MIN_NM) / (len(tab) - 1)
    f = torch.clamp((wl - fsi.ABS_TABLE_MIN_NM) / step, 0, len(tab) - 1)
    j = torch.clamp(torch.floor(f).long(), max=len(tab) - 2)
    t = f - j
    return tab[j] * (1 - t) + tab[j + 1] * t


def kept_fraction(sed_path: str, band: str, airmass: float,
                  thickness_um: float) -> float:
    """The share of the photons that convert inside the silicon:
    integral of SED x bandpass x (1 - exp(-T / l_abs)) over the
    integral of SED x bandpass (trapezoids on the bandpass's grid)."""
    w, p = _photon_pdf(sed_path, band, airmass)
    labs = np.interp(w, np.linspace(fsi.ABS_TABLE_MIN_NM,
                                    fsi.ABS_TABLE_MAX_NM,
                                    fsi.ABS_TABLE_POINTS),
                     fsi.absorption_table().astype(float))
    keep = 1.0 - np.exp(-thickness_um / labs)
    return float(np.trapezoid(p * keep, w) / np.trapezoid(p, w))


def tree_ring_field(rings: ftr.TreeRings, h: int, w: int, device,
                    dtype=torch.float32):
    """(dx, dy) [px] of the rings' radial displacement at the pixel
    centres of the (h, w) frame at the CCD's origin:
    dr(r) = norm (a + b r^4) sum_k amp_k sin(omega_k r + phase_k)."""
    f64 = dict(dtype=torch.float64, device=device)
    cx, cy = rings.center
    rx = (torch.arange(w, **f64) - cx)[None, :]
    ry = (torch.arange(h, **f64) - cy)[:, None]
    r = torch.sqrt(rx * rx + ry * ry)
    a, b, norm = rings.env
    s = torch.zeros_like(r)
    for om, ph, amp in rings.waves.astype(float):
        s += amp * torch.sin(om * r + ph)
    dr = norm * (a + b * r ** 4) * s
    return (dr * rx / r).to(dtype), (dr * ry / r).to(dtype)


def area_modulation(rings: ftr.TreeRings, h: int, w: int,
                    device="cpu") -> np.ndarray:
    """-div of the tree-ring field of the (h, w) frame at the CCD's
    origin (float64, central differences): a uniform illumination's
    relative charge change, pixel by pixel."""
    dx, dy = tree_ring_field(rings, h, w, device, torch.float64)
    return -_div(dx, dy).cpu().numpy()


def _div(fx, fy):
    """Central-difference divergence, periodic at the edges."""
    return (0.5 * (torch.roll(fx, -1, 1) - torch.roll(fx, 1, 1))
            + 0.5 * (torch.roll(fy, -1, 0) - torch.roll(fy, 1, 0)))


def bf_taps(kernel: np.ndarray) -> torch.Tensor:
    """(2, 1, k, k): the kernel's central-difference gradient along x and
    y (0 outside the kernel)."""
    K = np.pad(kernel.astype(np.float32), 1)
    gx = 0.5 * (K[1:-1, 2:] - K[1:-1, :-2])
    gy = 0.5 * (K[2:, 1:-1] - K[:-2, 1:-1])
    return torch.from_numpy(np.stack([gx, gy])[:, None].astype(np.float32))


def bf_field(image: torch.Tensor, taps: torch.Tensor):
    """The brighter-fatter displacement (dx, dy) of each pixel: the
    charge correlated with the kernel's gradient, zero outside the
    frame."""
    r = taps.shape[-1] // 2
    d = torch.nn.functional.conv2d(image[None, None].float(), taps,
                                   padding=r)[0]
    return d[0], d[1]


def torch_draws(gen: torch.Generator):
    """draws(n) -> (u_x, u_y, u_wl, u_depth, g_x, g_y), each (n,) float32
    from `gen` in that order."""
    def draws(n):
        kw = dict(generator=gen, device=gen.device, dtype=torch.float32)
        return (torch.rand(n, **kw), torch.rand(n, **kw),
                torch.rand(n, **kw), torch.rand(n, **kw),
                torch.randn(n, **kw), torch.randn(n, **kw))
    return draws


def build(h: int, w: int, counts_per_pixel: float, counts_per_iter: float,
          icdf: np.ndarray, si: Silicon, draws, device, *,
          dtype=torch.float32, keep: float = 1.0) -> torch.Tensor:
    """The flat [e-] of the (h, w) frame at the CCD's origin.  draws(n):
    the sub-batch's uniforms and normals (torch_draws), drawn one
    sub-batch after the other.  dtype: the
    precision the charge is held and moved in.  keep < 1: only that
    share of each sub-batch's photons is binned (a planted fault)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n_iter, n_sub, per = plan(counts_per_pixel, counts_per_iter, h, w)
    wl_tab = torch.as_tensor(icdf, device=device)
    taps = bf_taps(si.bf_kernel).to(device)
    tr = None if si.rings is None else tree_ring_field(si.rings, h, w, device)
    image = torch.zeros((h, w), dtype=dtype, device=device)
    spread = torch.arange(per, device=device) % (h * w)
    for _ in range(n_iter * n_sub):
        ux, uy, uwl, ud, gx, gy = draws(per)
        x = ux * w - 0.5
        y = uy * h - 0.5
        f = uwl * (len(icdf) - 1)
        j = torch.clamp(torch.floor(f).long(), max=len(icdf) - 2)
        t = f - j
        wl = wl_tab[j] * (1 - t) + wl_tab[j + 1] * t
        z = -absorption_length(wl) * torch.log(ud * (1 - U_MIN) + U_MIN)
        sigma = si.diffusion_um * torch.sqrt(
            torch.clamp(si.thickness_um - z, min=0.0) / si.thickness_um) \
            / si.pixel_um
        ix = torch.round(x + sigma * gx).long()
        iy = torch.round(y + sigma * gy).long()
        ok = (z < si.thickness_um) & (ix >= 0) & (ix < w) & (iy >= 0) \
            & (iy < h)
        if keep < 1.0:
            ok &= torch.arange(per, device=device) < int(keep * per)
        # a photon lost or off the frame adds 0 to a pixel of its own
        q = torch.zeros(h * w, device=device).index_add_(
            0, torch.where(ok, iy * w + ix, spread), ok.float()) \
            .reshape(h, w).to(dtype)
        dx, dy = bf_field(image, taps)
        if tr is not None:
            dx = dx + tr[0]
            dy = dy + tr[1]
        image = image + (q - _div(q * dx.to(dtype), q * dy.to(dtype)))
    return image


# ---- the numbers that decide `correct` --------------------------------------

@dataclasses.dataclass(frozen=True)
class Model:
    """What the reference expects of the flat of an (h, w) frame at the
    CCD's origin: `level`, the mean charge a pixel over the interior
    (the plan's photons a pixel x the share that converts inside the
    silicon x the tree rings' mean area there), `modulation`, the tree
    rings' relative charge change of each pixel, and the ring centre."""
    level: float
    modulation: np.ndarray
    center: tuple

    @classmethod
    def of(cls, cfg: dict, det: str, sed_path: str, h: int, w: int,
           device="cpu"):
        si = silicon(cfg, det)
        n_iter, n_sub, per = plan(cfg["counts_per_pixel"],
                                  cfg["counts_per_iter"], h, w)
        kept = kept_fraction(sed_path, cfg["band"], cfg["airmass"],
                             si.thickness_um)
        mod = area_modulation(si.rings, h, w, device)
        e = cfg["check"]["edge_px"]
        level = n_iter * n_sub * per / (h * w) * kept \
            * (1.0 + mod[e:-e, e:-e].mean())
        return cls(level, mod, si.rings.center)


def moments(a: np.ndarray, edge: int):
    """(mean, var / mean, C01 / mean, C10 / mean) over the pixels `edge`
    clear of the frame's edges; C01 and C10 the covariances of
    horizontal and vertical nearest neighbours."""
    a = a[edge:-edge, edge:-edge].astype(np.float64)
    m = a.mean()
    d = a - m
    return (m, float((d * d).mean() / m),
            float((d[:, 1:] * d[:, :-1]).mean() / m),
            float((d[1:] * d[:-1]).mean() / m))


def ring_amplitude(a: np.ndarray, model: Model, ccfg: dict) -> float:
    """The tree rings' amplitude in the flat `a`: its charge averaged in
    annuli `ring_width_px` wide about the ring centre (those of
    `ring_min_pixels` pixels or more, `edge_px` clear of the edges),
    relative to its mean, fitted (least squares weighted by the pixels
    of each annulus, with an offset) to the model's modulation averaged
    the same way: 1 where the rings are as the model has them, 0 where
    the flat has none."""
    e = ccfg["edge_px"]
    a = a[e:-e, e:-e].astype(np.float64)
    mod = 1.0 + model.modulation[e:-e, e:-e]
    h, w = a.shape
    y, x = np.mgrid[e:e + h, e:e + w]
    r = np.hypot(x - model.center[0], y - model.center[1])
    k = ((r - r.min()) // ccfg["ring_width_px"]).astype(np.int64).ravel()
    n = np.bincount(k)
    ok = n >= ccfg["ring_min_pixels"]
    n = n[ok]
    p = np.bincount(k, a.ravel())[ok] / n / a.mean()
    m = np.bincount(k, mod.ravel())[ok] / n / mod.mean()
    p -= np.average(p, weights=n)
    m -= np.average(m, weights=n)
    return float(np.sum(n * p * m) / np.sum(n * m * m))


def numbers(prog: np.ndarray, sound: np.ndarray, model: Model, ccfg: dict,
            detail: dict | None = None) -> dict:
    """The gaps of the program's flat `prog` (the charge [e-] of each
    pixel) from the reference's flat `sound` of the same frame and from
    the model:

      level_rel     |interior mean / the model's level - 1|;
      vom_gap       |var / mean - the reference's var / mean|, the
                    brighter-fatter droop below Poisson and the tree
                    rings' variance;
      cov_gap       the larger of the gaps of C01 / mean and C10 / mean
                    from the reference's;
      treering_gap  |ring_amplitude - 1|.

    detail: filled with both sides' moments and the amplitude."""
    e = ccfg["edge_px"]
    mp, vp, c01p, c10p = moments(prog, e)
    mr, vr, c01r, c10r = moments(sound, e)
    amp = ring_amplitude(prog, model, ccfg)
    if detail is not None:
        detail.update(level=model.level, mean=[mp, mr],
                      var_over_mean=[vp, vr], c01=[c01p, c01r],
                      c10=[c10p, c10r], ring_amplitude=amp)
    return dict(level_rel=abs(mp / model.level - 1.0), vom_gap=abs(vp - vr),
                cov_gap=max(abs(c01p - c01r), abs(c10p - c10r)),
                treering_gap=abs(amp - 1.0))
