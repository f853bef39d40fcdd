"""One CCD through the analytic PSF, and the sky and noise of a CCD
(imsim_tpu/image/ccd_render.py counterpart: `render_ccd`, the unpooled
loop of consecutive photon batches through render.shoot and the ideal
binner, and `_add_sky_and_noise`)."""
from __future__ import annotations

import dataclasses

import torch

from ..utils.rng import poisson_approx, stream


@dataclasses.dataclass
class RenderConfig:
    xsize: int = 4096
    ysize: int = 4096
    exptime: float = 30.0
    batch_size: int = 4_000_000
    pixel_scale: float = 0.2       # arcsec/pixel
    fwhm: float = 0.8              # atmospheric seeing FWHM (arcsec)
    gauss_fwhm: float = 0.3        # extra instrumental gaussian (arcsec)
    sky_level: float = 0.0         # photons/arcsec^2


def _render_batch(gen, image, scene, obj_idx, weight, psf_tables, profiles,
                  cfg: RenderConfig, families):
    """One batch: render.shoot (rows gathered by obj_idx) into the
    ideal binner."""
    from ..sensor.simple import accumulate
    from . import render

    photons = render.shoot(gen, scene, obj_idx, weight, psf_tables,
                           profiles, exptime=cfg.exptime,
                           pixel_scale=cfg.pixel_scale, families=families)
    return accumulate(photons, image)


def render_ccd(seed: int, host, cfg: RenderConfig, *, profiles,
               vignetting_image=None, sky_gradient=None, max_batches=None):
    """The object photons and the sky of one CCD on the scene's device,
    (ysize, xsize) in electrons before readout.  COL_X/COL_Y hold pixel
    positions; profiles: the intrinsic-profile samplers.  sky_gradient:
    an object with a, b, c and sky_level_center (the plane gradient's
    coefficients); vignetting_image: a full-resolution factor."""
    from .photon_pooling import analytic_psf_tables
    from .render import ALL_FAMILIES
    from .scene import make_photon_batches

    dev = host.scene.device
    psf_tables = analytic_psf_tables(cfg.fwhm, cfg.gauss_fwhm, dev)
    image = torch.zeros((cfg.ysize, cfg.xsize), dtype=torch.float32,
                        device=dev)
    for b, (obj_idx, weight) in enumerate(
            make_photon_batches(host, cfg.batch_size, max_batches)):
        image = _render_batch(stream(seed, "photons", b, device=dev), image,
                              host.scene, obj_idx, weight, psf_tables,
                              profiles, cfg, ALL_FAMILIES)
    if cfg.sky_level > 0:
        if sky_gradient is None:
            abc = (0.0, 0.0, 1.0)
        else:
            s = sky_gradient.sky_level_center
            abc = (sky_gradient.a / s, sky_gradient.b / s,
                   sky_gradient.c / s)
        vig = torch.ones((cfg.ysize, cfg.xsize), dtype=torch.float32,
                         device=dev) if vignetting_image is None \
            else vignetting_image
        image = add_sky_and_noise(stream(seed, "sky", device=dev), image,
                                  cfg.sky_level, abc, vig, cfg.pixel_scale)
    return image


def sky_expectation(shape, sky_per_arcsec2: float, gradient_abc, vignet_img,
                    pixel_scale: float, vig_step: int = 1, fringe=None,
                    device="cuda") -> torch.Tensor:
    """The noiseless sky [electrons per pixel], (H, W) float32 on
    `device`: sky level x plane gradient (a x + b y + c) x vignetting x
    fringing.  vig_step > 1: vignet_img is a coarse stride-vig_step grid
    (utils.grid.coarse_shape), upsampled here on the device; fringe is an
    optional full-resolution factor (not smooth at the coarse scale)."""
    from ..utils.grid import upsample_bilinear

    H, W = shape
    vignet_img = torch.as_tensor(vignet_img, dtype=torch.float32,
                                 device=device)
    if vig_step > 1:
        vignet_img = upsample_bilinear(vignet_img, (H, W), vig_step)
    if fringe is not None:
        vignet_img = vignet_img * torch.as_tensor(fringe, device=device)
    yy = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    a, b, c = (float(v) for v in gradient_abc)
    grad = a * xx + b * yy + c
    return sky_per_arcsec2 * (pixel_scale ** 2) * grad * vignet_img


def add_sky_and_noise(gen: torch.Generator, image: torch.Tensor,
                      sky_per_arcsec2: float, gradient_abc, vignet_img,
                      pixel_scale: float, exact_poisson: bool = False,
                      read_noise: float = 0.0, gain: float = 1.0,
                      vig_step: int = 1, fringe=None) -> torch.Tensor:
    """Sky (sky_expectation) with Poisson noise, added to `image`
    [electrons] on its device.

    Object photons already carry shot noise, so only the sky is drawn:
    the rounded Gaussian sky + sqrt(sky) N(0, 1) by default (equal in
    distribution above ~30 e-/pixel), or poisson_approx with
    exact_poisson.  read_noise > 0 adds a Gaussian floor of
    read_noise / gain electrons.  All draws come from `gen`, in that
    order."""
    sky = sky_expectation(image.shape, sky_per_arcsec2, gradient_abc,
                          vignet_img, pixel_scale, vig_step, fringe,
                          image.device)
    if exact_poisson:
        noisy_sky = poisson_approx(gen, sky)
    else:
        noisy_sky = torch.round(
            sky + torch.sqrt(torch.clamp(sky, min=0.0))
            * torch.randn(sky.shape, generator=gen, device=image.device,
                          dtype=sky.dtype))
    out = image + noisy_sky
    if read_noise:
        out = out + (read_noise / gain) * torch.randn(
            out.shape, generator=gen, device=image.device, dtype=out.dtype)
    return out


# the JAX package's name
_add_sky_and_noise = add_sky_and_noise
