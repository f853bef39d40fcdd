"""Sky and noise of one CCD (imsim_tpu/image/ccd_render.py counterpart:
`_add_sky_and_noise`).  The analytic-PSF `render_ccd` is not ported."""
from __future__ import annotations

import torch

from ..utils.rng import poisson_approx


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
