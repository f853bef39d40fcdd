"""Atmospheric PSF: frozen-flow von Karman phase screens on the device
(imsim_tpu/psf/atmosphere.py counterpart).

The host draws the layer weights, winds and r0 exactly as the JAX
package does (the state carries them as numpy data, `ScreenSpec`); the
port synthesizes each layer as one FFT of filtered complex noise drawn
from a torch generator (or passed in, for parity tests) and samples the
OPD-gradient texels per photon (the first kick).
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch
from scipy import special

# Ellerbroek-style layer altitudes (km)
LAYER_ALTITUDES_KM = np.array([0.0, 2.58, 5.16, 7.73, 12.89, 15.46])


@lru_cache(maxsize=1)
def _vk_spectrum_norm():
    """Calibrates the von Karman spectrum constant so the L0 -> inf
    limit reproduces D(rho) = 6.88 (rho/r0)^(5/3) (copy of
    imsim_tpu.photons.profiles._vk_spectrum_norm)."""
    k = np.geomspace(1e-6, 1e5, 8192)
    raw = np.trapezoid((1.0 - special.j0(k * 1.0)) * k ** (-8.0 / 3.0), k)
    return 6.88 / raw


def vonkarman_phase_spectrum(k, r0, L0):
    """2-D phase power spectrum Phi(k) [rad^2 m^2], k in rad/m (copy of
    imsim_tpu.photons.profiles.vonkarman_phase_spectrum)."""
    return (0.5 * _vk_spectrum_norm() * r0 ** (-5.0 / 3.0)
            * (k**2 + 1.0 / L0**2) ** (-11.0 / 6.0))


def vonkarman_structure(rho, r0, L0):
    """von Karman phase structure function D(rho) [rad^2], rho in meters
    (copy of imsim_tpu.photons.profiles.vonkarman_structure)."""
    k = np.geomspace(1e-4, 1e4, 4096)
    Phi = vonkarman_phase_spectrum(k, r0, L0)
    rho = np.atleast_1d(rho)
    D = 2.0 * np.trapezoid(
        (1.0 - special.j0(np.outer(rho, k))) * (Phi * k)[None, :], k, axis=1)
    return D


def _screen_spectrum_amplitude(n, scale, r0, L0, kcrit_rad):
    """sqrt(power) filter of one layer on the FFT frequency grid, zeroed
    above kcrit (copy of imsim_tpu.psf.atmosphere's host helper)."""
    k1 = 2 * np.pi * np.fft.fftfreq(n, d=scale)
    kx, ky = np.meshgrid(k1, k1)
    k = np.hypot(kx, ky)
    Phi = vonkarman_phase_spectrum(np.maximum(k, 1e-9), r0, L0)
    Phi = np.where(k <= kcrit_rad, Phi, 0.0)
    Phi[0, 0] = 0.0
    dk = 2 * np.pi / (n * scale)
    return np.sqrt(Phi / (2 * np.pi)) * dk


@dataclasses.dataclass(frozen=True)
class ScreenSpec:
    """Host inputs of the screen synthesis (the numpy part of
    imsim_tpu.psf.atmosphere.make_screens)."""

    weights: tuple        # per-layer turbulence weights (sum 1)
    winds: np.ndarray     # (L, 2) m/s
    r0_layer: np.ndarray  # (L,) m at 500 nm
    L0: float
    kcrit_rad: float
    size: float           # m
    scale: float          # m per texel
    t0: float = 0.0

    @property
    def n(self) -> int:
        return int(round(self.size / self.scale))


@dataclasses.dataclass(frozen=True)
class AtmScreens:
    """grad: (L, n, n, 2) OPD gradients [rad of deflection]; winds
    (L, 2) m/s; scale m/texel; size m; weights per layer."""

    grad: torch.Tensor
    winds: np.ndarray
    scale: float
    size: float
    t0: float = 0.0
    weights: tuple | None = None


def screen_noise(gen: torch.Generator, n_layers: int, n: int):
    """(L, n, n) complex64 noise N(0,1) + i N(0,1) on the generator's
    device."""
    shape = (n_layers, n, n)
    re = torch.randn(shape, generator=gen, device=gen.device)
    im = torch.randn(shape, generator=gen, device=gen.device)
    return torch.complex(re, im)


def make_screens(spec: ScreenSpec, device, gen=None, noise=None):
    """Synthesize all layers: phase = Re(ifft2(noise * A)) n^2 [rad at
    500 nm], OPD = phase lam/2pi, deflection = central-difference
    gradient of the OPD.  Noise comes from `gen` unless passed in as an
    (L, n, n) complex tensor."""
    n = spec.n
    L = len(spec.weights)
    A = torch.as_tensor(np.stack([
        _screen_spectrum_amplitude(n, spec.scale, spec.r0_layer[i],
                                   spec.L0, spec.kcrit_rad)
        for i in range(L)]), dtype=torch.float32, device=device)
    if noise is None:
        noise = screen_noise(gen, L, n)
    phase = torch.fft.ifft2(noise.to(device) * A).real * (n * n)
    opd = phase * (500e-9 / (2 * np.pi))
    gx = (torch.roll(opd, -1, 2) - torch.roll(opd, 1, 2)) / (2 * spec.scale)
    gy = (torch.roll(opd, -1, 1) - torch.roll(opd, 1, 1)) / (2 * spec.scale)
    return AtmScreens(grad=torch.stack([gx, gy], dim=-1).contiguous(),
                      winds=np.asarray(spec.winds, np.float32),
                      scale=spec.scale, size=spec.size, t0=spec.t0,
                      weights=tuple(float(w) for w in spec.weights))


def strong_layer_mask(weights, strong_cum: float = 0.8):
    """Static strong/weak partition: layers in descending weight order
    are strong until their cumulative weight reaches strong_cum."""
    order = sorted(range(len(weights)), key=lambda i: -weights[i])
    mask = [False] * len(weights)
    acc = 0.0
    for i in order:
        mask[i] = True
        acc += weights[i]
        if acc >= strong_cum:
            break
    return tuple(mask)


def first_kick_angles(pupil_u, pupil_v, time, screens: AtmScreens,
                      theta_x=0.0, theta_y=0.0, share: int = 1,
                      strong_cum: float = 0.8):
    """Geometric phase-screen deflection [rad] per photon: for each
    layer, the nearest texel of grad(OPD) at the wind-advected pupil
    position plus theta * altitude.  share > 1: weak layers gather only
    for the first n // share slots and broadcast to the `share` block
    (stratified sharing, see imsim_tpu.psf.atmosphere)."""
    L, n_tex = screens.grad.shape[0], screens.grad.shape[1]
    n = pupil_u.shape[0]
    flat = screens.grad.reshape(L, n_tex * n_tex, 2)
    t_eff = time + screens.t0 if screens.t0 else time
    if share > 1 and screens.weights is not None and n % share == 0:
        strong = strong_layer_mask(screens.weights, strong_cum)
    else:
        strong, share = (True,) * L, 1
    ns = n // share
    theta_x = torch.broadcast_to(torch.as_tensor(theta_x), (n,))
    theta_y = torch.broadcast_to(torch.as_tensor(theta_y), (n,))
    winds = [[float(v) for v in w] for w in screens.winds]

    def layer_kick(i, m):
        alt_m = LAYER_ALTITUDES_KM[i] * 1000.0
        px = pupil_u[:m] + winds[i][0] * t_eff[:m] + theta_x[:m] * alt_m
        py = pupil_v[:m] + winds[i][1] * t_eff[:m] + theta_y[:m] * alt_m
        ix = torch.remainder(
            torch.round(px / screens.scale).to(torch.int64), n_tex)
        iy = torch.remainder(
            torch.round(py / screens.scale).to(torch.int64), n_tex)
        g = flat[i][iy * n_tex + ix]
        return g[:, 0], g[:, 1]

    ddx = torch.zeros_like(pupil_u)
    ddy = torch.zeros_like(pupil_v)
    wx = wy = None
    for i in range(L):
        if strong[i]:
            gx, gy = layer_kick(i, n)
            ddx, ddy = ddx + gx, ddy + gy
        else:
            gx, gy = layer_kick(i, ns)
            wx = gx if wx is None else wx + gx
            wy = gy if wy is None else wy + gy
    if wx is not None:
        # group q's draw lands on slots {r * ns + q}
        ddx = ddx + wx.repeat(share)
        ddy = ddy + wy.repeat(share)
    return ddx, ddy
