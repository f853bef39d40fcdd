"""Scene containers (imsim_tpu/image/scene.py counterpart): the packed
per-object parameter matrix on the device, and its host companion."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

WL_CDF_K = 96   # inverse-CDF table size for photon wavelength sampling
WL_CHEB_D = 14  # Chebyshev degree+1 of the gather-free wl(u) sampler

# Column layout of the packed per-object parameter matrix.
COL_X, COL_Y, COL_TYPE, COL_P0, COL_P1, COL_P2, COL_P3, COL_G1, COL_G2, \
    COL_MU = range(10)
N_COLS = 10

_WL_CHEB_PINV = {}


def fit_wl_cheb(wl_icdf: np.ndarray, d: int = WL_CHEB_D) -> np.ndarray:
    """Least-squares Chebyshev coefficients of each row's inverse CDF
    wl(u), in the arcsin-stretched variable x = (2/pi) asin(2u - 1):
    (n, K) -> (n, d) float32.  Copy of imsim_tpu.image.scene.fit_wl_cheb
    (host numpy; held equal to it by the tests)."""
    K = wl_icdf.shape[1]
    key = (K, d)
    if key not in _WL_CHEB_PINV:
        u = np.linspace(0.0, 1.0, K)
        x = np.arcsin(np.clip(2.0 * u - 1.0, -1.0, 1.0)) * (2.0 / np.pi)
        T = np.polynomial.chebyshev.chebvander(x, d - 1)   # (K, d)
        _WL_CHEB_PINV[key] = np.linalg.pinv(T).T           # (K, d)
    return (wl_icdf @ _WL_CHEB_PINV[key]).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class DeviceScene:
    """params: (n, N_COLS) float32 packed per-object scalars (COL_*);
    wl_cheb: (n, WL_CHEB_D) Chebyshev rows of each object's wavelength
    inverse CDF."""

    params: torch.Tensor
    wl_cheb: torch.Tensor

    @property
    def n(self) -> int:
        return self.params.shape[0]

    @property
    def device(self) -> torch.device:
        return self.params.device


@dataclasses.dataclass
class SceneHost:
    """Host companion: realized photon counts per object, the object
    count before padding, and the objects' pixel positions (the FFT
    branch places its stamps in pixels; the device scene's COL_X/COL_Y
    hold field angles on the optics path)."""

    scene: DeviceScene
    flux: np.ndarray          # (n,) realized photon counts
    nominal_flux: np.ndarray  # (n,) expectation values
    n_objects: int
    pix_x: np.ndarray | None = None  # (n_objects,) pixel coords
    pix_y: np.ndarray | None = None
