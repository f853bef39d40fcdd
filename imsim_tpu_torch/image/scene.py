"""Scene containers (imsim_tpu/image/scene.py counterpart): the packed
per-object parameter matrix and wavelength tables on the device, their
host companion, and the unpooled photon batcher."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

WL_CDF_K = 96   # inverse-CDF table size for photon wavelength sampling
WL_CHEB_D = 14  # Chebyshev degree+1 of the gather-free wl(u) sampler
CLOUD_K = 1024  # point-cloud size for FITS-postage-stamp objects

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


def absorption_icdf(wl_icdf: np.ndarray) -> np.ndarray:
    """Silicon absorption length [um] at every wavelength of the
    inverse-CDF table (np.interp on silicon.absorption_length_table, as
    the JAX package's DeviceScene.from_columns): (n, K) float32."""
    from ..sensor.silicon import absorption_length_table

    abs_t = absorption_length_table()
    return np.interp(np.asarray(wl_icdf, float),
                     abs_t.x0 + np.arange(len(abs_t.y)) * abs_t.dx,
                     np.asarray(abs_t.y, float)).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class DeviceScene:
    """params: (n, N_COLS) float32 packed per-object scalars (COL_*);
    wl_cheb: (n, WL_CHEB_D) Chebyshev rows of each object's wavelength
    inverse CDF; wl_icdf: (n, WL_CDF_K) that inverse CDF at u = k/(K-1)
    and labs_icdf the silicon absorption length there (the analytic
    path's wavelength gather); aux_cloud: (M, CLOUD_K, 2) arcsec point
    clouds of FITS-stamp objects (COL_P2 of such a row is its cloud
    index; row 0 is empty)."""

    params: torch.Tensor
    wl_cheb: torch.Tensor
    wl_icdf: torch.Tensor | None = None
    labs_icdf: torch.Tensor | None = None
    aux_cloud: torch.Tensor | None = None

    @property
    def n(self) -> int:
        return self.params.shape[0]

    @property
    def device(self) -> torch.device:
        return self.params.device

    @classmethod
    def from_columns(cls, x, y, obj_type, p0, p1, p2, p3, g1, g2, mu,
                     wl_icdf, aux_cloud=None, device="cuda"):
        """The scene of numpy columns on `device` (the JAX package's
        DeviceScene.from_columns): labs_icdf from the port's absorption
        table, wl_cheb fitted on the host."""
        cols = [x, y, obj_type, p0, p1, p2, p3, g1, g2, mu]
        params = np.stack([np.asarray(c, np.float32) for c in cols], axis=1)
        if aux_cloud is None:
            aux_cloud = np.zeros((1, CLOUD_K, 2), np.float32)
        wl = np.asarray(wl_icdf, np.float32)

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                   device=device)

        return cls(params=t(params),
                   wl_cheb=t(fit_wl_cheb(np.asarray(wl_icdf, np.float64))),
                   wl_icdf=t(wl), labs_icdf=t(absorption_icdf(wl)),
                   aux_cloud=t(aux_cloud))


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


def make_photon_batches(host: SceneHost, batch_size: int,
                        max_batches: int | None = None):
    """Yield (obj_idx int64 (batch_size,), weight float32) on the scene's
    device: the object-major photon -> object assignment in consecutive
    batches (copy of the JAX package's make_photon_batches); the last
    batch's tail points at the last (padded) object with weight 0."""
    counts = host.flux.astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return
    obj_of_photon = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    nb = int(np.ceil(total / batch_size))
    if max_batches is not None:
        nb = min(nb, max_batches)
    dev = host.scene.device
    for b in range(nb):
        sl = obj_of_photon[b * batch_size:(b + 1) * batch_size]
        idx = np.full(batch_size, host.scene.n - 1, np.int64)
        w = np.zeros(batch_size, np.float32)
        idx[:len(sl)] = sl
        w[:len(sl)] = 1.0
        yield torch.as_tensor(idx, device=dev), torch.as_tensor(w, device=dev)
