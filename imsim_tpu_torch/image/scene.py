"""Scene containers and assembly (imsim_tpu/image/scene.py counterpart):
the packed per-object parameter matrix and wavelength tables on the
device, their host companion, the catalog -> scene builder
(`build_scene`, host numpy as in the JAX package) and the unpooled photon
batcher."""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..catalog import instcat as ic
from ..catalog.bandpass import Bandpass
from ..catalog.sed import SED, _cached_raw_sed, _ccm89_ab, ccm89_ab, \
    extinction_factor, find_sed_file
from ..io.fits import read_fits

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

    @property
    def x(self):
        return self.params[:, COL_X]

    @property
    def y(self):
        return self.params[:, COL_Y]

    @property
    def obj_type(self):
        return self.params[:, COL_TYPE].to(torch.int32)

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


def _wavelength_icdf(sed: SED, bp: Bandpass, k: int = WL_CDF_K) -> np.ndarray:
    """Inverse CDF of the photon wavelength pdf = sed x throughput."""
    w = bp.wave
    p = np.clip(sed.resample(w) * bp.throughput, 0.0, None)
    if p.sum() <= 0:
        return np.full(k, bp.effective_wavelength)
    cdf = np.concatenate([[0.0], np.cumsum(0.5 * (p[1:] + p[:-1])
                                           * np.diff(w))])
    cdf /= cdf[-1]
    u = np.linspace(0, 1, k)
    eps = np.arange(len(cdf)) * 1e-14
    return np.interp(u, cdf + eps, w)


def _fits_point_cloud(path: str, pixel_scale_as: float, theta_rad: float,
                      rng: np.random.Generator) -> np.ndarray:
    """(CLOUD_K, 2) arcsec offsets sampled in proportion to the FITS
    image's pixel fluxes, with sub-pixel jitter, the catalog's pixel
    scale and its rotation."""
    hdr, data = read_fits(path)[0]
    img = np.clip(np.asarray(data, np.float64), 0.0, None)
    ny, nx = img.shape
    p = img.ravel() / img.sum()
    idx = rng.choice(p.size, size=CLOUD_K, p=p)
    iy, ix = np.divmod(idx, nx)
    x = ix - (nx - 1) / 2 + rng.uniform(-0.5, 0.5, CLOUD_K)
    y = iy - (ny - 1) / 2 + rng.uniform(-0.5, 0.5, CLOUD_K)
    c, s = np.cos(theta_rad), np.sin(theta_rad)
    return np.stack([(c * x - s * y), (s * x + c * y)],
                    -1).astype(np.float32) * pixel_scale_as


def _bracket(x, xp):
    """np.interp's interval of each x (Q,) in each row of xp (M, L),
    rows increasing: j with xp[j] <= x < xp[j + 1]; -1 left of xp[0],
    L - 1 at or right of xp[-1]."""
    q = np.broadcast_to(x, (xp.shape[0], np.shape(x)[-1])).copy()
    return torch.searchsorted(torch.from_numpy(xp), torch.from_numpy(q),
                              right=True).numpy() - 1


def _interp_rows(x, xp, j, y0, y1, y_last, left, right):
    """np.interp(x, xp[m], fp[m], left, right) for every row m, from the
    bracket j (_bracket) and fp at columns clip(j, 0, L - 2) (y0), the
    next column (y1) and L - 1 (y_last): numpy's arithmetic and branches
    (compiled_base.c arr_interp) element for element, so the same
    numbers."""
    L = xp.shape[1]
    jc = np.clip(j, 0, L - 2)
    x0 = np.take_along_axis(xp, jc, 1)
    x1 = np.take_along_axis(xp, jc + 1, 1)
    with np.errstate(all="ignore"):
        slope = (y1 - y0) / (x1 - x0)
        out = slope * (x - x0) + y0
        nan = np.isnan(out)
        if nan.any():
            # numpy tries the other end, then a flat interval's value
            alt = slope * (x - x1) + y1
            alt = np.where(np.isnan(alt) & (y0 == y1), y0, alt)
            out = np.where(nan, alt, out)
    out = np.where(x0 == x, y0, out)
    out = np.where(j == L - 1, np.where(x > xp[:, -1:], right, y_last), out)
    return np.where(j < 0, left, out)


def _sed_rows(path, z, int_av, int_rv, mw_av, mw_rv, bp: Bandpass,
              k: int = WL_CDF_K, chunk: int = 512):
    """For M objects of one SED file: each one's photon rate through
    `bp` for its magnorm-0 SED (M,) and its wavelength inverse CDF
    (M, k).  The numbers of build_object_sed -> Bandpass.photon_rate and
    _wavelength_icdf, one object at a time, computed for many at once:
    the SED (internal dust, redshift, Milky Way dust) only at the columns
    np.interp reads (the Milky Way curve once per redshift), the
    interpolations by _interp_rows, the integrals and sums row by row in
    numpy's order.  Rows go in chunks of similar redshift, whose column
    windows are alike."""
    raw = _cached_raw_sed(path)
    w0, f0 = raw.wave, raw.fphot
    L = len(w0)
    a_r, b_r = _ccm89_ab(np.ascontiguousarray(w0).tobytes())
    w, thr = bp.wave, bp.throughput
    u = np.linspace(0, 1, k)
    eps = np.arange(len(w)) * 1e-14
    rates, icdfs = np.empty(len(z)), np.empty((len(z), k))
    order = np.argsort(z, kind="stable")
    for lo in range(0, len(z), chunk):
        idx = order[lo:lo + chunk]
        s = (1.0 + z[idx])[:, None]
        iav, irv = int_av[idx, None], int_rv[idx, None]
        mav, mrv = mw_av[idx, None], mw_rv[idx, None]
        _, uq, inv = np.unique(z[idx], return_index=True, return_inverse=True)
        wobs = w0 * s

        def f_at(cols):
            # the objects' observer-frame photon densities at columns
            # `cols`: internal dust (rest frame), 1/(1+z), Milky Way dust
            # (its curve from one row per redshift: equal redshifts have
            # equal columns)
            f = f0[cols]
            f = np.where(iav == 0.0, f, f * extinction_factor(
                a_r[cols], b_r[cols], iav, irv))
            f = f / s
            a, b = ccm89_ab(1e3 / (w0[cols[uq]] * s[uq]))
            return np.where(mav == 0.0, f, f * extinction_factor(
                a[inv], b[inv], mav, mrv))

        j = _bracket(w, wobs)
        jc = np.clip(j, 0, L - 2)
        # the window of columns each row's interpolation reads (j rises
        # along the bandpass grid), evaluated once
        start = jc[:, :1]
        win = np.minimum(start + np.arange(int((jc[:, -1:] + 2 - start)
                                                 .max())), L - 1)
        fw = f_at(win)
        F = _interp_rows(w, wobs, j, np.take_along_axis(fw, jc - start, 1),
                         np.take_along_axis(fw, jc + 1 - start, 1),
                         f_at(np.full((len(s), 1), L - 1)), 0.0, 0.0)
        y = F * thr
        rates[idx] = np.trapezoid(y, w, axis=-1)
        p = np.clip(y, 0.0, None)
        with np.errstate(all="ignore"):
            cdf = np.concatenate([np.zeros((len(s), 1)), np.cumsum(
                0.5 * (p[:, 1:] + p[:, :-1]) * np.diff(w), axis=1)], axis=1)
            cdf /= cdf[:, -1:]
        xp = cdf + eps
        j = _bracket(u, xp)
        jc = np.clip(j, 0, len(w) - 2)
        icdf = _interp_rows(u, xp, j, w[jc], w[jc + 1], w[-1], w[0], w[-1])
        icdf[p.sum(axis=1) <= 0] = bp.effective_wavelength
        icdfs[idx] = icdf
    return rates, icdfs


def filter_missing_seds(table: ic.ObjectTable, sed_dirs) -> ic.ObjectTable:
    """The rows whose SED file is in one of sed_dirs, or that carry an
    inline SED (the sky catalog's skip_missing_sed: a partial SED library
    renders the objects it can)."""
    n = len(table)
    has_inline = len(getattr(table, "sed_obj", ())) == n
    keep = np.ones(n, bool)
    for i in range(n):
        if has_inline and table.sed_obj[i] is not None:
            continue
        name = str(table.sed_name[i])
        if not any(os.path.isfile(os.path.join(d, name)) for d in sed_dirs):
            keep[i] = False
    return table.select(keep)


def build_scene(table: ic.ObjectTable, bp: Bandpass, sed_dirs,
                exptime: float = 30.0, pupil_area: float = ic.RUBIN_AREA,
                rng: np.random.Generator | None = None,
                device="cuda", pad_to: int | None = None,
                max_flux: float | None = None) -> SceneHost:
    """The scene of a culled ObjectTable on `device`, with its photon
    budget: each object's SED through the bandpass gives its nominal flux
    and wavelength inverse CDF (one per (sed, z, dust) key, rounded as
    the JAX package rounds them, from the key's first object; the objects
    of one SED file together, _sed_rows), the lens magnification scales
    the flux, the realized flux is Poisson(nominal) from `rng`, then the
    FITS objects' point clouds draw from the same `rng`.  Columns are
    padded to a power of two (at least 16 rows; padded wavelength rows
    622 nm; pad_to: that many rows instead).  max_flux: objects whose
    nominal flux is above it get none (the sky catalog skips them).  Host
    numpy; the same numbers as the JAX package's loop over objects."""
    rng = rng or np.random.default_rng(0)
    n = len(table)
    wl = np.empty((n, WL_CDF_K), np.float32)
    nominal = np.empty(n)
    base = ic.object_flux(table.magnorm, pupil_area, exptime)
    has_int = len(getattr(table, "int_av", ())) == n
    has_inline = len(getattr(table, "sed_obj", ())) == n
    iav = table.int_av.tolist() if has_int else [0.0] * n
    irv = table.int_rv.tolist() if has_int else [3.1] * n
    z, mav, mrv = (table.redshift.tolist(), table.mw_av.tolist(),
                   table.mw_rv.tolist())
    # each (sed, z, dust) key's first object, in catalog order
    keys: dict = {}
    first, key_of = [], np.full(n, -1, np.int64)
    for i in range(n):
        if has_inline and table.sed_obj[i] is not None:
            # a pre-built observer-frame SED, normalized for magnorm=0
            sed = table.sed_obj[i]
            nominal[i] = base[i] * bp.photon_rate(sed.wave, sed.fphot,
                                                  1.0, 1.0)
            wl[i] = _wavelength_icdf(sed, bp)
            continue
        key = (table.sed_name[i], round(z[i], 4), round(mav[i], 3),
               round(mrv[i], 2), round(iav[i], 3), round(irv[i], 2))
        g = keys.get(key)
        if g is None:
            g = keys[key] = len(first)
            first.append(i)
        key_of[i] = g
    first = np.asarray(first, np.int64)
    rate = np.empty(len(first))
    icdf = np.empty((len(first), WL_CDF_K))
    by_file: dict = {}
    for g, i in enumerate(first):
        by_file.setdefault(table.sed_name[i], []).append(g)
    cols = (np.asarray(table.redshift, float), np.asarray(iav, float),
            np.asarray(irv, float), np.asarray(table.mw_av, float),
            np.asarray(table.mw_rv, float))
    for name, gs in by_file.items():
        gs = np.asarray(gs)
        rows = first[gs]
        rate[gs], icdf[gs] = _sed_rows(find_sed_file(name, tuple(sed_dirs)),
                                       *(c[rows] for c in cols), bp)
    kept = key_of >= 0
    # photons/s/cm^2 through the bandpass for the magnorm=0 SED; magnorm,
    # area and exptime live in `base`
    nominal[kept] = base[kept] * rate[key_of[kept]]
    wl[kept] = icdf[key_of[kept]]
    # lens magnification scales the flux by mu
    nominal = nominal * np.abs(table.mu)
    if max_flux is not None:
        nominal = np.where(nominal > float(max_flux), 0.0, nominal)
    realized = rng.poisson(np.clip(nominal, 0, None)).astype(np.float64)

    n_pad = pad_to or max(int(2 ** np.ceil(np.log2(max(n, 1)))), 16)

    def pad(a, fill=0.0):
        out = np.full(n_pad, fill, np.float32)
        out[:n] = a
        return out

    wl_pad = np.full((n_pad, WL_CDF_K), 622.0, np.float32)
    wl_pad[:n] = wl

    # FITS-postage-stamp objects -> point clouds; COL_P2 holds the index
    p2 = np.array(table.p2, float)
    clouds = [np.zeros((CLOUD_K, 2), np.float32)]
    if len(getattr(table, "image_file", [])) == n:
        for i in np.nonzero(table.obj_type == ic.FITSIMAGE)[0]:
            clouds.append(_fits_point_cloud(
                str(table.image_file[i]), float(table.p0[i]),
                float(table.p1[i]), rng))
            p2[i] = len(clouds) - 1

    scene = DeviceScene.from_columns(
        x=pad(table.x), y=pad(table.y),
        obj_type=pad(table.obj_type),
        p0=pad(table.p0), p1=pad(np.maximum(table.p1, 0.3001)),
        p2=pad(p2, 1.0), p3=pad(table.p3),
        g1=pad(table.g1), g2=pad(table.g2), mu=pad(table.mu, 1.0),
        wl_icdf=wl_pad, aux_cloud=np.stack(clouds), device=device)
    return SceneHost(scene=scene, flux=realized, nominal_flux=nominal,
                     n_objects=n,
                     pix_x=np.asarray(table.x, np.float64),
                     pix_y=np.asarray(table.y, np.float64))


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
