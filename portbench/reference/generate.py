"""The cells' inputs, made from a seed with numpy alone: the visit's
header, an SED library, the raft's objects, and the files the program
reads (a phoSim instance catalog, or a skyCatalogs mapped-schema parquet
file).

The objects are uniform on the sky over the raft's footprint (its nine
CCDs widened by `box_margin_px`), placed in the tangent plane at the
boresight through the benchmark's own frozen WCS, never the program's.
Every seed draws the same number of objects of each kind and the same
24 bright stars per CCD; only places, shapes and fluxes change.

`Objects` holds each object's columns as the program will read them
back (the instance catalog's numbers are parsed back from the text it
writes), so the reference sees what the program sees.
"""
from __future__ import annotations

import gzip
import os

import numpy as np

from . import parquet_writer
from .frozen.bandpass import rubin_bandpass
from .frozen.coords import gnomonic_deproject, gnomonic_project
from .frozen.sed import SED

DEG = np.pi / 180.0
RUBIN_AREA = np.pi * (418.0**2 - 255.0**2)       # cm^2
POINT, SERSIC, KNOTS = 0, 1, 2
N_STAR_SED, N_GAL_SED = 200, 100
_STAR_LINES = (393.4, 396.8, 434.05, 486.13, 517.3, 589.3, 656.28, 849.8,
               854.2, 866.2)
_GAL_LINES = (372.7, 486.1, 495.9, 500.7, 656.3, 658.4, 671.6)
BANDS = "ugrizy"


def rng_for(seed: int, *stream) -> np.random.Generator:
    """A generator for one stream of a seed (any whole number)."""
    return np.random.default_rng([int(seed) % 2**63, *stream])


def header(cfg: dict, seed: int) -> dict:
    """The visit's phoSim header keys (the config's `visit`), with the
    program's random seed drawn from `seed`."""
    h = dict(cfg["visit"])
    h["seed"] = int(seed) % 2**31
    return h


# ---- SEDs ------------------------------------------------------------------

def _write_sed(path, wave, flam):
    """Two columns, nm and f_lambda; gzip with a fixed header time."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    text = "".join(f"{w:.1f} {f:.7e}\n" for w, f in zip(wave, flam))
    with open(path, "wb") as raw, gzip.GzipFile(fileobj=raw, mode="wb",
                                                mtime=0) as fd:
        fd.write(text.encode())


def sed_library(sed_dir: str, rng: np.random.Generator):
    """200 star SEDs (blackbodies 3,000-30,000 K with absorption lines,
    300-1200 nm) and 100 galaxy SEDs (power laws with a 400 nm break and
    emission lines, 90-1200 nm in the rest frame, so that redshift 2.5
    still covers y) under sed_dir.  Returns (star names, galaxy names,
    {name: (wave, f_lambda)}) as written (the text's own rounding)."""
    stars, gals, table = [], [], {}
    w = np.arange(300.0, 1200.5, 1.0)
    for i in range(N_STAR_SED):
        T = 3000.0 * 10 ** (i / (N_STAR_SED - 1))
        x = 1.4388e7 / (w * T)
        flam = w ** -5 / np.expm1(x)
        depth = rng.uniform(0.05, 0.5, len(_STAR_LINES))
        for c, d in zip(_STAR_LINES, depth):
            flam = flam * (1.0 - d * np.exp(-0.5 * ((w - c) / 1.5) ** 2))
        name = f"starSED/synth/star_{i:03d}_{int(T)}K.txt.gz"
        stars.append(name)
        table[name] = (w, flam / flam.max())
    wg = np.arange(90.0, 1200.5, 1.0)
    for i in range(N_GAL_SED):
        beta = rng.uniform(-2.2, 0.8)
        brk = rng.uniform(1.0, 3.0)
        flam = (wg / 500.0) ** beta / (
            1.0 + (brk - 1.0) / (1.0 + np.exp((wg - 400.0) / 5.0)))
        ew = np.exp(rng.uniform(np.log(0.5), np.log(20.0), len(_GAL_LINES)))
        for c, e in zip(_GAL_LINES, ew):
            cont = (c / 500.0) ** beta
            flam = flam + cont * e / (0.5 * np.sqrt(2 * np.pi)) * np.exp(
                -0.5 * ((wg - c) / 0.5) ** 2)
        name = f"galaxySED/synth/gal_{i:03d}.txt.gz"
        gals.append(name)
        table[name] = (wg, flam / flam.max())
    out = {}
    for name, (wave, flam) in table.items():
        _write_sed(os.path.join(sed_dir, name), wave, flam)
        # the numbers as the file holds them
        out[name] = (np.round(wave, 1), np.array([float(f"{f:.7e}")
                                                  for f in flam]))
    return stars, gals, out


def magnorm0_sed(wave, flam) -> SED:
    return SED.from_flambda(wave, flam).normalized_magnorm0()


def _rates(seds: dict, names, bandpass, z_grid):
    """Photons/s/cm^2 through `bandpass` of each magnorm-0 SED at each
    redshift of z_grid: (len(names), len(z_grid))."""
    out = np.empty((len(names), len(z_grid)))
    for i, name in enumerate(names):
        sed = magnorm0_sed(*seds[name])
        for j, z in enumerate(z_grid):
            s = sed.at_redshift(z)
            out[i, j] = bandpass.photon_rate(s.wave, s.fphot, 1.0, 1.0)
    return out


# ---- the raft's objects ----------------------------------------------------

class Objects(dict):
    """Column name -> (n,) array; `n` objects."""

    @property
    def n(self) -> int:
        return len(self["ra"])

    def take(self, idx) -> "Objects":
        return Objects({k: v[idx] for k, v in self.items()})


def _footprint(wcs_by_det, camera, bore, margin):
    """The raft's box in the boresight's tangent plane: (origin, unit
    vectors u, v along the CCDs' x and y, sizes along them [rad], its
    area in CCD pixels, the pixel's size [rad])."""
    pts = []
    for det, wcs in wcs_by_det.items():
        ccd = camera[det]
        nx, ny = ccd.bounds.width, ccd.bounds.height
        xs = np.array([-margin, nx + margin, nx + margin, -margin], float)
        ys = np.array([-margin, -margin, ny + margin, ny + margin], float)
        ra, dec = wcs.xy_to_radec(xs, ys)
        pts.append(np.stack(gnomonic_project(ra, dec, *bore), -1))
    pts = np.concatenate(pts)
    det0 = next(iter(wcs_by_det))
    ccd = camera[det0]
    ra, dec = wcs_by_det[det0].xy_to_radec(
        np.array([0.0, ccd.bounds.width]), np.array([0.0, 0.0]))
    ex = np.diff(np.stack(gnomonic_project(ra, dec, *bore), -1), axis=0)[0]
    px = np.hypot(*ex) / ccd.bounds.width           # rad per pixel
    u = ex / np.hypot(*ex)
    v = np.array([-u[1], u[0]])
    a, b = pts @ u, pts @ v
    origin = a.min() * u + b.min() * v
    size = np.array([a.max() - a.min(), b.max() - b.min()])
    return origin, u, v, size, float(np.prod(size) / px**2), px


class _Boxes:
    """The CCDs' cull boxes (the frame widened by `edge` px): which sky
    places fall inside.  A box's extent in the boresight's tangent plane
    sorts out the places far from its edges; the rest take the exact
    test through the CCD's WCS."""

    def __init__(self, wcs_by_det, camera, bore, edge, u, v, px):
        self.bore, self.edge, self.u, self.v = bore, edge, u, v
        self.slop = 5.0 * px
        self.items = {}
        for det, wcs in wcs_by_det.items():
            ccd = camera[det]
            nx, ny = ccd.bounds.width, ccd.bounds.height
            xs = np.array([-edge, nx + edge, nx + edge, -edge])
            ys = np.array([-edge, -edge, ny + edge, ny + edge])
            xi, eta = gnomonic_project(*wcs.xy_to_radec(xs, ys), *bore)
            a, b = xi * u[0] + eta * u[1], xi * v[0] + eta * v[1]
            self.items[det] = (wcs, ccd, a.min(), a.max(), b.min(), b.max())

    def inside(self, ra, dec, dets) -> np.ndarray:
        xi, eta = gnomonic_project(ra, dec, *self.bore)
        a = xi * self.u[0] + eta * self.u[1]
        b = xi * self.v[0] + eta * self.v[1]
        res = np.zeros(len(a), bool)
        d = self.slop
        for det in dets:
            wcs, ccd, a0, a1, b0, b1 = self.items[det]
            wide = (a > a0 - d) & (a < a1 + d) & (b > b0 - d) & (b < b1 + d)
            sure = (a > a0 + d) & (a < a1 - d) & (b > b0 + d) & (b < b1 - d)
            res |= sure
            near = np.nonzero(wide & ~sure & ~res)[0]
            if len(near):
                x, y = wcs.radec_to_xy(ra[near], dec[near])
                e = self.edge
                res[near] |= ((x >= -e) & (x <= ccd.bounds.width + e)
                              & (y >= -e) & (y <= ccd.bounds.height + e))
        return res


def _places(rng, cfg, wcs_by_det, camera, bore, footprint):
    """Uniform places on the sky, the same counts for every seed: per CCD
    its `bright_per_ccd` bright stars and its frame's share inside the
    frame; the band of its cull box around the frame, split where
    neighbouring boxes overlap, each part its share; the rest of the
    footprint (gaps, outer margin) the remainder.  Returns (ra, dec
    [rad], region per object (0 the bright stars, -1 the rest), {region:
    area [px]}): every CCD's cull box is a union of whole regions."""
    oc = cfg["objects"]
    edge = float(cfg["check"]["edge_pix"])
    origin, u, v, size, area_px, px = footprint
    boxes = _Boxes(wcs_by_det, camera, bore, edge, u, v, px)
    dens = oc["per_ccd_box"] / ((oc["ccd_nx"] + 2 * oc["box_margin_px"])
                                * (oc["ccd_ny"] + 2 * oc["box_margin_px"]))
    parts, area = [], {-1: area_px, 0: 0.0}
    dets = list(wcs_by_det)
    for k, det in enumerate(dets):
        wcs = wcs_by_det[det]
        nx, ny = camera[det].bounds.width, camera[det].bounds.height

        def label(x, y):
            # -2: the frame, or a part an earlier CCD's box holds (that
            # CCD sampled it); -1: the band no other box reaches; j: the
            # part the later CCD j's box overlaps (neighbouring boxes
            # overlap in the gaps)
            ring = ~((x >= -0.5) & (x < nx - 0.5) & (y >= -0.5)
                     & (y < ny - 0.5))
            ra, dec = wcs.xy_to_radec(x, y)
            lab = np.where(ring & ~boxes.inside(ra, dec, dets[:k]), -1, -2)
            for jj in range(k + 1, len(dets)):
                lab[(lab == -1) & boxes.inside(ra, dec, [dets[jj]])] = jj
            return lab

        m = oc["bright_per_ccd"]
        parts.append((*wcs.xy_to_radec(rng.uniform(-0.5, nx - 0.5, m),
                                       rng.uniform(-0.5, ny - 0.5, m)), 0))
        a_in = nx * ny
        n_in = int(round(dens * a_in))
        region_id = len(area)
        parts.append((*wcs.xy_to_radec(rng.uniform(-0.5, nx - 0.5, n_in),
                                       rng.uniform(-0.5, ny - 0.5, n_in)),
                      region_id))
        area[region_id] = a_in
        area[-1] -= a_in
        # the four strips of the box around the frame, by their areas;
        # each part's area from a fixed 20 px grid over them (the same
        # for every seed)
        strips = np.array([[-edge, nx + edge, -edge, -0.5],
                           [-edge, nx + edge, ny - 0.5, ny + edge],
                           [-edge, -0.5, -0.5, ny - 0.5],
                           [nx - 0.5, nx + edge, -0.5, ny - 0.5]])
        w = (strips[:, 1] - strips[:, 0]) * (strips[:, 3] - strips[:, 2])
        gx, gy = np.meshgrid(np.arange(-edge + 10, nx + edge, 20.0),
                             np.arange(-edge + 10, ny + edge, 20.0))
        glab = label(gx.ravel(), gy.ravel())
        for lab in sorted(set(glab.tolist()) - {-2}):
            a_part = 400.0 * np.sum(glab == lab)
            n_part = int(round(dens * a_part))
            bx, by = [], []
            while sum(map(len, bx)) < n_part:
                c = rng.choice(4, size=4 * n_part + 64, p=w / w.sum())
                x = rng.uniform(strips[c, 0], strips[c, 1])
                y = rng.uniform(strips[c, 2], strips[c, 3])
                keep = label(x, y) == lab
                bx.append(x[keep])
                by.append(y[keep])
            region_id = len(area)
            parts.append((*wcs.xy_to_radec(np.concatenate(bx)[:n_part],
                                           np.concatenate(by)[:n_part]),
                          region_id))
            area[region_id] = a_part
            area[-1] -= a_part
    n_rest = int(round(dens * area[-1]))
    got, ra_r, dec_r = 0, [], []
    while got < n_rest:
        s = rng.uniform(0, 1, (2 * n_rest, 2)) * size
        p = origin + s[:, :1] * u + s[:, 1:] * v
        ra, dec = gnomonic_deproject(p[:, 0], p[:, 1], *bore)
        keep = ~boxes.inside(ra, dec, dets)
        ra_r.append(ra[keep])
        dec_r.append(dec[keep])
        got += int(keep.sum())
    parts.append((np.concatenate(ra_r)[:n_rest],
                  np.concatenate(dec_r)[:n_rest], -1))
    order = sorted(range(len(parts)), key=lambda k: parts[k][2] != 0)
    ra = np.concatenate([parts[k][0] for k in order])
    dec = np.concatenate([parts[k][1] for k in order])
    region = np.concatenate([np.full(len(parts[k][0]), parts[k][2])
                             for k in order])
    return ra, dec, region, area


def draw_objects(cfg: dict, seed: int, wcs_by_det, camera, rates,
                 sed_names) -> Objects:
    """The raft's objects from `seed`: the config's density and mix over
    the footprint with fixed counts per region (_places), fluxes
    (`flux0`) normalized to `photons_per_px` over each region's area (a
    CCD's frame and the band around it get the same photons for every
    seed, so the pile-up of out-of-frame photons does too), the bright
    stars' from `bright_log_flux`, and magnorms from each SED's rate at
    the object's redshift (dust left out).  Columns are full precision;
    writers round them."""
    oc = cfg["objects"]
    h = cfg["visit"]
    bore = (h["rightascension"] * DEG, h["declination"] * DEG)
    rng = rng_for(seed, 1)
    ra, dec, region, area = _places(
        rng, cfg, wcs_by_det, camera, bore,
        _footprint(wcs_by_det, camera, bore, oc["box_margin_px"]))
    n = len(ra)
    n_bright = int(np.sum(region == 0))

    mix = oc["mix"]
    t = rng.uniform(0, 1, n)
    kind = np.where(t < mix["point"], POINT,
                    np.where(t < mix["point"] + mix["sersic2d"], SERSIC,
                             KNOTS))
    kind[:n_bright] = POINT
    gal = kind != POINT
    hlr = np.clip(rng.lognormal(np.log(0.35), 0.6, n), 0.05, 3.0)
    n_s = np.clip(rng.normal(1.5, 0.9, n), 0.3, 6.2)
    q = rng.uniform(0.3, 1.0, n)
    pa = np.degrees(rng.uniform(0, np.pi, n))
    gamma = np.where(gal[:, None], rng.normal(0, 0.02, (n, 2)), 0.0)
    kappa = np.where(gal, rng.normal(0, 0.01, n), 0.0)
    n_star, n_gal = len(sed_names[0]), len(sed_names[1])
    sed_idx = np.where(gal, rng.integers(0, n_gal, n),
                       rng.integers(0, n_star, n))
    z_lo, z_hi = cfg["seds"]["z_range"]
    z = np.where(gal, rng.uniform(z_lo, z_hi, n), 0.0)
    int_av = np.where(gal, rng.uniform(0.0, 0.5, n), 0.0)
    mw_av = rng.uniform(0.0, 0.3, n)
    # the skyCatalogs components: disk and bulge shapes and shares
    bulge_frac = rng.uniform(0.0, 0.6, n)
    bulge_a = rng.uniform(0.2, 0.6, n)
    bulge_q = rng.uniform(0.5, 1.0, n)
    n_bulge = np.clip(rng.normal(3.5, 0.6, n), 1.5, 6.0)
    n_knots = rng.integers(5, 41, n)
    knots_ratio = rng.uniform(0.1, 0.4, n)

    flux = 10 ** rng.uniform(0.0, 2.4, n) ** 1.35
    for r, a in area.items():
        sel = region == r
        if r == 0 or not sel.any():
            continue
        flux[sel] *= oc["photons_per_px"] * a / flux[sel].sum()
    flux[:n_bright] = 10 ** rng.uniform(*oc["bright_log_flux"], n_bright)
    # magnorm from the SED's rate at the object's redshift
    rate_star, rate_gal, z_grid = rates
    f = z / z_grid[1]
    j = np.minimum(f.astype(int), len(z_grid) - 2)
    kg = np.where(gal, sed_idx, 0)
    rate = np.where(gal, rate_gal[kg, j] * (j + 1 - f)
                    + rate_gal[kg, j + 1] * (f - j),
                    rate_star[np.where(gal, 0, sed_idx)])
    exptime = float(h["vistime"])
    magnorm = -np.log(flux / (RUBIN_AREA * exptime * np.maximum(rate, 1e-30))
                      ) / 0.9210340371976184
    sed = np.where(gal, np.asarray(sed_names[1], object)[np.minimum(
        sed_idx, n_gal - 1)], np.asarray(sed_names[0], object)[
            np.minimum(sed_idx, n_star - 1)])
    return Objects(
        id=np.arange(n, dtype=np.int64), ra=np.degrees(ra) % 360.0,
        dec=np.degrees(dec), kind=kind.astype(np.int64), magnorm=magnorm,
        sed=sed, z=z, int_av=int_av, mw_av=mw_av, hlr=hlr, n_s=n_s, q=q,
        pa=pa, g1=gamma[:, 0], g2=gamma[:, 1], kappa=kappa,
        bright=np.arange(n) < n_bright, bulge_frac=bulge_frac,
        bulge_a=bulge_a, bulge_q=bulge_q, n_bulge=n_bulge,
        n_knots=n_knots.astype(np.int64), knots_ratio=knots_ratio,
        flux0=flux)


def sed_rates(seds, names, band: str, airmass: float):
    """(star rates (n_star,), galaxy rates (n_gal, 51), z grid) through
    the band's synthetic Rubin bandpass."""
    bp = rubin_bandpass(band, airmass=airmass)
    z_grid = np.linspace(0.0, 2.5, 51)
    return (_rates(seds, names[0], bp, z_grid[:1])[:, 0],
            _rates(seds, names[1], bp, z_grid), z_grid)


# ---- the instance catalog --------------------------------------------------

def _fmt(fmt: str, a) -> np.ndarray:
    return np.char.mod(fmt, np.asarray(a))


def write_instcat(path: str, head: dict, objs: Objects) -> Objects:
    """The phoSim instance catalog of `objs` at `path` (header, then one
    `object` line each: point, sersic2d or knots, internal and Milky Way
    CCM dust); returns the objects with their numbers as the text holds
    them."""
    n = objs.n
    col = {"ra": _fmt("%.7f", objs["ra"]), "dec": _fmt("%.7f", objs["dec"]),
           "magnorm": _fmt("%.4f", objs["magnorm"]),
           "z": _fmt("%.4f", objs["z"]), "g1": _fmt("%.5f", objs["g1"]),
           "g2": _fmt("%.5f", objs["g2"]),
           "kappa": _fmt("%.5f", objs["kappa"]),
           "int_av": _fmt("%.3f", objs["int_av"]),
           "mw_av": _fmt("%.3f", objs["mw_av"])}
    gal = objs["kind"] != POINT
    a = objs["hlr"] / np.sqrt(objs["q"])
    b = objs["hlr"] * np.sqrt(objs["q"])
    last = np.where(objs["kind"] == SERSIC, _fmt("%.3f", objs["n_s"]), "30")
    shape = np.where(
        gal, np.char.add(np.char.add(np.char.add(np.char.add(
            np.where(objs["kind"] == SERSIC, "sersic2d ", "knots "),
            _fmt("%.4f ", a)), _fmt("%.4f ", b)),
            _fmt("%.3f ", objs["pa"])), last), "point")
    dust = np.where(gal, np.char.add(np.char.add(
        np.char.add("CCM ", col["int_av"]), " 3.1 CCM "), col["mw_av"]),
        np.char.add("none CCM ", col["mw_av"]))
    ids = objs["id"].astype(str)
    lines = [f"object {ids[i]} {col['ra'][i]} {col['dec'][i]} "
             f"{col['magnorm'][i]} {objs['sed'][i]} {col['z'][i]} "
             f"{col['g1'][i]} {col['g2'][i]} {col['kappa'][i]} 0 0 "
             f"{shape[i]} {dust[i]} 3.1\n" for i in range(n)]
    with open(path, "w") as f:
        f.write("".join(f"{k} {v}\n" for k, v in head.items()))
        f.write("".join(lines))
    out = Objects(objs)
    for k, v in col.items():
        out[k] = v.astype(float)
    return out


# ---- the skyCatalogs mapped schema -----------------------------------------

def write_mapped_parquet(path: str, objs: Objects, rng) -> Objects:
    """The mapped (DC2) schema at full width: one row per object, the
    galaxies with their bulge, disk and (on the knots kind) knots
    columns, a few null fields so that the fallbacks run.  Returns the
    objects with the columns the reference needs (float64, exact in the
    file)."""
    n = objs.n
    gal = objs["kind"] != POINT
    knotty = objs["kind"] == KNOTS
    galf = np.where(gal, 1.0, np.nan)
    disk_a = objs["hlr"] / np.sqrt(objs["q"])
    disk_q = objs["q"]
    bulge_a = disk_a * objs["bulge_a"]
    n_knots = np.where(knotty, objs["n_knots"], 0).astype(float)
    knots_ratio = np.where(knotty, objs["knots_ratio"], 0.0)
    k_null = max(1, n // 6000)

    def nulls(a):
        a = np.array(a, float)
        a[rng.choice(n, size=min(k_null, n), replace=False)] = np.nan
        return a

    cols = {
        "id": objs["id"], "ra": objs["ra"], "dec": objs["dec"],
        "object_type": np.where(gal, "galaxy", "star").astype(object),
        "magnorm": objs["magnorm"], "sed_filepath": objs["sed"],
        "redshift": objs["z"],
        "shear_1": objs["g1"], "shear_2": objs["g2"],
        "convergence": objs["kappa"],
        "MW_av": objs["mw_av"], "MW_rv": np.full(n, 3.1),
        "size_true": np.where(gal, disk_a * np.sqrt(disk_q), 0.0),
        "sersic_index": np.where(gal, np.clip(objs["n_s"], 0.5, 2.0), 1.0),
        "axis_ratio": np.where(gal, disk_q, 1.0),
        "position_angle": np.where(gal, objs["pa"], 0.0),
        "size_bulge_true": bulge_a * galf,
        "size_minor_bulge_true": bulge_a * objs["bulge_q"] * galf,
        "sersic_bulge": nulls(objs["n_bulge"] * galf),
        "size_disk_true": disk_a * galf,
        "size_minor_disk_true": nulls(disk_a * disk_q * galf),
        "sersic_disk": np.clip(objs["n_s"], 0.5, 2.0) * galf,
        "bulge_frac": objs["bulge_frac"] * galf,
        "knots_flux_ratio": nulls(knots_ratio * galf),
        "n_knots": n_knots * galf,
    }
    parquet_writer.write_parquet(path, cols, dictionary=("sed_filepath",))
    out = Objects(objs)
    out["int_av"] = np.zeros(n)
    for k in ("size_bulge_true", "size_disk_true", "bulge_frac",
              "knots_flux_ratio", "n_knots"):
        out[k] = cols[k]
    return out
