"""The instance-catalog workload, generated from a seed: a phoSim
instance catalog for one CCD (R22_S11 by default) with its visit header,
and the SED library its objects name.

    python -m imsim_tpu_torch.benchmarks.instcat_workload OUT_DIR [--seed 0]

writes OUT_DIR/instcat_r.txt, its y-band copy OUT_DIR/instcat_y.txt
(`filter 5`) and OUT_DIR/seds/{starSED,galaxySED}/... (`--dets
R22_S11,R10_S11` appends 120,000 lines over each further CCD from its
own seed stream; the first CCD's lines and the default file stay as
they are):

  * the header of examples/example_instance_catalog.txt:1-9 (the bench
    pointing: (30, -20) deg, mjd 60674.2, seeing 0.7, 30 s, rotator 0,
    altitude 60) with moon and sun keys, so the sky model's moon term is
    on;
  * 120,000 `object` lines, uniform over the CCD's pixel box widened by
    300 px per side and mapped to RA/Dec through the port's own WCS of
    that CCD at this visit (about 1e5 survive the runner's 100-px cull):
    25% point, 65% sersic2d, 10% knots, with the bench's size, index,
    axis-ratio and angle draws (a >= b); magnorms set so the objects in
    the cull box would carry 1.6e8 photons in r before dust and the
    redshifted SEDs' own dimming, about 1e8 after (the bench pooled
    1.12e8)
    and 24 stars of 1e7-4e7 photons (above the FFT threshold at this
    visit's seeing); galaxies at continuous redshift (0.05-2.5, 4 decimals)
    with internal dust, every object with Milky Way CCM dust (A_V 0-0.3,
    3 decimals);
  * 200 star SEDs (blackbodies, 3,000-30,000 K, with absorption lines;
    300-1200 nm) and 100 galaxy SEDs (power laws with a 400 nm break and
    emission lines; 90-1200 nm in the rest frame, so that redshift 2.5
    still covers y), gzipped two-column text.

`window=(h, w)` puts the objects over the CCD's central h x w window
widened by `margin` instead (rehearsals and tests).  Nothing of the
workload is committed; it is written where the caller says.
"""
from __future__ import annotations

import argparse
import gzip
import hashlib
import os

import numpy as np

HEADER = (("rightascension", "30.0"), ("declination", "-20.0"),
          ("mjd", "60674.2"), ("filter", "2"), ("seeing", "0.7"),
          ("vistime", "30.0"), ("rottelpos", "0.0"),
          ("obshistid", "181000"), ("altitude", "60.0"),
          ("moonra", "100.0"), ("moondec", "10.0"), ("moonalt", "20.0"),
          ("moonphase", "30.0"), ("sunalt", "-35.0"))
N_STAR_SED, N_GAL_SED = 200, 100
# the bright stars [photons]: bench.py's 1e6-2e7 moved up by 10^0.7, so
# that each crosses the 2e5 e-/px FFT threshold at this visit's FWHMeff
# (0.98 arcsec against the bench's 0.7)
BRIGHT_LOG_FLUX = (7.0, 7.6)
_STAR_LINES = (393.4, 396.8, 434.05, 486.13, 517.3, 589.3, 656.28, 849.8,
               854.2, 866.2)
_GAL_LINES = (372.7, 486.1, 495.9, 500.7, 656.3, 658.4, 671.6)


def _write_sed(path, wave, flam):
    """Two columns, nm and f_lambda; gzip with a fixed header time so the
    bytes follow from the seed."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    text = "".join(f"{w:.1f} {f:.7e}\n" for w, f in zip(wave, flam))
    with open(path, "wb") as raw, gzip.GzipFile(fileobj=raw, mode="wb",
                                                mtime=0) as fd:
        fd.write(text.encode())


def write_sed_library(sed_dir: str, rng: np.random.Generator):
    """The star and galaxy SEDs under sed_dir; returns their names (as the
    catalog names them)."""
    stars, gals = [], []
    w = np.arange(300.0, 1200.5, 1.0)
    for i in range(N_STAR_SED):
        T = 3000.0 * 10 ** (i / (N_STAR_SED - 1))
        x = 1.4388e7 / (w * T)                     # hc / (lambda k T)
        flam = w ** -5 / np.expm1(x)
        depth = rng.uniform(0.05, 0.5, len(_STAR_LINES))
        for c, d in zip(_STAR_LINES, depth):
            flam = flam * (1.0 - d * np.exp(-0.5 * ((w - c) / 1.5) ** 2))
        name = f"starSED/synth/star_{i:03d}_{int(T)}K.txt.gz"
        _write_sed(os.path.join(sed_dir, name), w, flam / flam.max())
        stars.append(name)
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
        _write_sed(os.path.join(sed_dir, name), wg, flam / flam.max())
        gals.append(name)
    return stars, gals


def _rates(names, sed_dir, bandpass, z_grid):
    """Photon rate [photons/s/cm^2] through `bandpass` of each SED at
    magnorm 0, at each redshift of z_grid: (len(names), len(z_grid))."""
    from ..catalog.sed import _cached_raw_sed

    out = np.empty((len(names), len(z_grid)))
    for i, name in enumerate(names):
        sed = _cached_raw_sed(os.path.join(sed_dir, name))
        for j, z in enumerate(z_grid):
            s = sed.at_redshift(z)
            out[i, j] = bandpass.photon_rate(s.wave, s.fphot, 1.0, 1.0)
    return out


def visit_context(catalog: str, sed_dir: str, over: dict | None = None):
    """config.runner.build_visit_context of a visit over `catalog`: the
    instance-catalog template with the catalog and its SED library, and
    `over` (dotted keys)."""
    from ..config.interpreter import load_config
    from ..config.runner import build_visit_context

    return build_visit_context(load_config({
        "template": "imsim-config-instcat",
        "input.instance_catalog.file_name": catalog,
        "input.instance_catalog.sed_dir": sed_dir, **(over or {})}))


def _object_lines(rng, ctx, det_name, window, n, margin, n_bright,
                  total_photons, edge_pix, stars, gals, rate_star, rate_gal,
                  z_grid, id0=0):
    """`n` object lines over one CCD's box (or its central window) widened
    by `margin`, drawn from `rng`, ids from id0."""
    from ..catalog.instcat import RUBIN_AREA
    from ..convert import ccd_optics

    ccd = ctx.camera[det_name]
    nx, ny = ccd.bounds.width, ccd.bounds.height
    wcs = ccd_optics(ctx.wcs_factory, ccd)[0]
    # the box the objects fill, in the CCD's pixels
    if window is None:
        x0, y0, w, h = 0.0, 0.0, float(nx), float(ny)
    else:
        h, w = (float(v) for v in window)
        x0, y0 = (nx - w) / 2, (ny - h) / 2

    t = rng.uniform(0, 1, n)
    kind = np.where(t < 0.25, 0, np.where(t < 0.90, 1, 2))
    kind[:n_bright] = 0
    x = rng.uniform(x0 - margin, x0 + w + margin, n)
    y = rng.uniform(y0 - margin, y0 + h + margin, n)
    # the bright stars sit in the frame
    x[:n_bright] = rng.uniform(x0, x0 + w, n_bright)
    y[:n_bright] = rng.uniform(y0, y0 + h, n_bright)
    ra, dec = wcs.xy_to_radec(x, y)
    ra, dec = np.degrees(ra) % 360.0, np.degrees(dec)
    hlr = np.clip(rng.lognormal(np.log(0.35), 0.6, n), 0.05, 3.0)
    n_s = np.clip(rng.normal(1.5, 0.9, n), 0.3, 6.2)
    q = rng.uniform(0.3, 1.0, n)
    pa = np.degrees(rng.uniform(0, np.pi, n))
    gal = kind > 0
    gamma = np.where(gal[:, None], rng.normal(0, 0.02, (n, 2)), 0.0)
    kappa = np.where(gal, rng.normal(0, 0.01, n), 0.0)
    sed_idx = np.where(gal, rng.integers(0, N_GAL_SED, n),
                       rng.integers(0, N_STAR_SED, n))
    z = np.where(gal, np.round(rng.uniform(0.05, 2.5, n), 4), 0.0)
    int_av = np.round(rng.uniform(0.0, 0.5, n), 3)
    mw_av = np.round(rng.uniform(0.0, 0.3, n), 3)

    # fluxes: bench.py's draw, normalized over the objects the cull keeps
    raw = 10 ** rng.uniform(0.0, 2.4, n) ** 1.35
    kept = ((x >= x0 - edge_pix) & (x <= x0 + w + edge_pix)
            & (y >= y0 - edge_pix) & (y <= y0 + h + edge_pix))
    flux = raw / raw[kept].sum() * total_photons
    flux[:n_bright] = 10 ** rng.uniform(*BRIGHT_LOG_FLUX, n_bright)
    # magnorm from the SED's r-band rate at the object's redshift (dust
    # left out: the total lands within a factor 2 of total_photons)
    f = z / z_grid[1]
    j = np.minimum(f.astype(int), len(z_grid) - 2)
    k = np.where(gal, sed_idx, 0)
    rate = np.where(gal, rate_gal[k, j] * (j + 1 - f) + rate_gal[k, j + 1]
                    * (f - j), rate_star[np.where(gal, 0, sed_idx)])
    exptime = float(ctx.opsim.get("exptime", 30.0))
    magnorm = -np.log(flux / (RUBIN_AREA * exptime * np.maximum(rate, 1e-30))
                      ) / 0.9210340371976184

    a = hlr / np.sqrt(q)
    b = hlr * np.sqrt(q)
    lines = []
    for i in range(n):
        if kind[i] == 0:
            shape = "point"
            sed = stars[sed_idx[i]]
            dust = f"none CCM {mw_av[i]:.3f} 3.1"
        else:
            last = f"{n_s[i]:.3f}" if kind[i] == 1 else "30"
            shape = (f"{'sersic2d' if kind[i] == 1 else 'knots'} "
                     f"{a[i]:.4f} {b[i]:.4f} {pa[i]:.3f} {last}")
            sed = gals[sed_idx[i]]
            dust = f"CCM {int_av[i]:.3f} 3.1 CCM {mw_av[i]:.3f} 3.1"
        lines.append(
            f"object {id0 + i} {ra[i]:.7f} {dec[i]:.7f} {magnorm[i]:.4f} "
            f"{sed} {z[i]:.4f} {gamma[i, 0]:.5f} {gamma[i, 1]:.5f} "
            f"{kappa[i]:.5f} 0 0 {shape} {dust}\n")
    return "".join(lines)


def write_workload(out_dir: str, seed: int = 0, n_lines: int = 120_000,
                   det_name: str = "R22_S11", margin: float = 300.0,
                   window=None, n_bright: int = 24,
                   total_photons: float = 1.6e8, edge_pix: float = 100.0,
                   more_dets=()):
    """Write the workload; returns dict(catalog={band: path},
    sed_dir, sha256={band: hex digest of the catalog's bytes}).
    more_dets: further CCDs, each with n_lines lines over its own box
    (never a window) from its own seed stream, appended after
    det_name's lines, which stay as they are."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    sed_dir = os.path.join(out_dir, "seds")
    stars, gals = write_sed_library(sed_dir, rng)
    head = "".join(f"{k} {v}\n" for k, v in HEADER)
    path_r = os.path.join(out_dir, "instcat_r.txt")
    with open(path_r, "w") as f:
        f.write(head)
    ctx = visit_context(path_r, sed_dir)
    z_grid = np.linspace(0.0, 2.5, 51)
    rate_star = _rates(stars, sed_dir, ctx.bandpass, z_grid[:1])[:, 0]
    rate_gal = _rates(gals, sed_dir, ctx.bandpass, z_grid)
    common = (stars, gals, rate_star, rate_gal, z_grid)
    body = _object_lines(rng, ctx, det_name, window, n_lines, margin,
                         n_bright, total_photons, edge_pix, *common)
    for k, det in enumerate(more_dets, start=1):
        body += _object_lines(np.random.default_rng((seed, k)), ctx, det,
                              None, n_lines, margin, n_bright,
                              total_photons, edge_pix, *common,
                              id0=k * n_lines)
    out = dict(catalog={}, sed_dir=sed_dir, sha256={})
    for band, filt in (("r", "2"), ("y", "5")):
        text = head.replace("filter 2\n", f"filter {filt}\n") + body
        path = os.path.join(out_dir, f"instcat_{band}.txt")
        with open(path, "w") as f:
            f.write(text)
        out["catalog"][band] = path
        out["sha256"][band] = hashlib.sha256(text.encode()).hexdigest()
    return out


# ---- the digest of a CCD's preparation (chip_smoke gate (o)) -------------

DIGEST = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "instcat_r22_s11_digest.npz")
# objects sampled evenly over the magnitude order: N_SAMPLE for the
# nominal flux and wavelength rows, N_ANGLES for the field angles
N_SAMPLE, N_ANGLES = 256, 16384


def _np(a):
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def prep_digest(ctx, prep, pieces, modes, band: str) -> dict:
    """The leaves gate (o) holds, keyed `{band}.name`, from either
    package's prepare_ccd / sky-noise pieces (duck-typed: numpy, JAX or
    torch arrays) and its own classify_objects `modes`: the kept count
    and ids (sha256), the realized-flux sum, nominal flux and wavelength
    rows of N_SAMPLE objects and the field angles of N_ANGLES, spread
    over the magnitude order, the sky level and its float64 gradient
    plane, the mode counts and the fringe map's mean and standard
    deviation."""
    from ..image.sky import SkyGradient

    host = prep.host
    n = host.n_objects
    ids = "\n".join(str(i) for i in prep.table.id)
    sample = np.unique(np.linspace(0, n - 1, N_SAMPLE).astype(np.int64))
    angles = np.unique(np.linspace(0, n - 1, N_ANGLES).astype(np.int64))
    params = _np(host.scene.params)
    sg = SkyGradient(ctx.sky_model, prep.wcs, prep.ra_c, prep.dec_c,
                     prep.pcfg.xsize)
    fringe = None if pieces is None else pieces[4]
    fr = np.full(2, np.nan) if fringe is None else np.array(
        [float(_np(fringe).mean(dtype=np.float64)),
         float(_np(fringe).std(dtype=np.float64))])
    d = dict(n_kept=np.int64(n),
             ids_sha256=hashlib.sha256(ids.encode()).hexdigest(),
             realized_sum=np.float64(np.sum(host.flux[:n])),
             sample=sample,
             sample_nominal=np.asarray(host.nominal_flux, np.float64)[sample],
             sample_wl=_np(host.scene.wl_icdf)[sample],
             angles=angles, thx=params[angles, 0].copy(),
             thy=params[angles, 1].copy(),
             sky_level=np.float64(prep.sky_level),
             gradient=np.array([sg.a, sg.b, sg.c]) / sg.sky_level_center,
             mode_counts=np.bincount(np.asarray(modes, np.int64),
                                     minlength=3),
             fringe=fr)
    return {f"{band}.{k}": v for k, v in d.items()}


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def digest_mismatches(got: dict, want: dict, band: str,
                      fringe_rel: float = 1e-6) -> tuple[dict, dict]:
    """Gate (o)'s bars, leaf by leaf: the kept count, ids, realized sum
    and mode counts exactly; the sampled nominal fluxes and wavelength
    rows bit-equal; the field angles within 1 float32 ulp; the sky level
    and gradient to 1e-12 relative; the fringe map's mean and standard
    deviation to `fringe_rel`.  Returns ({leaf: reason}, {leaf: measured
    gap})."""
    bad, gaps = {}, {}

    def k(name):
        return f"{band}.{name}"

    for name in ("n_kept", "ids_sha256", "realized_sum"):
        if not got[k(name)] == want[k(name)]:
            bad[name] = f"{got[k(name)]} against {want[k(name)]}"
    if not np.array_equal(got[k("mode_counts")], want[k("mode_counts")]):
        bad["mode_counts"] = f"{got[k('mode_counts')]} against " \
            f"{want[k('mode_counts')]}"
    for name in ("sample", "angles"):
        if not np.array_equal(got[k(name)], want[k(name)]):
            bad[name] = "different sample"
            return bad, gaps
    for name in ("sample_nominal", "sample_wl"):
        a, b = np.asarray(got[k(name)]), np.asarray(want[k(name)])
        gaps[name] = float(np.abs(a - b).max())
        if a.dtype != b.dtype or a.tobytes() != b.tobytes():
            bad[name] = f"max gap {gaps[name]:.3g}"
    for name in ("thx", "thy"):
        if got[k(name)].shape != want[k(name)].shape:
            bad[name] = "shape"
            continue
        gaps[name] = _ulps(got[k(name)], want[k(name)])
        if gaps[name] > 1:
            bad[name] = f"{gaps[name]} float32 ulps"
    lvl = float(want[k("sky_level")])
    gaps["sky_level"] = abs(float(got[k("sky_level")]) - lvl) / lvl
    g, w = np.asarray(got[k("gradient")]), np.asarray(want[k("gradient")])
    gaps["gradient"] = float(np.abs(g - w).max() / np.abs(w).max())
    for name in ("sky_level", "gradient"):
        if not gaps[name] <= 1e-12:
            bad[name] = f"rel gap {gaps[name]:.3g}"
    f, fw = np.asarray(got[k("fringe")]), np.asarray(want[k("fringe")])
    if np.isnan(fw).all() != np.isnan(f).all():
        bad["fringe"] = f"{f} against {fw}"
    elif not np.isnan(fw).all():
        gaps["fringe"] = float(np.abs(f / fw - 1).max())
        if not gaps["fringe"] <= fringe_rel:
            bad["fringe"] = f"rel gap {gaps['fringe']:.3g}"
    return bad, gaps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-lines", type=int, default=120_000)
    ap.add_argument("--dets", default="R22_S11",
                    help="comma-separated CCDs: the first gets the default "
                         "workload's lines, each further one n-lines of its "
                         "own after them")
    args = ap.parse_args(argv)
    dets = args.dets.split(",")
    res = write_workload(args.out_dir, args.seed, args.n_lines,
                         det_name=dets[0], more_dets=tuple(dets[1:]))
    for band, path in res["catalog"].items():
        print(f"{band}: {path} sha256 {res['sha256'][band]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
