"""K2 against its plain twin on uniformly random photons.

chip_smoke.py and the tests hold the ray chain to its bar
(ops/raychain.gaps_ok) on photons whose field angles come from the bench
scene.  This draws `n` photons (seeded) uniformly over the bench CCD's
field, the annular pupil, the r band and a 30 s exposure, runs the
port's `field_to_sensor` (the kernel on a CUDA device) and its plain
twin on them, in the plain and the fused form, and lists every photon
that lands farther than 0.35 px from the twin away from the spider
edges, with its two nearest edge distances in the rotating spider frame
(float64).  Two distances closer than TIE_M are a tie: either edge's
kick is right there, and float32 rounding of the rotated pupil point
picks one, so such a photon may land a whole kick (a few px) away.

On the card:  python3 -m imsim_tpu_torch.benchmarks.chain_random
Prints one JSON line per form.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..convert import load_ccd_state
from ..ops import raychain
from ..photons import diffraction as D

# the bench batch: NB = 6 batches of the pooled photons
N_PHOTONS = 18_677_760
# about four float32 ulps of a pupil coordinate at the 4.18 m rim: the
# rounding of the rotated pupil point and of the edge distances
TIE_M = 2e-6
BAR_PX = 0.35


def photons(n: int, seed: int, device):
    """(chain inputs, silicon draws): field angles over R22_S11, pupil
    points on the annulus, wavelengths over the r band, times over a
    30 s exposure, unit flux, the diffraction normal; then u, g1, g2."""
    g = torch.Generator(device=device).manual_seed(seed)

    def u(lo, hi):
        return torch.rand(n, generator=g, device=device) * (hi - lo) + lo

    r = torch.sqrt(u(2.558**2, 4.18**2))
    a = u(0, 2 * np.pi)
    args = (u(-0.0025, 0.0025), u(-0.0025, 0.0025), r * torch.cos(a),
            r * torch.sin(a), u(552, 691), u(0, 30),
            torch.ones(n, device=device),
            torch.randn(n, generator=g, device=device))
    draws = (u(1e-7, 1), torch.randn(n, generator=g, device=device),
             torch.randn(n, generator=g, device=device))
    return args, draws


def two_nearest_edges(pu, pv, t, ctx) -> torch.Tensor:
    """(2, n) float64: the two smallest distances [m] from each pupil
    point to a spider vane or aperture circle, in the rotating frame."""
    s, c = D.field_rotation_sincos(t, ctx.latitude, ctx.bore_alt,
                                   ctx.bore_az)
    u, v, c, s = pu.double(), pv.double(), c.double(), s.double()
    ru, rv = c * u - s * v, s * u + c * v
    edges = [((nx * ru + ny * rv - d0).abs() - th).abs()
             for nx, ny, d0, th in D.SPIDER_LINES.tolist()]
    edges += [(torch.hypot(ru, rv) - r).abs()
              for _, _, r in D.SPIDER_CIRCLES.tolist()]
    return torch.sort(torch.stack(edges), dim=0).values[:2]


def beyond_bar(want, got, ctx, args, margin: int = 64) -> tuple:
    """(rows, dxy_untied): each photon beyond BAR_PX from the twin away
    from the spider edges (the strict set of raychain.chain_gaps), worst
    first, and the largest gap over the strict set with its ties left
    out."""
    pu, pv, t = args[2], args[3], args[5]
    x, y = want[0], want[1]
    on = (want[-1] > 0) & (got[-1] > 0) & (x > -margin) \
        & (x < ctx.det_nx + margin) & (y > -margin) & (y < ctx.det_ny + margin)
    dist = D.spider_distance(pu, pv, t, ctx.latitude, ctx.bore_alt,
                             ctx.bore_az)
    strict = on & (dist >= raychain.NEAR_EDGE_M)
    dxy = torch.maximum((got[0] - x).abs(), (got[1] - y).abs())
    idx = torch.nonzero(strict & (dxy > BAR_PX))[:, 0]
    idx = idx[torch.argsort(dxy[idx], descending=True)]
    two = two_nearest_edges(pu[idx], pv[idx], t[idx], ctx)
    tie = (two[1] - two[0]) < TIE_M
    untied = strict.clone()
    untied[idx[tie]] = False
    rows = [dict(photon=int(i), dxy=float(dxy[i]), edge1_m=float(e1),
                 edge2_m=float(e2), tie=bool(k))
            for i, e1, e2, k in zip(idx.tolist(), two[0].tolist(),
                                    two[1].tolist(), tie.tolist())]
    dxy_untied = float(dxy[untied].max()) if bool(untied.any()) else 0.0
    return rows, dxy_untied


def main(device="cuda", n: int = N_PHOTONS, seed: int = 8,
         log=print) -> dict:
    """Both forms: {"plain" | "fused": {gaps, beyond_bar, dxy_untied,
    ok_but_ties}}; `ok_but_ties` is gaps_ok with the ties left out."""
    device = torch.device(device)
    state = load_ccd_state(device=device)
    args, draws = photons(n, seed, device)
    out = {}
    for fused in (False, True):
        kw = dict(silicon=state.silicon, si_draws=draws) if fused else {}
        want = raychain.field_to_sensor_plain(state.tel, state.ctx, *args,
                                              **kw)
        got = raychain.field_to_sensor(state.tel, state.ctx, *args, **kw)
        gaps = raychain.chain_gaps(want, got, state.ctx, *args[2:6],
                                   args[7])
        rows, dxy_untied = beyond_bar(want, got, state.ctx, args)
        form = "fused" if fused else "plain"
        out[form] = dict(
            n=n, seed=seed, gaps=gaps, beyond_bar=rows,
            dxy_untied=dxy_untied,
            ok_but_ties=raychain.gaps_ok(dict(gaps, dxy=dxy_untied), fused))
        log(json.dumps(dict(form=form, **out[form])))
        del want, got
    return out


def _cli():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=N_PHOTONS)
    ap.add_argument("--seed", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.device, a.n, a.seed)


if __name__ == "__main__":
    _cli()
