"""K2 against its plain twin on uniformly random photons.

chip_smoke.py and the tests hold the ray chain to its bar
(ops/raychain.gaps_ok) on photons whose field angles come from the bench
scene.  This draws `n` photons (seeded) uniformly over the bench CCD's
field, the annular pupil, the r band and a 30 s exposure, runs the
port's `field_to_sensor` (the kernel on a CUDA device) and its plain
twin on them, in the plain and the fused form, and lists every photon
that lands farther than 0.35 px from the twin away from the spider
edges, with its two nearest edge distances in the rotating spider frame
(float64).  Two distances closer than diffraction.TIE_M are a tie:
either edge's kick is right there, and float32 rounding of the rotated
pupil point picks one, so such a photon may land a whole kick (a few px)
away; ops/raychain.chain_gaps holds ties to the near-edge bar.

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


def beyond_bar(want, got, ctx, args, margin: int = 64) -> list:
    """Each photon beyond BAR_PX from the twin away from the spider edges
    (NEAR_EDGE_M, as ops/raychain.chain_gaps), worst first, with its two
    nearest edges and whether they tie."""
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
    two = D.two_nearest_edges(pu[idx], pv[idx], t[idx], ctx.latitude,
                              ctx.bore_alt, ctx.bore_az)
    tie = (two[1] - two[0]) < D.TIE_M
    return [dict(photon=int(i), dxy=float(dxy[i]), edge1_m=float(e1),
                 edge2_m=float(e2), tie=bool(k))
            for i, e1, e2, k in zip(idx.tolist(), two[0].tolist(),
                                    two[1].tolist(), tie.tolist())]


def main(device="cuda", n: int = N_PHOTONS, seed: int = 8,
         log=print) -> dict:
    """Both forms: {"plain" | "fused": {gaps, beyond_bar, ok}}; `ok` is
    ops/raychain.gaps_ok, which holds the ties to the near-edge bar."""
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
        form = "fused" if fused else "plain"
        out[form] = dict(n=n, seed=seed, gaps=gaps,
                         beyond_bar=beyond_bar(want, got, state.ctx, args),
                         ok=raychain.gaps_ok(gaps, fused))
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
