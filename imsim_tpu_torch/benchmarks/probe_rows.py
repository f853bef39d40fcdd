"""On-chip probe: row-materialization formulations (port of
benchmarks/probe_rows.py).

The pooled batch reconstructs (C = 24)-wide per-photon parameter rows
from per-object deltas: a scatter, then a prefix sum
(image/photon_pooling.materialize_rows_T).  This probe times each piece
and the candidate formulations:

  * the scatter in (N, C) and (C, N) orientation.  The JAX probe's
    `indices_are_sorted` hint has no PyTorch counterpart: its two
    "sorted-hint" cases run the same `index_add_` as the unhinted one;
  * torch.cumsum along axis 0 of (N, C) and axis 1 of (C, N);
  * K4, the lane scan (ops/scanrows.scan_lanes; the JAX probe's
    "pallas" cases);
  * the pe = 16 relayout (C, mp, 4, 4) -> axes (0, 3, 2, 1);
  * K1, the slot-plane scan (ops/scanrows.scan_slot_prefix).

The JAX probe's "FULL fused scan+relayout" case imports
`scan_lanes_relayout`, which the JAX package does not define (ROADMAP
C); it is left out.  Every case returns its whole output; the timing loop
reads one element of it, as the JAX probe does.

On the card:  python3 -m imsim_tpu_torch.benchmarks.probe_rows
On the CPU, small:
    python3 -m imsim_tpu_torch.benchmarks.probe_rows --device cpu \\
        --n 65536 --n-obj 512
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import scanrows
from ._util import Timer, bound

PAIR = SHARE = 4            # the pe = 16 slot layout of the bench batch


@dataclass
class RowsData:
    params: torch.Tensor    # (n_obj, C) per-object rows
    starts: torch.Tensor    # (n_obj,) first global photon ordinal, int64
    deltas: torch.Tensor    # (n_obj, C) row differences
    deltasT: torch.Tensor   # (C, n_obj), contiguous
    n: int                  # photons per batch
    nb: int                 # batches


def make_data(device, n: int, c: int, n_obj: int, nb: int,
              seed: int = 0) -> RowsData:
    """The JAX probe's inputs, from numpy.random.default_rng(seed)."""
    if n % 16:
        raise ValueError(f"n={n}: the pe = 16 relayout needs n % 16 == 0")
    rng = np.random.default_rng(seed)
    params = rng.normal(size=(n_obj, c)).astype(np.float32)
    counts = rng.multinomial(n - n_obj, np.ones(n_obj) / n_obj) + 1
    cum = np.cumsum(counts).astype(np.int32)
    starts = np.concatenate([np.zeros(1, np.int32), cum[:-1]])
    deltas = params - np.concatenate([np.zeros((1, c), np.float32),
                                      params[:-1]])
    dev = torch.device(device)
    return RowsData(
        params=torch.as_tensor(params, device=dev),
        starts=torch.as_tensor(starts.astype(np.int64), device=dev),
        deltas=torch.as_tensor(deltas, device=dev),
        deltasT=torch.as_tensor(np.ascontiguousarray(deltas.T), device=dev),
        n=n, nb=nb)


def j0_of(data: RowsData, b: int) -> torch.Tensor:
    """Batch-local ordinal of each object's first photon in batch b:
    max(-floor((b - start) / nb), 0), with the JAX probe's floor division
    of a negative number."""
    return torch.clamp(
        -torch.div(b - data.starts, data.nb, rounding_mode="floor"), min=0)


def _kept(idx: torch.Tensor, keep: torch.Tensor, src: torch.Tensor,
          dim: int):
    """The JAX scatter's mode="drop" as an explicit mask (index_add_
    raises on an index out of range): a dropped delta (keep False) is
    zeroed and sent to index 0, where adding +0 changes nothing.  `dim`
    is src's object axis."""
    idx = torch.where(keep, idx, torch.zeros_like(idx))
    return idx, src * keep.unsqueeze(1 - dim).to(src.dtype)


def relayout_cn(rows: torch.Tensor) -> torch.Tensor:
    """The pe = 16 relayout of probe_rows.py:109, (C, mp, 4, 4) with axes
    (0, 3, 2, 1): out[c, a2*4*mp + a1*mp + m] = rows[c, 16*m + 4*a1 + a2]."""
    c, n = rows.shape
    return rows.reshape(c, n // 16, 4, 4).permute(0, 3, 2, 1).reshape(c, n)


def relayout_nc(rows: torch.Tensor) -> torch.Tensor:
    """The same relayout in (N, C): (mp, 4, 4, C) with axes (2, 1, 0, 3)."""
    n, c = rows.shape
    return rows.reshape(n // 16, 4, 4, c).permute(2, 1, 0, 3).reshape(n, c)


def cases(data: RowsData) -> list:
    """(name, fn) for each case; fn(b, u) returns the case's output for
    batch b and the (C,) uniform draw u (the JAX probe's per-iteration
    key)."""
    n = data.n
    c = data.params.shape[1]
    dev = data.params.device

    def scatter_nc(b, u=None):
        j0 = j0_of(data, b)
        idx, src = _kept(j0, j0 < n, data.deltas, 0)
        return torch.zeros((n, c), device=dev).index_add_(0, idx, src)

    def scatter_cn(b, u=None):
        j0 = j0_of(data, b)
        idx, src = _kept(j0, j0 < n, data.deltasT, 1)
        return torch.zeros((c, n), device=dev).index_add_(1, idx, src)

    def first_row_cn(u):
        rows = torch.zeros((c, n), device=dev)
        rows[:, 0] += data.deltasT[:, 0] + u
        return rows

    def cumsum_nc(b, u):
        rows = torch.zeros((n, c), device=dev)
        rows[0] += data.deltas[0] + u
        return torch.cumsum(rows, dim=0)

    def cumsum_cn(b, u):
        return torch.cumsum(first_row_cn(u), dim=1)

    def k4_cn(b, u):
        return scanrows.scan_lanes(first_row_cn(u))

    def relayout_only(b, u):
        rows = (data.deltasT[:, :1] + u[0]).expand(c, n).contiguous()
        return relayout_cn(rows)

    def full_nc(b, u):
        return relayout_nc(torch.cumsum(scatter_nc(b), dim=0))

    def full_cn_k4(b, u):
        return relayout_cn(scanrows.scan_lanes(scatter_cn(b)))

    def full_cn_cumsum(b, u):
        return relayout_cn(torch.cumsum(scatter_cn(b), dim=1))

    def full_cn_noscan(b, u):
        return relayout_cn(scatter_cn(b))

    def full_cn_norelayout(b, u):
        return scanrows.scan_lanes(scatter_cn(b))

    def full_slot(b, u):
        pe = PAIR * SHARE
        mp = n // pe
        j0 = j0_of(data, b)
        mu = j0 % pe
        beta = (mu % PAIR) * SHARE + mu // PAIR
        q = j0 // pe
        idx, src = _kept(beta * mp + q, q < mp, data.deltasT, 1)
        d = torch.zeros((c, pe, mp), device=dev)
        d.view(c, pe * mp).index_add_(1, idx, src)
        return scanrows.scan_slot_prefix(d, PAIR, SHARE)

    return [
        ("scatter (N,C)", scatter_nc),
        ("scatter (N,C) sorted-hint", scatter_nc),
        ("scatter (C,N) sorted-hint", scatter_cn),
        ("cumsum axis0 (N,C)", cumsum_nc),
        ("cumsum axis1 (C,N)", cumsum_cn),
        ("K4 scan (C,N)", k4_cn),
        ("relayout pe=16 (C,N)", relayout_only),
        ("FULL current (N,C)", full_nc),
        ("FULL transposed+K4", full_cn_k4),
        ("FULL transposed+cumsum", full_cn_cumsum),
        ("FULL transposed no-scan", full_cn_noscan),
        ("FULL transposed no-relayout", full_cn_norelayout),
        ("FULL slot-plane kernel (K1)", full_slot),
    ]


def gather_rows(data: RowsData, b: int) -> torch.Tensor:
    """The direct gather: row j of batch b is params[the last object
    whose first photon j0 <= j], (n, C)."""
    j = torch.arange(data.n, device=data.params.device)
    obj = torch.searchsorted(j0_of(data, b), j, right=True) - 1
    return data.params[obj]


def main(device="cuda", n: int = 16_777_216, c: int = 24,
         n_obj: int = 131_072, nb: int = 6, log=print) -> dict:
    """Time every case and hold K4 against its plain twin on the batch-0
    scatter: per row within sqrt(n_obj) f32 ulps of the row's scale (the
    bar of K1).  Returns the report (`cases`, `kernels`, `rows`)."""
    device = torch.device(device)
    data = make_data(device, n, c, n_obj, nb)
    timer = Timer(device)
    rng = np.random.default_rng(1)
    gen = torch.Generator(device=device).manual_seed(1)

    def draw():
        return (int(rng.integers(nb)),
                torch.rand(c, generator=gen, device=device))

    report = {"cases": [], "kernels": {}}
    for name, fn in cases(data):
        ms = timer.ms(lambda: fn(*draw()).view(-1)[12345 % (n * c)])
        report["cases"].append({"name": name, "ms": ms})
        log(f"{name:30s} {ms:9.3f} ms")
    log("(no indices_are_sorted hint in PyTorch: the sorted-hint cases run "
        "the same index_add_)")

    x = cases(data)[2][1](0)           # the (C, N) scatter of batch 0
    got = scanrows.scan_lanes(x)
    want = scanrows.scan_lanes_plain(x)
    gap = (got - want).abs().amax(dim=1).cpu().numpy()
    scale = want.abs().amax(dim=1).cpu().numpy().astype(np.float32)
    tol = np.sqrt(n_obj) * np.spacing(scale)
    rows_gap = float((got - gather_rows(data, 0).T).abs().max())
    rows_scale = float(data.params.abs().max())
    del got, want
    # bound: C x N adds, C x N floats read and written; the one PyTorch
    # call computing the same function is the plain twin's torch.cumsum
    report["kernels"]["scan_lanes"] = dict(
        max_abs_err=float(gap.max()), within=float((gap / tol).max()),
        ms=timer.ms(lambda: scanrows.scan_lanes(x)),
        plain_ms=timer.ms(lambda: scanrows.scan_lanes_plain(x)),
        library_ms=timer.ms(lambda: torch.cumsum(x, dim=1)),
        **bound(x.numel(), 8 * x.numel()))
    report["rows"] = dict(max_abs_err=rows_gap, scale=rows_scale)
    k4 = report["kernels"]["scan_lanes"]
    log(f"K4 scan_lanes ({c}, {n}): {k4['ms']:.3f} ms, plain twin "
        f"torch.cumsum {k4['plain_ms']:.3f} ms; max gap "
        f"{k4['max_abs_err']:.3g} = {k4['within']:.3g} of the "
        f"sqrt(n_obj)-ulp bar")
    log(f"K4 rows vs the direct gather params[object]: max gap "
        f"{rows_gap:.3g} (params scale {rows_scale:.3g})")
    return report


def _cli():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=16_777_216)
    ap.add_argument("--c", type=int, default=24)
    ap.add_argument("--n-obj", type=int, default=131_072)
    ap.add_argument("--nb", type=int, default=6)
    a = ap.parse_args()
    main(a.device, a.n, a.c, a.n_obj, a.nb)


if __name__ == "__main__":
    _cli()
