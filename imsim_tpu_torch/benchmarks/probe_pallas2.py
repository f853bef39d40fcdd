"""On-chip probe P6, P7 (port of benchmarks/probe_pallas2.py): the
stencil formulations the TPU compiler was bisected with, each body a
hand-written kernel launch (ops/probes.py, csrc/probes.cu) timed against
its plain twin.

  P6 (mk, one output):  a P[r+1, c+R]; b P[r, c+1];
      c sum_j dk[0, j] P[r, c+j]; d sum_i dk[0, i] P[r+i, c+R];
      e, f, g, h the full k x k stencil of P4 in four formulations
      (e, g, h by lane rolls that never wrap inside the output window);
  P7 (mk2, two outputs sharing taps): i, h2, h3, each the P5 function.

The JAX probe's body e passes negative shifts to pltpu.roll, which the
installed JAX refuses (ROADMAP C); the port computes what it means.

On the card:  python3 -m imsim_tpu_torch.benchmarks.probe_pallas2
On the CPU, small:
    python3 -m imsim_tpu_torch.benchmarks.probe_pallas2 --device cpu \\
        --h 256 --w 256
"""
from __future__ import annotations

import argparse

from ..ops import probes
from ._util import Timer, check_kernel
from .probe_pallas import (EXACT, STENCIL_BAR, make_frame, window_library,
                           window_work)


def _slowest(rows: dict) -> dict:
    """One report row for a TPU kernel with several bodies: the slowest
    body's times, bound and one-call yardstick, the largest gap, and
    every body under `bodies`."""
    slow = max(rows, key=lambda b: rows[b]["ms"])
    keep = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return dict({k: rows[slow][k] for k in keep}, slowest=slow,
                max_abs_err=max(r["max_abs_err"] for r in rows.values()),
                within=max(r["within"] for r in rows.values()),
                bodies=rows)


def main(device="cuda", h: int = 4096, w: int = 4096, k: int = 9,
         th: int = 128, log=print) -> dict:
    """Every P6 and P7 body against its plain twin (bitwise for the
    one-tap windows a and b, else 1e-5 of max |out|), timed beside its
    bound and its one-call yardstick; returns
    {"kernels": {"probe_mk": row, "probe_mk2": row}}."""
    _, P, dkf = make_frame(device, h, w, k, th)
    timer = Timer(device)
    report = {"kernels": {}}
    for name, bodies, kern, plain in (
            ("probe_mk", probes.MK_BODIES, probes.probe_mk,
             probes.probe_mk_plain),
            ("probe_mk2", probes.MK2_BODIES, probes.probe_mk2,
             probes.probe_mk2_plain)):
        rows = {}
        for body in bodies:
            bar = EXACT if body in ("a", "b") else STENCIL_BAR
            row = check_kernel(timer, lambda: kern(body, dkf, P, w),
                               lambda: plain(body, dkf, P, w), bar,
                               window_work(body, k, h, w),
                               window_library(body, dkf, P, k, w))
            rows[body] = row
            log(f"{name}-{body}: {row['ms']:.3f} ms (plain twin "
                f"{row['plain_ms']:.3f} ms, one call "
                f"{row['library_ms']:.3f} ms, bound {row['bound_ms']:.4f} "
                f"ms by {row['bound_by']}), max gap "
                f"{row['max_abs_err']:.3g} of max |out| {row['scale']:.3g}")
        report["kernels"][name] = _slowest(rows)
    return report


def _cli():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--h", type=int, default=4096)
    ap.add_argument("--w", type=int, default=4096)
    ap.add_argument("--k", type=int, default=9)
    ap.add_argument("--th", type=int, default=128)
    a = ap.parse_args()
    main(a.device, a.h, a.w, a.k, a.th)


if __name__ == "__main__":
    _cli()
