"""On-chip probe P1-P5 (port of benchmarks/probe_pallas.py): a frame
copy, a halo-window copy, a one-tap window and the 1- and 2-output 9 x 9
stencils, each a hand-written kernel (ops/probes.py, csrc/probes.cu)
timed against its plain twin, with the probe's own check of P5 against
the shifted-slice sum (probe_pallas.py:205-218).

P1 and P2 move 2 x 4 x H x W bytes and no arithmetic: their times are the
card's copy floor for one frame.

On the card:  python3 -m imsim_tpu_torch.benchmarks.probe_pallas
On the CPU, small:
    python3 -m imsim_tpu_torch.benchmarks.probe_pallas --device cpu \\
        --h 256 --w 256
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import probes
from ._util import Timer, check_kernel

# gap bars, as fractions of max |out|: the copies and the one-tap window
# are one rounding (held bitwise); a k^2-tap sum in another order than
# the twin stays within 1e-5 (the bar of K3)
EXACT = 0.0
STENCIL_BAR = 1e-5


def make_frame(device, h: int, w: int, k: int, th: int):
    """(img, P, dkf) as the JAX probes build them at module level
    (probe_pallas.py:35-40): img uniform in [0, 1e5) (h, w); P the frame
    zero-padded by R = k // 2 rows and columns, its width rounded up to
    128; dkf (2, k*k) standard normal, kept on the host (the kernels take
    the taps by value).  `th` is the TPU probes' row tile: h must be a
    whole number of them, as there (the CUDA kernels tile 32 x 32)."""
    if h % th:
        raise ValueError(f"h={h} is not a multiple of the row tile {th}")
    R = k // 2
    wp = ((w + 2 * R + 127) // 128) * 128
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1e5, (h, w)).astype(np.float32)
    P = np.zeros((h + 2 * R, wp), np.float32)
    P[R:R + h, R:R + w] = img
    dkf = rng.normal(size=(2, k, k)).astype(np.float32).reshape(2, k * k)
    dev = torch.device(device)
    return (torch.as_tensor(img, device=dev), torch.as_tensor(P, device=dev),
            torch.from_numpy(dkf))


def main(device="cuda", h: int = 4096, w: int = 4096, k: int = 9,
         th: int = 128, log=print) -> dict:
    """Each of P1-P5 against its plain twin (bitwise for P1-P3, 1e-5 of
    max |out| for P4, P5), timed; returns {"kernels": {name: row}}."""
    img, P, dkf = make_frame(device, h, w, k, th)
    timer = Timer(device)
    runs = [
        ("probe_p1", "p1 copy x2", EXACT,
         lambda: probes.probe_copy2(img),
         lambda: probes.probe_copy2_plain(img)),
        ("probe_p2", "p2 halo window", EXACT,
         lambda: probes.probe_window(P, k, w),
         lambda: probes.probe_window_plain(P, k, w)),
        ("probe_p3", "p3 one-tap window", EXACT,
         lambda: probes.probe_window_tap(dkf, P, w),
         lambda: probes.probe_window_tap_plain(dkf, P, w)),
        ("probe_p4", "p4 stencil 1-out", STENCIL_BAR,
         lambda: probes.probe_stencil1(dkf, P, w),
         lambda: probes.probe_stencil1_plain(dkf, P, w)),
        ("probe_p5", "p5 stencil 2-out", STENCIL_BAR,
         lambda: probes.probe_stencil2(dkf, P, w),
         lambda: probes.probe_stencil2_plain(dkf, P, w)),
    ]
    report = {"kernels": {}}
    for name, tag, bar, kern, plain in runs:
        row = check_kernel(timer, kern, plain, bar)
        report["kernels"][name] = row
        log(f"{tag}: {row['ms']:.3f} ms (plain twin {row['plain_ms']:.3f} "
            f"ms), max gap {row['max_abs_err']:.3g} of max |out| "
            f"{row['scale']:.3g}")
    # the probe's own check: P5 against the shifted-slice sum
    ox, oy = probes.probe_stencil2(dkf, P, w)
    xx, xy = probes.probe_mk2_plain("i", dkf, P, w)
    gaps = (float((ox - xx).abs().max()), float((oy - xy).abs().max()))
    scale = float(xx.abs().max())
    log(f"maxdiff {gaps[0]} {gaps[1]} scale {scale}")
    report["p5_vs_shifted_slices"] = dict(max_abs_err=max(gaps), scale=scale)
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
