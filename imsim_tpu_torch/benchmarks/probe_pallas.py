"""On-chip probe P1-P5 (port of benchmarks/probe_pallas.py): a frame
copy, a halo-window copy, a one-tap window and the 1- and 2-output 9 x 9
stencils, each a hand-written kernel (ops/probes.py, csrc/probes.cu)
timed against its plain twin, with the probe's own check of P5 against
the shifted-slice sum (probe_pallas.py:205-218).

P1 and P2 move 2 x 4 x H x W bytes and no arithmetic: their times are the
card's copy floor for one frame.  Each kernel's row also carries its
bound and the time of one PyTorch call computing the same function: the
twin's own call for P1-P3, one float32 conv2d for the stencils.

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
from ._util import Timer, check_kernel, conv2d_fp32

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


def window_work(body: str, k: int, h: int, w: int) -> tuple:
    """(operations, bytes) of a window body over an (h, w) output: per
    output pixel and output, n weighted taps cost n multiplies and n - 1
    adds (a lone unweighted tap, a copy, costs none); the bytes are the
    window region of P the taps reach, read once, and the outputs,
    written once."""
    groups, nout = probes.body_taps(body, k)
    taps = [tap for g in groups for tap in g]
    n_w = sum(t is not None for _, _, t in taps)
    di = [t[0] for t in taps]
    dj = [t[1] for t in taps]
    reach = (h + max(di) - min(di)) * (w + max(dj) - min(dj))
    flops = nout * h * w * max(2 * n_w - 1, 0)
    return flops, 4 * (reach + nout * h * w)


def window_library(body: str, dkf, P, k: int, w: int):
    """One PyTorch call computing a window body (never called by the
    port): the twin's own single call for the one-tap bodies, else one
    VALID conv2d over P with the body's taps as weights, sliced to the
    (h, w) window.  Returns a zero-argument callable."""
    groups, nout = probes.body_taps(body, k)
    taps = [tap for g in groups for tap in g]
    if len(taps) == 1:
        return lambda: probes.window_plain(body, dkf, P, k, w)
    h = P.shape[0] - (k - 1)
    wt = torch.zeros((nout, 1, k, k), dtype=torch.float32)
    for o in range(nout):
        for di, dj, t in taps:
            wt[o, 0, di, dj] += dkf[o, t]
    wt = wt.to(P.device)
    x = P[None, None]
    return lambda: conv2d_fp32(x, wt)[0, :, :h, :w].unbind(0)


def main(device="cuda", h: int = 4096, w: int = 4096, k: int = 9,
         th: int = 128, log=print) -> dict:
    """Each of P1-P5 against its plain twin (bitwise for P1-P3, 1e-5 of
    max |out| for P4, P5), timed beside its bound and its one-call
    yardstick; returns {"kernels": {name: row}}."""
    img, P, dkf = make_frame(device, h, w, k, th)
    timer = Timer(device)
    per_body = lambda b: (window_work(b, k, h, w),  # noqa: E731
                          window_library(b, dkf, P, k, w))
    runs = [
        ("probe_p1", "p1 copy x2", EXACT,
         lambda: probes.probe_copy2(img),
         lambda: probes.probe_copy2_plain(img), (h * w, 8 * h * w),
         lambda: probes.probe_copy2_plain(img)),
        ("probe_p2", "p2 halo window", EXACT,
         lambda: probes.probe_window(P, k, w),
         lambda: probes.probe_window_plain(P, k, w), *per_body("p2")),
        ("probe_p3", "p3 one-tap window", EXACT,
         lambda: probes.probe_window_tap(dkf, P, w),
         lambda: probes.probe_window_tap_plain(dkf, P, w), *per_body("p3")),
        ("probe_p4", "p4 stencil 1-out", STENCIL_BAR,
         lambda: probes.probe_stencil1(dkf, P, w),
         lambda: probes.probe_stencil1_plain(dkf, P, w), *per_body("p4")),
        ("probe_p5", "p5 stencil 2-out", STENCIL_BAR,
         lambda: probes.probe_stencil2(dkf, P, w),
         lambda: probes.probe_stencil2_plain(dkf, P, w), *per_body("p5")),
    ]
    report = {"kernels": {}}
    for name, tag, bar, kern, plain, work, library in runs:
        row = check_kernel(timer, kern, plain, bar, work, library)
        report["kernels"][name] = row
        log(f"{tag}: {row['ms']:.3f} ms (plain twin {row['plain_ms']:.3f} "
            f"ms, one call {row['library_ms']:.3f} ms, bound "
            f"{row['bound_ms']:.4f} ms by {row['bound_by']}), max gap "
            f"{row['max_abs_err']:.3g} of max |out| {row['scale']:.3g}")
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
