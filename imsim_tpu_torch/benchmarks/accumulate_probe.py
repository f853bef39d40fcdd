"""The binning scatter on one chunk of photons with a share of them
outside the frame: K5 against its plain twin.

Two paths are timed, each binning into a new zeroed frame as
`sensor/simple.binned` does:

- `plain`: the twin, `ops/binning.bin_scatter_plain`: one masked
  `index_put_(accumulate=True)` (on the card it sorts the indices and
  adds each run of equal indices in one warp);
- `atomic`: K5, `ops/binning.bin_scatter` on the card: the kernel's
  atomic adds (`atomic_kernel_ms` times the kernel alone).

Cases: a chunk of the instance-catalog CCD's size (7.5e6-photon batches
in 4 chunks) with 0%, 0.2% (the bench CCD's) and 9% (the
instance-catalog CCD's) of the photons out of frame, a tenth of the rest
in a star a few pixels wide; and the SED flat's sub-batch, 16,769,309
photons spread evenly over the frame.  `same_image_atomic` holds K5 to
the twin on the same photons with fluxes of 0 and 1, the port's (the
atomics' order is the hardware's).  `atomic_bound_ms` is the least time
of the `atomic` path at 3.35 TB/s: 12 B read a photon and the frame
zeroed (4 B a pixel); `atomic_kernel_bound_ms` the kernel's 12 B a
photon alone.

On the card, from the root of a checkout:
    python3 -m imsim_tpu_torch.benchmarks.accumulate_probe
Prints one JSON line.  `--device cpu --n 20000 --n-flat 40000 --h 64 --w
64` rehearses it on a CPU (host clock; not a device time; `atomic` is
the plain twin there).
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ..ops import binning
from ._util import PEAK_BYTES, Timer

N_CHUNK = 1_876_480
N_FLAT = 16_769_309
FRAME = (4004, 4096)
SHARES = (0.0, 0.002, 0.09)
PATHS = {"plain": binning.bin_scatter_plain, "atomic": binning.bin_scatter}


def _scatter(x, y, flux, frame, path: str):
    """One chunk binned into a new frame by `path`."""
    return PATHS[path](x, y, flux, torch.zeros(frame, device=x.device))


def _chunk(gen, n, frame, share, device, star=True):
    """x, y, flux of one chunk: uniform over the frame, with `star` a
    tenth in a star of 2 px sigma, the first `share` left of the frame
    in the cull margin; fluxes uniform on [0, 2)."""
    H, W = frame
    x = torch.rand(n, generator=gen, device=device) * W - 0.5
    y = torch.rand(n, generator=gen, device=device) * H - 0.5
    if star:
        k = n // 10
        x[-k:] = W / 3 + 2.0 * torch.randn(k, generator=gen, device=device)
        y[-k:] = H / 3 + 2.0 * torch.randn(k, generator=gen, device=device)
    x[:int(share * n)] = -50.0
    flux = 2.0 * torch.rand(n, generator=gen, device=device)
    return x, y, flux


def main(device="cuda", n=N_CHUNK, frame=FRAME, n_flat=N_FLAT) -> dict:
    device = torch.device(device)
    timer = Timer(device)
    gen = torch.Generator(device=device).manual_seed(9)
    H, W = frame
    out = dict(device=torch.cuda.get_device_name(0) if timer.cuda
               else "cpu", n=n, n_flat=n_flat, frame=list(frame), runs={})
    if timer.cuda:
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    cases = [(f"{s}", n, s, True) for s in SHARES] \
        + [("flat", n_flat, 0.0, False)]
    for tag, m, share, star in cases:
        x, y, flux = _chunk(gen, m, frame, share, device, star)
        # also each path's first call, outside the timings
        whole = (flux < 1.8).float()
        out["runs"][f"{tag}_same_image_atomic"] = bool(torch.equal(
            _scatter(x, y, whole, frame, "plain"),
            _scatter(x, y, whole, frame, "atomic")))
        for p in PATHS:
            out["runs"][f"{tag}_{p}_ms"] = timer.ms(
                lambda: _scatter(x, y, flux, frame, p), reps=5)
        if timer.cuda:
            scratch = torch.zeros(frame, device=device)
            out["runs"][f"{tag}_atomic_kernel_ms"] = timer.ms(
                lambda: binning.bin_scatter(x, y, flux, scratch), reps=5)
        out["runs"][f"{tag}_atomic_bound_ms"] = \
            (12 * m + 4 * H * W) / PEAK_BYTES * 1e3
        out["runs"][f"{tag}_atomic_kernel_bound_ms"] = \
            12 * m / PEAK_BYTES * 1e3
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N_CHUNK)
    ap.add_argument("--n-flat", type=int, default=N_FLAT)
    ap.add_argument("--h", type=int, default=FRAME[0])
    ap.add_argument("--w", type=int, default=FRAME[1])
    a = ap.parse_args()
    print(json.dumps(main(a.device, a.n, (a.h, a.w), a.n_flat)))
