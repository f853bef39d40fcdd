"""The binning scatter on one chunk of photons with a share of them
outside the frame.

Four designs are timed:

- `pixel0`: one `index_put_(accumulate=True)` (on the card it sorts the
  indices and adds each run of equal indices in one warp, so a run
  costs time in proportion to its length), every out-of-frame photon at
  pixel 0 with flux 0, as the binner did before the tail: one run;
- `spread`: the same, each at in-frame pixel (photon index mod the
  frame);
- `tail`: the same, each at a scratch slot of its own past the frame,
  the frame copied into the padded buffer and back: the plain twin,
  `sensor/simple.accumulate_plain` (`copies_ms` times the two copies
  alone);
- `atomic`: K5, as `sensor/simple.accumulate` bins on the card: a zeroed
  scratch frame, the kernel's atomic adds, the scratch added to the
  image (`atomic_kernel_ms` times the kernel alone).

Cases: a chunk of the instance-catalog CCD's size (7.5e6-photon batches
in 4 chunks) with 0%, 0.2% (the bench CCD's) and 9% (the
instance-catalog CCD's) of the photons out of frame, a tenth of the rest
in a star a few pixels wide; and the SED flat's sub-batch, 16,769,309
photons spread evenly over the frame.  The fluxes are not whole, so that
each `same_image_<design>` of `spread` and `tail` (the frame
torch.equal to `pixel0`'s) can fail where a design changes the order in
which a pixel's run is summed; `same_image_atomic` holds K5 to `tail`
on the same photons with fluxes of 0 and 1, the port's (the atomics'
order is the hardware's).  `atomic_bound_ms` is the least time of the
`atomic` path at 3.35 TB/s: 12 B read a photon, the scratch zeroed
(4 B a pixel) and added (12 B a pixel); `atomic_kernel_bound_ms` the
kernel's 12 B a photon alone.

`tail_bits_ms` times the index_put_ scatter alone (indices made
beforehand) into buffers of 2^b elements, b = 24 (the frame's own bits,
where the tail fits below 2^24) and up: the sort's key bits follow the
buffer's largest index, and each radix pass shows as a step.

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
from ..photons.batch import PhotonBatch
from ..sensor import simple
from ._util import PEAK_BYTES, Timer

N_CHUNK = 1_876_480
N_FLAT = 16_769_309
FRAME = (4004, 4096)
SHARES = (0.0, 0.002, 0.09)
DESIGNS = ("pixel0", "spread", "tail", "atomic")


def _indices(x, y, H, W, design: str, tail: int = 1):
    """(flat indices, in-frame mask) of the binning for one design."""
    fx, fy = torch.round(x), torch.round(y)
    inb = (fx >= 0) & (fx < W) & (fy >= 0) & (fy < H)
    idx = torch.where(inb, fy, 0.0).to(torch.int64) * W \
        + torch.where(inb, fx, 0.0).to(torch.int64)
    if design != "pixel0":
        i = torch.arange(idx.numel(), device=idx.device)
        idx = torch.where(inb, idx, i % (H * W) if design == "spread"
                          else H * W + i % tail)
    return idx, inb


def _scatter(x, y, flux, frame, design: str):
    """One chunk binned into a new frame by `design`."""
    H, W = frame
    dev = x.device
    if design in ("tail", "atomic"):
        ph = PhotonBatch.zeros(x.numel(), device=dev).replace(
            x=x, y=y, flux=flux)
        fn = simple.accumulate if design == "atomic" \
            else simple.accumulate_plain
        return fn(ph, torch.zeros(frame, device=dev))
    idx, inb = _indices(x, y, H, W, design)
    image = torch.zeros(frame, device=dev)
    image.view(-1).index_put_((idx,), torch.where(inb, flux, 0.0),
                              accumulate=True)
    return image


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
               else "cpu", n=n, n_flat=n_flat, frame=list(frame),
               tail=simple.tail_slots(n, H * W), runs={})
    if timer.cuda:
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    cases = [(f"{s}", n, s, True) for s in SHARES] \
        + [("flat", n_flat, 0.0, False)]
    for tag, m, share, star in cases:
        x, y, flux = _chunk(gen, m, frame, share, device, star)
        imgs = {}
        for d in DESIGNS:
            imgs[d] = _scatter(x, y, flux, frame, d)
            out["runs"][f"{tag}_{d}_ms"] = timer.ms(
                lambda: _scatter(x, y, flux, frame, d), reps=5)
        for d in DESIGNS[1:3]:
            out["runs"][f"{tag}_same_image_{d}"] = bool(
                torch.equal(imgs["pixel0"], imgs[d]))
        whole = (flux < 1.8).float()
        out["runs"][f"{tag}_same_image_atomic"] = bool(torch.equal(
            _scatter(x, y, whole, frame, "tail"),
            _scatter(x, y, whole, frame, "atomic")))
        if timer.cuda:
            scratch = torch.zeros(frame, device=device)
            out["runs"][f"{tag}_atomic_kernel_ms"] = timer.ms(
                lambda: binning.bin_scatter(x, y, flux, scratch), reps=5)
        out["runs"][f"{tag}_atomic_bound_ms"] = \
            (12 * m + 16 * H * W) / PEAK_BYTES * 1e3
        out["runs"][f"{tag}_atomic_kernel_bound_ms"] = \
            12 * m / PEAK_BYTES * 1e3
        del imgs
    # the scatter alone into 2^b-element buffers, at the sky chunk's
    # last share
    x, y, flux = _chunk(gen, n, frame, SHARES[-1], device)
    bits = {}
    b0 = (H * W).bit_length()         # the least b with 2^b > H * W
    for b in (b0, b0 + 1, b0 + 2, b0 + 4, b0 + 8):
        buf = torch.empty(1 << b, device=device)
        tail = min((1 << b) - H * W, n)
        idx, inb = _indices(x, y, H, W, "tail", tail)
        f = torch.where(inb, flux, 0.0)
        bits[b] = timer.ms(
            lambda: buf.index_put_((idx,), f, accumulate=True), reps=5)
        del buf
    out["tail_bits_ms"] = bits
    # the copies accumulate_plain adds: the frame into the padded
    # buffer, back
    frame_img = torch.zeros(frame, device=device)
    flat = torch.zeros(H * W + out["tail"], device=device)
    out["copies_ms"] = timer.ms(lambda: (
        torch.cat((frame_img.view(-1), frame_img.new_zeros(out["tail"]))),
        frame_img.view(-1).copy_(flat[:H * W])), reps=5)
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
