"""The pooled render's binning scatter on one chunk of photons with a
share of them outside the frame.

A chunk is binned with one `index_put_(accumulate=True)`, which on the
card sorts the indices and adds each run of equal indices in one warp,
so a run costs time in proportion to its length.  Three places for an
out-of-frame photon (flux 0) are timed:

- `pixel0`: all of them at pixel 0, as the binner did before: one run;
- `spread`: each at in-frame pixel (photon index mod the frame);
- `tail`: each at a scratch slot of its own past the frame, as
  `sensor/simple.accumulate` bins now, the frame copied into the padded
  buffer and back (`copies_ms` times the two copies alone).

on a chunk of the instance-catalog CCD's size (7.5e6-photon batches in 4
chunks) with 0%, 0.2% (the bench CCD's) and 9% (the instance-catalog
CCD's) of the photons out of frame.  The fluxes are not whole and a
tenth of the photons fall in a star a few pixels wide, so that each
`same_image_*` (each design's frame torch.equal to `pixel0`'s) can fail
where a design changes the order in which a pixel's run is summed.

`tail_bits_ms` times the scatter alone (indices made beforehand) into
buffers of 2^b elements, b = 24 (the frame's own bits, where the tail
fits below 2^24) and up: the sort's key bits follow the buffer's
largest index, and each radix pass shows as a step.

On the card, from the root of a checkout:
    python3 -m imsim_tpu_torch.benchmarks.accumulate_probe
Prints one JSON line.  `--device cpu --n 20000 --h 64 --w 64` rehearses
it here (host clock; not a device time).
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ..photons.batch import PhotonBatch
from ..sensor import simple
from ._util import Timer

N_CHUNK = 1_876_480
FRAME = (4004, 4096)
SHARES = (0.0, 0.002, 0.09)


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
    if design == "tail":
        ph = PhotonBatch.zeros(x.numel(), device=dev).replace(
            x=x, y=y, flux=flux)
        return simple.accumulate(ph, torch.zeros(frame, device=dev))
    idx, inb = _indices(x, y, H, W, design)
    image = torch.zeros(frame, device=dev)
    image.view(-1).index_put_((idx,), torch.where(inb, flux, 0.0),
                              accumulate=True)
    return image


def _chunk(gen, n, frame, share, device):
    """x, y, flux of one chunk: uniform over the frame, a tenth in a star
    of 2 px sigma, the first `share` left of the frame in the cull
    margin; fluxes uniform on [0, 2)."""
    H, W = frame
    x = torch.rand(n, generator=gen, device=device) * W - 0.5
    y = torch.rand(n, generator=gen, device=device) * H - 0.5
    k = n // 10
    x[-k:] = W / 3 + 2.0 * torch.randn(k, generator=gen, device=device)
    y[-k:] = H / 3 + 2.0 * torch.randn(k, generator=gen, device=device)
    x[:int(share * n)] = -50.0
    flux = 2.0 * torch.rand(n, generator=gen, device=device)
    return x, y, flux


def main(device="cuda", n=N_CHUNK, frame=FRAME) -> dict:
    device = torch.device(device)
    timer = Timer(device)
    gen = torch.Generator(device=device).manual_seed(9)
    H, W = frame
    out = dict(device=torch.cuda.get_device_name(0) if timer.cuda
               else "cpu", n=n, frame=list(frame),
               tail=simple.tail_slots(n, H * W), runs={})
    if timer.cuda:
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    designs = ("pixel0", "spread", "tail")
    for share in SHARES:
        x, y, flux = _chunk(gen, n, frame, share, device)
        imgs = {}
        for d in designs:
            imgs[d] = _scatter(x, y, flux, frame, d)
            out["runs"][f"{share}_{d}_ms"] = timer.ms(
                lambda: _scatter(x, y, flux, frame, d), reps=5)
        for d in designs[1:]:
            out["runs"][f"{share}_same_image_{d}"] = bool(
                torch.equal(imgs["pixel0"], imgs[d]))
    # the scatter alone into 2^b-element buffers, at the last share
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
    # the copies accumulate adds: the frame into the padded buffer, back
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
    ap.add_argument("--h", type=int, default=FRAME[0])
    ap.add_argument("--w", type=int, default=FRAME[1])
    a = ap.parse_args()
    print(json.dumps(main(a.device, a.n, (a.h, a.w))))
