"""The pooled render's binning scatter on one chunk of photons with a
share of them outside the frame.

`sensor/simple.accumulate` bins a chunk with one
`index_put_(accumulate=True)` and sends every out-of-frame photon (flux
0) to pixel 0.  PyTorch sorts the indices and adds each run of equal
indices in one thread, so that run costs time in proportion to its
length.  This probe times the scatter as accumulate builds it, and the
same scatter with the out-of-frame photons' zero flux sent to distinct
pixels instead (the same image: adding +0.0 changes no pixel), on a
chunk of the instance-catalog CCD's size (7.5e6-photon batches in 4
chunks) with 0%, 0.2% (the bench CCD's) and 9% (the instance-catalog
CCD's) of the photons out of frame.

On the card, from the root of a checkout:
    python3 -m imsim_tpu_torch.benchmarks.accumulate_probe
Prints one JSON line.
"""
from __future__ import annotations

import json
import subprocess

import torch

from ._util import Timer

N_CHUNK = 1_876_480
FRAME = (4004, 4096)


def _scatter(image, x, y, flux, spread: bool):
    """accumulate's binning; spread=True gives each out-of-frame photon
    its own pixel (photon index mod the frame) in place of pixel 0."""
    H, W = image.shape
    fx, fy = torch.round(x), torch.round(y)
    inb = (fx >= 0) & (fx < W) & (fy >= 0) & (fy < H)
    f = torch.where(inb, flux, 0.0)
    idx = torch.where(inb, fy, 0.0).to(torch.int64) * W \
        + torch.where(inb, fx, 0.0).to(torch.int64)
    if spread:
        idx = torch.where(inb, idx, torch.arange(
            idx.numel(), device=idx.device) % (H * W))
    image.view(-1).index_put_((idx,), f, accumulate=True)
    return image


def main(device="cuda") -> dict:
    device = torch.device(device)
    timer = Timer(device)
    gen = torch.Generator(device=device).manual_seed(9)
    H, W = FRAME
    out = dict(device=torch.cuda.get_device_name(0) if timer.cuda
               else "cpu", n=N_CHUNK, frame=FRAME, runs={})
    if timer.cuda:
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    for share in (0.0, 0.002, 0.09):
        x = torch.rand(N_CHUNK, generator=gen, device=device) * W - 0.5
        y = torch.rand(N_CHUNK, generator=gen, device=device) * H - 0.5
        n_out = int(share * N_CHUNK)
        x[:n_out] = -50.0           # the cull margin, left of the frame
        flux = torch.ones(N_CHUNK, device=device)
        imgs = {}
        for spread in (False, True):
            img = torch.zeros(FRAME, device=device)
            imgs[spread] = _scatter(img, x, y, flux, spread)
            out["runs"][f"{share}_{'spread' if spread else 'pixel0'}_ms"] = \
                timer.ms(lambda: _scatter(torch.zeros(FRAME, device=device),
                                          x, y, flux, spread), reps=5)
        out["runs"][f"{share}_same_image"] = bool(
            torch.equal(imgs[False], imgs[True]))
    return out


if __name__ == "__main__":
    print(json.dumps(main()))
