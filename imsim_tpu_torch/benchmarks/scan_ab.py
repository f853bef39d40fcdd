"""K1 and K4 of this checkout against another checkout's, in turns on one
card, at the main path's shapes.

    python3 -m imsim_tpu_torch.benchmarks.scan_ab --other DIR

DIR is the root of another checkout of the repository (for example a
parent commit unpacked with `git archive` into a directory that
.gitignore lists).  Its `imsim_tpu_torch/ops` package is loaded under
another name and builds its own kernels into its own tree, so both
versions run in one process on one card.  At each shape the order is
other, this, this, other (CUDA events, warm calls, `benchmarks._util.
Timer`); neither kernel's time depends on the values, so the inputs are
normal deltas made from a seed.  The K1 shapes are batch 0's (C, pe, mp)
on each path, as chip_smoke.py logs them ("[... K1] (C, pe, mp) = ...");
K4's is the probe's (probe_rows).  Prints the card's name and power
limit, then one JSON line per shape.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import torch

from ..ops import scanrows
from ._util import Timer, bound

# batch 0's (C, pe, mp) on each path (chip_smoke.py's [K1] lines)
K1_SHAPES = {"bench": (24, 16, 1_167_360), "instcat": (24, 16, 471_040),
             "skycat": (24, 16, 495_616), "skycat_native": (24, 16, 67_584)}
K4_SHAPE = (24, 16_777_216)


def load_ops(root: str, alias: str):
    """`imsim_tpu_torch.ops` of the checkout at `root`, as package
    `alias`: (its scanrows module, its _build module)."""
    path = os.path.join(os.path.abspath(root), "imsim_tpu_torch", "ops")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(path, "__init__.py"),
        submodule_search_locations=[path])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module(f"{alias}.scanrows"),
            importlib.import_module(f"{alias}._build"))


def in_turns(timer: Timer, this, other) -> dict:
    """other, this, this, other: each version's two times (ms)."""
    t = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        t[who].append(timer.ms(this if who == "this" else other))
    return t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="root of the checkout to compare with")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scan_ab: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[scan_ab] {torch.cuda.get_device_name(0)}; {smi}", flush=True)
    o_scan, o_build = load_ops(args.other, "other_ops")
    o_build.library()
    timer = Timer(dev)
    g = torch.Generator(device=dev).manual_seed(20261018)
    for path, (C, pe, mp) in K1_SHAPES.items():
        d = torch.randn((C, pe, mp), generator=g, device=dev)
        this = lambda: scanrows.scan_slot_prefix(d, 4, pe // 4)  # noqa: E731
        other = lambda: o_scan.scan_slot_prefix(d, 4, pe // 4)  # noqa: E731
        gap = float((this() - other()).abs().max())
        print(json.dumps(dict(kernel="scan_slot_prefix", path=path,
                              shape=[C, pe, mp], gap_vs_other=gap,
                              **in_turns(timer, this, other),
                              **bound(d.numel(), 8 * d.numel()))),
              flush=True)
        del d
    C, N = K4_SHAPE
    x = torch.randn((C, N), generator=g, device=dev)
    this = lambda: scanrows.scan_lanes(x)  # noqa: E731
    other = lambda: o_scan.scan_lanes(x)  # noqa: E731
    gap = float((this() - other()).abs().max())
    print(json.dumps(dict(kernel="scan_lanes", shape=[C, N],
                          gap_vs_other=gap, **in_turns(timer, this, other),
                          **bound(x.numel(), 8 * x.numel()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
