"""Static instruction mix of the port's built kernels (cuobjdump -sass).

For each kernel of the library ops/_build.py builds (filtered by
substrings of the mangled name), counts the SASS instructions by class:
FP32 arithmetic (FFMA, FMUL, FADD), special-function unit (MUFU),
shared, global, local (spill) and constant-bank loads and stores,
branches.  The counts are of the code, not of executed instructions;
they show what a kernel's inner loop is made of, e.g. shared loads per
FMA or local-memory traffic.

On the card:  python3 -m imsim_tpu_torch.benchmarks.sass_stats \\
                  ray_chain stencil_pair_kernelILi9
"""
from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess

from ..ops import _build

CLASSES = {
    "FFMA": ("FFMA",), "FMUL": ("FMUL",), "FADD": ("FADD",),
    "MUFU": ("MUFU",), "LDS": ("LDS",), "STS": ("STS",),
    "LDG": ("LDG",), "STG": ("STG",), "LDL": ("LDL",), "STL": ("STL",),
    "LDC": ("LDC", "ULDC"), "BRA": ("BRA", "BRX"),
}
_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")


def cuobjdump() -> str:
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("cuobjdump not found")


def mix(sass: str) -> dict:
    """{mangled kernel name: Counter of opcodes} from cuobjdump -sass."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), collections.Counter())
            continue
        m = _INSTR.search(line)
        if m and cur is not None:
            cur[m.group(1)] += 1
    return out


def summary(ops: collections.Counter) -> dict:
    row = {"total": sum(ops.values())}
    for cls, names in CLASSES.items():
        row[cls] = sum(ops[n] for n in names)
    return row


def main(patterns=(), dump=None, log=print) -> dict:
    """Log each matching kernel's instruction mix; with `dump`, also
    write its full SASS to dump/<kernel>.sass."""
    lib = _build.build()
    sass = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    report = {}
    for name, ops in sorted(mix(sass).items()):
        if patterns and not any(p in name for p in patterns):
            continue
        report[name] = row = summary(ops)
        log(f"[sass] {name}: " + " ".join(f"{k} {v}" for k, v in
                                          row.items()))
        if dump:
            os.makedirs(dump, exist_ok=True)
            text = subprocess.run([cuobjdump(), "-sass", "-fun", name, lib],
                                  capture_output=True, text=True,
                                  check=True).stdout
            with open(os.path.join(dump, f"{name[:80]}.sass"), "w") as f:
                f.write(text)
    return report


def _cli():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("patterns", nargs="*",
                    help="substrings of the kernels' mangled names")
    ap.add_argument("--dump", help="directory for each kernel's SASS")
    a = ap.parse_args()
    main(a.patterns, a.dump)


if __name__ == "__main__":
    _cli()
