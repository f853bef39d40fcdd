"""What every cell shares: finding the cell's files by name, the card's
description, the traced window's reduction to device busy time, kernel
times and idle gaps, and the result line.

A cell `<config>.<mix>` reads `configs/<config>.json`,
`traffic/<mix>.json` (whose `driver` names `drivers/<driver>.py`) and
`limits/<cell>.json`; a per-layer metric `<name>` is read by
`metrics/<name>.py`.  A later cell, mix or metric adds files; nothing
here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# modules that may not be loaded in the process that prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "imsim_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


class Cell:
    """One entry of BENCHMARK.json's workloads with its files."""

    def __init__(self, name: str, bench: dict | None = None, **files):
        bench = bench or benchmark()
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        # files= replaces a file's contents (the tests' small cells)
        self.config = files.get("config") or load_json(
            ROOT, configs[self.entry["config"]]["file"])
        self.traffic = files.get("traffic") or load_json(
            HERE, "traffic", self.entry["traffic"] + ".json")
        self.limits = files.get("limits") or load_json(
            HERE, "limits", name + ".json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    def driver(self):
        return importlib.import_module(
            f"portbench.drivers.{self.traffic['driver']}")


def metric_reader(name: str):
    """metrics/<name>.py's read(record) -> number or None."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (imsim_tpu_torch is not imsim_tpu)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


# ---- the traced window ---------------------------------------------------------

def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def kineto_events(prof) -> list:
    """(name, start_us, end_us, device "CUDA" or "CPU", is annotation)
    of every event of a finished torch.profiler run, from its kineto
    results (building FunctionEvents takes minutes on a long window)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        out.append((e.name(), e.start_ns() * 1e-3,
                    (e.start_ns() + e.duration_ns()) * 1e-3,
                    str(e.device_type()).rsplit(".", 1)[-1],
                    bool(e.is_user_annotation())))
    return out


def reduce_trace(events, t0_us: float, t1_us: float) -> dict:
    """From the profiler's events (kineto_events) over the window
    [t0_us, t1_us]: busy_s, the union of device operations' intervals
    (kernels, copies and sets, every stream; annotations left out);
    kernel seconds by name; the device operations that took most time;
    the longest idle gaps, each named by the innermost host-side
    operation in progress at its middle ("host: no torch op" where none
    is)."""
    dev, host = [], []
    for name, start, end, kind, note in events:
        s, t = max(start, t0_us), min(end, t1_us)
        if t <= s or note or name.startswith("portbench."):
            continue
        if kind == "CUDA":
            dev.append((s, t, name))
        elif kind == "CPU":
            host.append((start, end, name))
    by_name = {}
    for s, t, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (t - s) * 1e-6
    busy = _merge([(s, t) for s, t, _ in dev])
    busy_s = sum(t - s for s, t in busy) * 1e-6
    gaps, prev = [], t0_us
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if t1_us > prev:
        gaps.append((prev, t1_us))
    gaps.sort(key=lambda g: g[0] - g[1])
    host.sort(key=lambda h: h[1] - h[0])
    named = []
    for s, t in gaps[:10]:
        mid = 0.5 * (s + t)
        label = next((n for a, b, n in host if a <= mid <= b),
                     "host: no torch op")
        named.append([label, (t - s) * 1e-6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy_s, window_s=(t1_us - t0_us) * 1e-6,
                kernels=by_name, device_ops=[[n[:120], v] for n, v in top],
                idle_gaps=named)


def device_info(chips: int) -> dict:
    import torch

    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=chips, memory_peak_bytes=int(peak))


def checks_line(checks: dict) -> dict:
    """{name: {value, limit}}: each compared number beside its limit."""
    return {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}


def passed(checks: dict) -> bool:
    return all(v is not None and v <= lim for v, lim in checks.values())
