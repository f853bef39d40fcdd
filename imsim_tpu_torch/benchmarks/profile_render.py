"""Warm wall time and device idle share of the pooled CCD render.

Runs the bench workload (`_util.workload`, the scene chip_smoke.py
drives) through `render_ccd_pooled`: one cold run, `--warm` timed warm
runs (host clock around work that ends in torch.cuda.synchronize()),
then one warm run under torch.profiler.  The
profiled run's device busy time is the sum of the device time of every
kernel, copy and fill (one stream, so they do not overlap); its idle
share is 1 - busy / wall.

On the card, from the root of a checkout:
    python3 -m imsim_tpu_torch.benchmarks.profile_render
Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import time

import torch


def _device_busy_us(prof) -> tuple:
    """(microseconds, count) of the device-side events (kernels, copies,
    fills) of a profile; host-side ops, which also carry their kernels'
    time, are left out so nothing counts twice."""
    cuda = torch.autograd.DeviceType.CUDA
    total, count = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == cuda:
            total += e.self_device_time_total
            count += e.count
    return total, count


def main(warm: int = 3) -> dict:
    from ..image.photon_pooling import render_ccd_pooled
    from ..psf.atmosphere import make_screens
    from ..utils.rng import ATM_SEED_OFFSET, stream
    from ._util import workload

    if not torch.cuda.is_available():
        raise SystemExit("profile_render: needs a CUDA device")
    device = torch.device("cuda")
    state, host, cfg, ctx = workload(device)
    screens = make_screens(state.screen_spec, device,
                           gen=stream(42 + ATM_SEED_OFFSET, "screens",
                                      device=device))

    def render():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_ccd_pooled(0, host, cfg, state.silicon, state.tel, ctx,
                          screens, state.sk_table, profiles=state.profiles,
                          tally={})
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    cold = render()
    walls = [render() for _ in range(warm)]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prof_wall = render()
    busy_us, events = _device_busy_us(prof)
    busy = busy_us * 1e-6
    return dict(device=torch.cuda.get_device_name(0), cold_s=cold,
                warm_s=walls, profiled_wall_s=prof_wall, device_busy_s=busy,
                device_events=events, idle_share=1.0 - busy / prof_wall)


def _cli():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warm", type=int, default=3)
    a = ap.parse_args()
    print(json.dumps(main(a.warm)))


if __name__ == "__main__":
    _cli()
