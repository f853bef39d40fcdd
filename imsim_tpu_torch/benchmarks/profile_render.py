"""Warm stage times and device idle share of the whole bench CCD.

Runs the bench workload (`_util.workload`, the scene chip_smoke.py
drives) through the CCD's device stages: `render_ccd_pooled` with the
FFT branch (the bright stars with diffraction spikes at the full well),
`add_sky_and_noise` and the readout chain to raw amps.  One cold run,
`--warm` timed warm runs (host clock around each stage, ending in
torch.cuda.synchronize()), then one warm run under torch.profiler: its
device busy time is the sum of the device time of every kernel, copy and
fill (one stream, so they do not overlap), its idle share
1 - busy / wall.  The FFT pass runs inside the render; it is also timed
alone (the same call on an empty frame) and profiled alone, with its
largest device kernels.

On the card, from the root of a checkout:
    python3 -m imsim_tpu_torch.benchmarks.profile_render
Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch


def _device_events(prof) -> list:
    """(name, microseconds, count) of the device-side events (kernels,
    copies, fills) of a profile, largest first; host-side ops, which
    also carry their kernels' time, are left out so nothing counts
    twice."""
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.device_type == cuda]
    return sorted(rows, key=lambda r: -r[1])


def _profiled(fn) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall = fn()
    rows = _device_events(prof)
    busy = sum(r[1] for r in rows) * 1e-6
    return dict(wall_s=wall, device_busy_s=busy,
                device_events=sum(r[2] for r in rows),
                idle_share=1.0 - busy / wall,
                top_kernels=[dict(name=n[:90], ms=us * 1e-3, count=c)
                             for n, us, c in rows[:8]])


def main(warm: int = 3) -> dict:
    from ..image import photon_pooling as PP
    from ..image.ccd_render import add_sky_and_noise
    from ..image.diffraction_fft import spike_kernel
    from ..psf.atmosphere import make_screens
    from ..utils.rng import ATM_SEED_OFFSET, stream
    from ._util import workload

    if not torch.cuda.is_available():
        raise SystemExit("profile_render: needs a CUDA device")
    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    state, host, cfg, ctx = workload(device)
    screens = make_screens(state.screen_spec, device,
                           gen=stream(42 + ATM_SEED_OFFSET, "screens",
                                      device=device))
    spikes = dict(kernel=spike_kernel(622.0, 0.2, alpha_deg=45.0,
                                      rot_smear_deg=0.1, device=device),
                  sat=state.readout.full_well)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def ccd():
        (image, _, _), t_r = timed(lambda: PP.render_ccd_pooled(
            0, host, cfg, state.silicon, state.tel, ctx, screens,
            state.sk_table, profiles=state.profiles, spikes=spikes))
        eimage, t_s = timed(lambda: add_sky_and_noise(
            stream(0, "sky", device=device), image, state.sky_level,
            (0.0, 0.0, 1.0), state.vig_coarse, cfg.pixel_scale,
            vig_step=state.vig_step))
        _, t_o = timed(lambda: state.readout.chain(
            stream(0, "readout", device=device), eimage, cfg.exptime))
        return dict(render=t_r, sky=t_s, readout=t_o, ccd=t_r + t_s + t_o)

    psf = PP.make_psf_mtf(cfg)
    modes = PP.classify_objects(host, cfg, psf)

    def fft_pass():
        return timed(lambda: PP._fft_pass(
            torch.zeros((cfg.ysize, cfg.xsize), device=device), host, modes,
            cfg, psf, 0, spikes=spikes))[1]

    cold = ccd()
    walls = [ccd() for _ in range(warm)]
    fft_walls = [fft_pass() for _ in range(warm)]
    prof_ccd = _profiled(lambda: ccd()["ccd"])
    prof_fft = _profiled(fft_pass)
    return dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
                n_fft=int((modes == PP.FFT).sum()), cold=cold, warm=walls,
                fft_pass_warm_s=fft_walls, profiled_ccd=prof_ccd,
                profiled_fft_pass=prof_fft)


def _cli():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warm", type=int, default=3)
    a = ap.parse_args()
    print(json.dumps(main(a.warm)))


if __name__ == "__main__":
    _cli()
