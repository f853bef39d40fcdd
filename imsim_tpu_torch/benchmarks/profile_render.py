"""Warm stage times and the span store's seconds of the whole bench CCD.

Runs the bench workload (`_util.workload`, the scene chip_smoke.py
drives) through the CCD's device stages: `render_ccd_pooled` with the
FFT branch (the bright stars with diffraction spikes at the full well),
`add_sky_and_noise` and the readout chain to raw amps.  One cold run,
`--warm` timed warm runs (host clock around each stage, ending in
torch.cuda.synchronize()), then one warm run with tracing on
(imsim_tpu_torch.utils.trace): the host and device seconds of each span
name, summed (the render's `render.fft`, `render.plan`, `render.batch`
with `render.rows`, `render.shoot` and `render.sensor`; the stages as
`ccd.render`, `ccd.sky`, `ccd.cosmic_rays`, `ccd.readout`), and the
binner's counters.  Device seconds come from CUDA events on the stream,
so they hold the idle time inside a span; the kernels by name are the
benchmark's (`portbench`, `--trace 1`).  The FFT pass runs inside the
render; it is also timed alone (the same call on an empty frame) and
traced alone.

--analytic runs the same bench catalog through the analytic PSF
(`_util.analytic_workload`: render without optics, sky, cosmic rays,
readout); --det NAME renders detector NAME on the optics path from the
state `convert.build_ccd_state` builds at the bench pointing (the
runner's silicon; the bench catalog's draws over that CCD's frame; the
host seconds of the build reported), as chip_smoke's phase 9 does for
R10_S11; --flats times and traces the flats of chip_smoke's phase 7
(`build_flat` at the runner's defaults, `build_flat_photons` at the cut)
instead of a CCD; --instcat renders chip_smoke phase 10's instance-catalog
CCD through the runner's per-CCD path (config/runner.render_one_ccd), with
the host seconds of its preparation.

On the card, from the root of a checkout:
    python3 -m imsim_tpu_torch.benchmarks.profile_render [--analytic | --det R10_S11 | --flats | --instcat]
Prints one JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import time

import torch

from ..utils import trace


def _traced(fn) -> dict:
    """fn() -> wall seconds, run once with tracing on: the wall, each
    span name's count and summed host and device seconds, and each
    counter's total."""
    trace.reset()
    trace.enable()
    try:
        wall = fn()
    finally:
        trace.disable()
    spans, counters = {}, {}
    for s in trace.spans():
        row = spans.setdefault(s["name"], dict(count=0, host_s=0.0,
                                               device_s=0.0))
        row["count"] += 1
        row["host_s"] += s["host_s"]
        row["device_s"] += s["device_s"] or 0.0
    for c in trace.counters():
        counters[c["name"]] = counters.get(c["name"], 0.0) + c["value"]
    trace.reset()
    return dict(wall_s=wall, spans=spans, counters=counters)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _timed(fn, span=None):
    """(fn(), host seconds to the card's end of it); with `span`, also
    that span on the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with trace.span(span, device="cuda") if span \
            else contextlib.nullcontext():
        out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main(warm: int = 3, analytic: bool = False, det: str = None) -> dict:
    from ..image import photon_pooling as PP
    from ..image.ccd_render import add_sky_and_noise
    from ..image.cosmic_rays import CR_RATE_DEFAULT, paint_cosmic_rays
    from ..image.diffraction_fft import spike_kernel
    from ..psf.atmosphere import make_screens
    from ..utils.rng import ATM_SEED_OFFSET, stream
    from ._util import analytic_workload, workload

    if not torch.cuda.is_available():
        raise SystemExit("profile_render: needs a CUDA device")
    device = torch.device("cuda")
    smi = _smi()
    build_s = None
    if analytic:
        state, host, cfg = analytic_workload(device)
    else:
        built = None
        if det is not None:
            from ..convert import BENCH_POINTING, build_ccd_state

            t0 = time.perf_counter()
            built = build_ccd_state(det, **BENCH_POINTING, device=device,
                                    silicon="runner")
            build_s = time.perf_counter() - t0
        state, host, cfg, ctx = workload(device, state=built)
        screens = make_screens(state.screen_spec, device,
                               gen=stream(42 + ATM_SEED_OFFSET, "screens",
                                          device=device))
    spikes = dict(kernel=spike_kernel(622.0, 0.2, alpha_deg=45.0,
                                      rot_smear_deg=0.1, device=device),
                  sat=state.readout.full_well)

    def render():
        if analytic:
            return PP.render_ccd_pooled(0, host, cfg, state.silicon,
                                        profiles=state.profiles,
                                        spikes=spikes)
        return PP.render_ccd_pooled(
            0, host, cfg, state.silicon, state.tel, ctx, screens,
            state.sk_table, profiles=state.profiles, spikes=spikes)

    def ccd():
        (image, _, _), t_r = _timed(render, "ccd.render")
        eimage, t_s = _timed(lambda: add_sky_and_noise(
            stream(0, "sky", device=device), image, state.sky_level,
            (0.0, 0.0, 1.0), state.vig_coarse, cfg.pixel_scale,
            vig_step=state.vig_step), "ccd.sky")
        t = dict(render=t_r, sky=t_s)
        if analytic:
            eimage, t["cosmic_rays"] = _timed(lambda: paint_cosmic_rays(
                eimage, cfg.exptime, 189, ccd_rate=CR_RATE_DEFAULT),
                "ccd.cosmic_rays")
        _, t["readout"] = _timed(lambda: state.readout.chain(
            stream(0, "readout", device=device), eimage, cfg.exptime),
            "ccd.readout")
        t["ccd"] = sum(t.values())
        return t

    psf = PP.make_psf_mtf(cfg)
    modes = PP.classify_objects(host, cfg, psf)

    def fft_pass():
        return _timed(lambda: PP._fft_pass(
            torch.zeros((cfg.ysize, cfg.xsize), device=device), host, modes,
            cfg, psf, 0, spikes=spikes))[1]

    cold = ccd()
    walls = [ccd() for _ in range(warm)]
    fft_walls = [fft_pass() for _ in range(warm)]
    return dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
                path="analytic" if analytic else "optics",
                det=state.det_name, frame=(state.ny, state.nx),
                build_s=build_s,
                n_fft=int((modes == PP.FFT).sum()), cold=cold, warm=walls,
                fft_pass_warm_s=fft_walls,
                traced_ccd=_traced(lambda: ccd()["ccd"]),
                traced_fft_pass=_traced(fft_pass))


def main_flats(warm: int = 3) -> dict:
    """build_flat (the runner's defaults) and build_flat_photons (the
    cut) on R22_S11's frame with the bench silicon: cold and warm wall
    times, and one traced warm run of each (the span `flat` or
    `photon_flat`)."""
    from ..convert import load_ccd_state
    from ..image import flat as FL
    from ._util import flat_workload

    if not torch.cuda.is_available():
        raise SystemExit("profile_render: needs a CUDA device")
    device = torch.device("cuda")
    smi = _smi()
    sil = load_ccd_state(device=device).silicon
    cfg, pcfg, wl = flat_workload()
    out = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    for name, fn in (("flat", lambda: FL.build_flat(1, cfg, sil, device)),
                     ("photon_flat", lambda: FL.build_flat_photons(
                         2, pcfg, wl, sil, device))):
        walls = [_timed(fn)[1] for _ in range(warm + 1)]
        out[name] = dict(cold=walls[0], warm=walls[1:],
                         traced=_traced(lambda: _timed(fn, name)[1]))
    return out


def main_instcat(warm: int = 3, band: str = "r") -> dict:
    """The instance-catalog CCD of chip_smoke's phase 10: the generated
    workload (benchmarks/instcat_workload.py, full size, in a temporary
    directory), the visit context and prepare_ccd of R22_S11 with each
    host step's seconds, then render_one_ccd (the runner's per-CCD path:
    render, sky, cosmic rays, readout) cold, `warm` times warm with its
    per-stage seconds, and one traced warm run."""
    import tempfile

    from ..config import runner as TR
    from ..image import photon_pooling as PP
    from .instcat_workload import visit_context, write_workload

    if not torch.cuda.is_available():
        raise SystemExit("profile_render: needs a CUDA device")
    device = torch.device("cuda")
    smi = _smi()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        wl = write_workload(d)
        write_s = time.perf_counter() - t0
        ctx = visit_context(wl["catalog"][band], wl["sed_dir"])
        prep = TR.prepare_ccd(ctx, "R22_S11", device=device)
        host_s = dict(ctx.seconds, **prep.seconds)

        def ccd():
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = TR.render_one_ccd(ctx, "R22_S11", device, prep=prep)
            torch.cuda.synchronize()
            return dict(res["seconds"], ccd=time.perf_counter() - t)

        cold = ccd()
        walls = [ccd() for _ in range(warm)]
        traced = _traced(lambda: ccd()["ccd"])
    cfg = prep.pcfg
    modes = PP.classify_objects(prep.host, cfg, PP.make_psf_mtf(cfg))
    _, total, nb, _ = PP.pooled_plan(prep.host, modes, cfg)
    return dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
                path="instcat", band=band, det="R22_S11",
                frame=(cfg.ysize, cfg.xsize), write_s=write_s, host_s=host_s,
                n_objects=prep.host.n_objects, pooled=total, nbatch=nb,
                n_fft=int((modes == PP.FFT).sum()), cold=cold, warm=walls,
                traced_ccd=traced)


def _cli():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warm", type=int, default=3)
    kind = ap.add_mutually_exclusive_group()
    kind.add_argument("--analytic", action="store_true",
                      help="the bench catalog through the analytic PSF")
    kind.add_argument("--det", help="a detector on the optics path, its "
                      "state built from the bench pointing")
    kind.add_argument("--flats", action="store_true",
                      help="the flats of chip_smoke's phase 7")
    kind.add_argument("--instcat", action="store_true",
                      help="the instance-catalog CCD of chip_smoke's phase 10")
    a = ap.parse_args()
    if a.flats:
        out = main_flats(a.warm)
    elif a.instcat:
        out = main_instcat(a.warm)
    else:
        out = main(a.warm, a.analytic, a.det)
    print(json.dumps(out))


if __name__ == "__main__":
    _cli()
