"""The `visit` driver: a visit from its catalog to files on disk through
`imsim_tpu_torch.config.runner.run_visit_iter` (the prefetch thread
prepares the next CCD while this one renders; the IO pool writes the
files), as `python -m imsim_tpu_torch config.yaml` runs it.  Set-up
starts the visit and takes its first `setup_ccds` CCDs: the first is
cold, with its own preparation, and the second's preparation ran beside
it, so the window starts in the steady state.  The window then takes
CCDs until the first one that completes at or after --seconds (or the
visit's last).  visit_ccd_s is the window's wall time over the CCDs it
completed.  Files go under the run's TMPDIR and are deleted at exit.

The mix's file gives `program` (config overrides: prefetch, IO
workers), `setup_ccds`, `compare_ccds` (how many of the window's CCDs
the reference reads back, drawn from the seed) and `compare_amps` (how
many of each such CCD's amps it decodes, drawn from the seed).
"""
from __future__ import annotations

import dataclasses
import gc
import os
import shutil
import threading
import time

import numpy as np

from .. import inputs
from ..reference import compare, measure
from . import common

# the steps of a CCD on the render thread (result["seconds"])
RENDER_STEPS = ("sky pieces", "render", "sky", "cosmic rays")


@dataclasses.dataclass
class State:
    cell: object
    seed: int
    device: object
    inp: inputs.Inputs
    it: object
    outdir: str
    window: list = dataclasses.field(default_factory=list)


def setup(cell, seed: int, device="cuda") -> State:
    from imsim_tpu_torch.config.interpreter import load_config
    from imsim_tpu_torch.config.runner import run_visit_iter

    work = common.workdir()
    outdir = os.path.join(work, "out")
    over = dict(cell.traffic.get("program") or {})
    over["output.dir"] = outdir
    inp = inputs.make(cell.config, seed, work, overrides=over)
    it = run_visit_iter(load_config(inp.program_cfg), device=device)
    # the first CCD, cold, and the second, whose preparation ran beside
    # the first's render: the window starts in the steady state, each of
    # its CCDs prepared while the one before renders
    for _ in range(int(cell.traffic["setup_ccds"])):
        next(it)
    common.sync(device)
    return State(cell=cell, seed=seed, device=device, inp=inp, it=it,
                 outdir=outdir)


def _keep(res: dict) -> dict:
    """What the check and the per-layer metrics read of a CCD."""
    return dict(det=res["det_name"], image=res["image"],
                eimage=res["eimage"], seconds=dict(res["seconds"]),
                prep_seconds=dict(res["prep"].seconds))


def window(state: State, seconds: float, trace: bool, t_start: float) -> dict:
    from imsim_tpu_torch.config.runner import HOST_TIMERS

    setup_s = time.perf_counter() - t_start
    timers0 = dict(HOST_TIMERS)
    win = common.Window(trace)
    done = []
    with win.run():
        for res in state.it:
            common.sync(state.device)
            state.window.append(_keep(res))
            done.append(time.perf_counter() - win.t0)
            if done[-1] >= seconds:
                break
    timers = {k: HOST_TIMERS[k] - timers0[k] for k in HOST_TIMERS}
    n = len(state.window)
    # each window CCD's own preparation (its clock's steps: a
    # preparation that straddles the window's start counts whole, with
    # its CCD); the readout and the writes from HOST_TIMERS
    prep = sum(sum(c["prep_seconds"].values()) for c in state.window)
    steps = sum(sum(c["seconds"].get(k, 0.0) for k in RENDER_STEPS)
                for c in state.window) + prep + timers["readout_s"] \
        + timers["io_s"]
    rec = dict(setup_s=setup_s, visit_ccd_s=win.seconds / n, attempted=n,
               failed=0, ccds=n, traced=trace,
               window_s=win.seconds, host_timers=timers, steps_s=steps,
               prep_s=prep, detail={"done_s": [round(t, 3) for t in done]},
               prep_seconds=[c["prep_seconds"] for c in state.window])
    rec.update(win.reduced)
    # the rest of the visit is not run: closing the generator ends the
    # prefetch thread and the IO pool once their work is done
    state.it.close()
    gc.collect()
    _join_workers(60.0)
    return rec


def _join_workers(timeout: float) -> None:
    """Wait (up to timeout) for the visit's worker threads, the prefetch
    thread and the IO pool, to end."""
    t_end = time.perf_counter() + timeout
    for t in threading.enumerate():
        if t.name.startswith("ThreadPoolExecutor"):
            t.join(max(0.0, t_end - time.perf_counter()))


def _files(state: State, det: str, wait_s: float = 60.0):
    """{truth, amp, eimage: path} of a CCD's files, waiting up to wait_s
    for late writes (a file counts once its size holds still)."""
    t0 = time.perf_counter()
    sizes = {}
    while True:
        names = {}
        for f in os.listdir(state.outdir):
            if det in f:
                kind = ("truth" if f.startswith("centroid") else
                        "amp" if f.startswith("amp") else
                        "eimage" if f.startswith("eimage") else None)
                if kind:
                    names[kind] = os.path.join(state.outdir, f)
        now = {k: os.path.getsize(p) for k, p in names.items()}
        if len(names) == 3 and now == sizes:
            return names
        if time.perf_counter() - t0 > wait_s:
            raise FileNotFoundError(
                f"{det}: files {sorted(os.listdir(state.outdir))}")
        sizes = now
        time.sleep(0.5)


def produced(state: State, ccd: dict, amps_k) -> compare.Produced:
    """A CCD of the window as the reference reads it back: the truth
    catalog, the eimage file (against the eimage in memory) and the
    sampled amps of the amp file; the rendered charge from memory."""
    f = _files(state, ccd["det"])
    truth = measure.read_truth(f["truth"])
    hdus = measure.read_fits(f["eimage"])
    eimage = np.asarray(measure.image(*hdus[0]), np.float32)
    gap = float(np.max(np.abs(eimage.astype(np.float64)
                              - np.asarray(ccd["eimage"], np.float64))))
    amp_hdus = measure.read_fits(f["amp"])[1:]
    amps = {k: measure.rice_image(*amp_hdus[k]) for k in amps_k}
    image = ccd["image"]
    image = image.cpu().numpy() if hasattr(image, "cpu") else image
    return compare.Produced(
        det=ccd["det"], ids=truth["object_id"], x=truth["x"], y=truth["y"],
        nominal=truth["nominal_flux"], realized=truth["realized_flux"],
        image=image, eimage=eimage,
        amps=amps, file_gap=gap)


def check(state: State, rec: dict, control: bool = False):
    """{number: (value, limit)}: each number's worst over the window's
    CCDs that the seed picks, read back from their files.  control=True
    also returns the control's {number: value} on the same CCDs (the
    eimage written in bfloat16 for file_gap) and the amounts of a
    planted fault, {"scale_0.9": {number: value}} (the charge and the
    frame scaled by 0.9)."""
    import torch

    tr = state.cell.traffic
    pick = common.rng(state.seed, 2)
    k = min(int(tr["compare_ccds"]), len(state.window))
    chosen = [state.window[i] for i in sorted(
        pick.choice(len(state.window), size=k, replace=False))]
    cfg = state.cell.config
    worst, ctrl, faults = {}, {}, {"scale_0.9": {}}
    for ccd in chosen:
        amps_k = sorted(pick.choice(16, size=int(tr["compare_amps"]),
                                    replace=False).tolist())
        prog = produced(state, ccd, amps_k)
        ccd["image"] = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        rec["detail"][ccd["det"]] = detail = {"amps": amps_k}
        vals = compare.numbers(state.inp.visit, state.inp.rows, prog,
                               cfg["check"], common.rng(state.seed, 1),
                               cfg["readout"], detail)
        for name, v in vals.items():
            worst[name] = max(worst.get(name, v), v)
        if control:
            p = compare.control(state.inp.visit, state.inp.rows, prog.det,
                                cfg["check"], cfg["readout"],
                                common.rng(state.seed, 1), prog.image,
                                prog.eimage, amps_k,
                                common.rng(state.seed, 3))
            e = np.asarray(prog.eimage, np.float64)
            p.file_gap = float(np.max(np.abs(compare.bf16(e) - e)))
            for name, v in compare.numbers(
                    state.inp.visit, state.inp.rows, p, cfg["check"],
                    common.rng(state.seed, 1),
                    cfg["readout"]).items():
                ctrl[name] = max(ctrl.get(name, v), v)
            f = faults["scale_0.9"]
            for name, v in compare.scaled_amounts(
                    state.inp.visit, state.inp.rows, prog, cfg["check"],
                    0.9).items():
                f[name] = max(f.get(name, v), v)
    state.window = []
    shutil.rmtree(state.inp.workdir, ignore_errors=True)
    lim = state.cell.limits
    out = {k: (v, lim[k]) for k, v in worst.items()}
    return (out, ctrl, faults) if control else out
