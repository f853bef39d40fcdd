"""The `ccd` driver: one CCD prepared once in set-up, then rendered again
and again in a closed loop through
`imsim_tpu_torch.config.runner.render_one_ccd(ctx, det, device,
prep=prep)`: sky pieces, the pooled render, sky and noise, cosmic rays
and the readout to raw amps, no files.  ccd_s is the window's wall time
over the CCDs it completed; the window ends at the first CCD that
completes at or after --seconds.

The mix's file gives `det` (the CCD) and `warmups` (renders in set-up
after the preparation).
"""
from __future__ import annotations

import dataclasses
import shutil
import time

import numpy as np

from .. import inputs
from ..reference import compare
from . import common


@dataclasses.dataclass
class State:
    cell: object
    seed: int
    device: object
    inp: inputs.Inputs
    ctx: object
    prep: object
    last: dict | None = None


def setup(cell, seed: int, device="cuda") -> State:
    from imsim_tpu_torch.config.interpreter import load_config
    from imsim_tpu_torch.config.runner import (build_visit_context,
                                               prepare_ccd, render_one_ccd)

    det = cell.traffic["det"]
    inp = inputs.make(cell.config, seed, common.workdir(), only_det=det,
                      overrides=cell.traffic.get("program"))
    ctx = build_visit_context(load_config(inp.program_cfg))
    prep = prepare_ccd(ctx, det, device=device)
    for _ in range(int(cell.traffic["warmups"])):
        render_one_ccd(ctx, det, device, prep=prep)
    common.sync(device)
    return State(cell=cell, seed=seed, device=device, inp=inp, ctx=ctx,
                 prep=prep)


def window(state: State, seconds: float, trace: bool, t_start: float) -> dict:
    from imsim_tpu_torch.config.runner import render_one_ccd

    det = state.cell.traffic["det"]
    setup_s = time.perf_counter() - t_start
    win = common.Window(trace)
    n = 0
    with win.run():
        while True:
            res = render_one_ccd(state.ctx, det, state.device,
                                 prep=state.prep)
            common.sync(state.device)
            n += 1
            state.last = res
            if time.perf_counter() - win.t0 >= seconds:
                break
    rec = dict(setup_s=setup_s, ccd_s=win.seconds / n, attempted=n, failed=0,
               ccds=n, traced=trace, window_s=win.seconds)
    rec.update(win.reduced)
    return rec


def _produced(state: State) -> compare.Produced:
    res, prep = state.last, state.prep
    n = prep.host.n_objects
    amps = res["amps"].cpu().numpy()
    return compare.Produced(
        det=prep.det_name,
        ids=np.asarray(prep.table.id).astype(np.int64),
        x=np.asarray(prep.host.pix_x, float)[:n],
        y=np.asarray(prep.host.pix_y, float)[:n],
        nominal=np.asarray(prep.host.nominal_flux, float)[:n],
        realized=np.asarray(res["realized"], float)[:n],
        image=res["image"].cpu().numpy(), eimage=res["eimage"].cpu().numpy(),
        amps={k: amps[k] for k in range(amps.shape[0])})


def check(state: State, rec: dict, control: bool = False):
    """{number: (value, limit)} for the last CCD of the window, with the
    program's state freed first; in a traced run also the work the
    kernels' rooflines count (rec['work']).  control=True also returns
    the control's {number: value} (compare.control in the program's
    place) and the amounts of a planted fault, {"scale_0.9": {number:
    value}} (the charge and the frame scaled by 0.9)."""
    import torch

    prog = _produced(state)
    state.last = state.prep = state.ctx = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    cfg = state.cell.config
    rec["detail"] = {"ccd": prog.det}
    vals = compare.numbers(state.inp.visit, state.inp.rows, prog,
                           cfg["check"], common.rng(state.seed, 1),
                           cfg["readout"], rec["detail"])
    ctrl = faults = None
    if control:
        p = compare.control(state.inp.visit, state.inp.rows, prog.det,
                            cfg["check"], cfg["readout"],
                            common.rng(state.seed, 1), prog.image,
                            prog.eimage, sorted(prog.amps),
                            common.rng(state.seed, 3))
        ctrl = compare.numbers(state.inp.visit, state.inp.rows, p,
                               cfg["check"], common.rng(state.seed, 1),
                               cfg["readout"])
        faults = {"scale_0.9": compare.scaled_amounts(
            state.inp.visit, state.inp.rows, prog, cfg["check"], 0.9)}
    if rec.get("traced"):
        from .. import work

        rec["work"] = work.ccd_work(state.inp.visit, state.inp.rows,
                                    prog.det, cfg, rec["ccds"])
    shutil.rmtree(state.inp.workdir, ignore_errors=True)
    lim = state.cell.limits
    out = {k: (v, lim[k]) for k, v in vals.items()}
    return (out, ctrl, faults) if control else out
