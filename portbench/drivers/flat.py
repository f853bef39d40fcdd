"""The `flat` driver: imSim's LSST_Flat image type with an SED, a whole
CCD's photons shot through the silicon model, again and again in a
closed loop through `imsim_tpu_torch.config.runner.render_one_ccd(ctx,
det, device)`, no files.  ccd_s is the window's wall time over the
flats it completed; the window ends at the first flat that completes
at or after --seconds.

The program's config is the configuration's `template` with its
`program` overrides, the SED written under the run's work directory
and the visit's seed drawn from --seed.  The mix's file gives `det`
(the CCD) and `warmups`: flats in set-up at one iteration's level
(counts_per_iter electrons a pixel), which run every shape of the
full flat's sub-batches.

The check: the reference (reference/flat.py) shoots its own flat of the
same frame on the same device with its own draws, after the program's
state is freed, and reference/flat.numbers compares the window's last
flat with it.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import time

import numpy as np

from ..reference import flat as ref
from . import common


@dataclasses.dataclass
class State:
    cell: object
    seed: int
    device: object
    workdir: str
    sed_path: str
    ctx: object
    last: object = None


def _write_sed(cfg: dict, workdir: str) -> tuple:
    """(sed_dir, path): the configuration's SED, constant f_lambda on a
    uniform grid, as imSim's examples/seds/flatSED/sed_flat.txt."""
    s = cfg["sed"]
    sed_dir = os.path.join(workdir, "seds")
    path = os.path.join(sed_dir, s["file"])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    wave = np.linspace(*s["wave_nm"], int(s["points"]))
    flam = np.full_like(wave, s["f_lambda"])
    np.savetxt(path, np.column_stack([wave, flam]),
               header="wavelength_nm f_lambda (flat example SED)")
    return sed_dir, path


def program_config(cfg: dict, seed: int, sed_dir: str) -> dict:
    prog = {"template": cfg["template"],
            "input.instance_catalog.sed_dir": sed_dir,
            "opsim_meta.seed": int(seed) % 2**31}
    prog.update(cfg["program"])
    return prog


def setup(cell, seed: int, device="cuda") -> State:
    from imsim_tpu_torch.config.interpreter import load_config
    from imsim_tpu_torch.config.runner import (build_visit_context,
                                               render_one_ccd)

    cfg = cell.config
    work = common.workdir()
    sed_dir, sed_path = _write_sed(cfg, work)
    prog = program_config(cfg, seed, sed_dir)
    ctx = build_visit_context(load_config(prog))
    warm = build_visit_context(load_config(dict(
        prog, **{"image.counts_per_pixel": cfg["counts_per_iter"]})))
    for _ in range(int(cell.traffic["warmups"])):
        render_one_ccd(warm, cell.traffic["det"], device)
    common.sync(device)
    return State(cell=cell, seed=seed, device=device, workdir=work,
                 sed_path=sed_path, ctx=ctx)


def window(state: State, seconds: float, trace: bool, t_start: float) -> dict:
    from imsim_tpu_torch.config.runner import render_one_ccd

    det = state.cell.traffic["det"]
    setup_s = time.perf_counter() - t_start
    win = common.Window(trace)
    n = 0
    with win.run():
        while True:
            res = render_one_ccd(state.ctx, det, state.device)
            common.sync(state.device)
            n += 1
            state.last = res["image"]
            if time.perf_counter() - win.t0 >= seconds:
                break
    rec = dict(setup_s=setup_s, ccd_s=win.seconds / n, attempted=n, failed=0,
               ccds=n, traced=trace, window_s=win.seconds)
    rec.update(win.reduced)
    return rec


def _reference(state: State, h: int, w: int, stream: int, dtype=None,
               bf: bool = True, rings: bool = True, keep: float = 1.0):
    """A reference flat of the (h, w) frame on the run's device with
    draws of its own (`stream`); bf, rings, keep: reference/flat's
    planted faults."""
    import torch

    cfg = state.cell.config
    si = ref.silicon(cfg, state.cell.traffic["det"], bf=bf, rings=rings)
    gen = torch.Generator(device=state.device)
    gen.manual_seed(int(common.rng(state.seed, stream).integers(2**62)))
    icdf = ref.wavelength_icdf(state.sed_path, cfg["band"], cfg["airmass"])
    img = ref.build(h, w, cfg["counts_per_pixel"], cfg["counts_per_iter"],
                    icdf, si, ref.torch_draws(gen), state.device,
                    dtype=dtype or torch.float32, keep=keep)
    return img.float().cpu().numpy()


def check(state: State, rec: dict, control: bool = False):
    """{number: (value, limit)} for the last flat of the window, with the
    program's state freed first; in a traced run also the work K3's
    roofline counts (rec['work']).  control=True also returns the
    control's {number: value} (the reference in bfloat16 in the
    program's place) and the numbers of planted faults, each the
    reference with the fault in the program's place ("no_bf": no
    kernel, "no_rings": no tree rings, "half_photons": half of each
    sub-batch's photons dropped) or the flat scaled ("scale_0.9")."""
    import torch

    prog = state.last.float().cpu().numpy()
    state.last = state.ctx = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    cfg = state.cell.config
    h, w = prog.shape
    t0 = time.perf_counter()
    sound = _reference(state, h, w, 5)
    model = ref.Model.of(cfg, state.cell.traffic["det"], state.sed_path,
                         h, w, state.device)
    rec["detail"] = {"ccd": state.cell.traffic["det"],
                     "reference_s": time.perf_counter() - t0}
    vals = ref.numbers(prog, sound, model, cfg["check"], rec["detail"])
    ctrl = faults = None
    if control:
        ctrl = ref.numbers(_reference(state, h, w, 6, torch.bfloat16), sound,
                           model, cfg["check"])
        faults = {
            "no_bf": ref.numbers(_reference(state, h, w, 7, bf=False),
                                 sound, model, cfg["check"]),
            "no_rings": ref.numbers(_reference(state, h, w, 8, rings=False),
                                    sound, model, cfg["check"]),
            "half_photons": ref.numbers(_reference(state, h, w, 9, keep=0.5),
                                        sound, model, cfg["check"]),
            "scale_0.9": ref.numbers(prog * np.float32(0.9), sound, model,
                                     cfg["check"])}
    if rec.get("traced"):
        from .. import work

        n_iter, n_sub, _ = ref.plan(cfg["counts_per_pixel"],
                                    cfg["counts_per_iter"], h, w)
        k3 = work.bound_s(4 * work.K3_TAPS ** 2 * h * w, 12 * h * w)
        rec["work"] = {"bound_s": {"k3": n_iter * n_sub * k3 * rec["ccds"]}}
    shutil.rmtree(state.workdir, ignore_errors=True)
    lim = state.cell.limits
    out = {k: (v, lim[k]) for k, v in vals.items()}
    return (out, ctrl, faults) if control else out
