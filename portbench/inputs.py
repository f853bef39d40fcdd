"""A cell's inputs from its seed: the SED library, the raft's objects,
the catalog file the program reads, and the program's config tree (the
imSim template the configuration names, with its overrides)."""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from .reference import expect, generate


@dataclasses.dataclass
class Inputs:
    visit: expect.Visit         # the reference's visit (frozen WCS, SEDs)
    objs: generate.Objects      # as the catalog file holds them
    rows: generate.Objects      # the rows the program culls (components)
    program_cfg: dict           # the program's config tree (load_config's)
    workdir: str


def _box(visit, objs, det, margin):
    ccd = visit.camera[det]
    x, y = visit.wcs(det).radec_to_xy(objs["ra"] * expect.DEG,
                                      objs["dec"] * expect.DEG)
    return ((x >= -margin) & (x <= ccd.bounds.width + margin)
            & (y >= -margin) & (y <= ccd.bounds.height + margin))


def make(cfg: dict, seed: int, workdir: str, only_det: str | None = None,
         overrides: dict | None = None) -> Inputs:
    """Generate the inputs under workdir.  only_det: write only the
    objects over that CCD widened by the config's box margin (the
    catalog lines a one-CCD cell reads)."""
    os.makedirs(workdir, exist_ok=True)
    head = generate.header(cfg, seed)
    sed_dir = os.path.join(workdir, "seds")
    stars, gals, seds = generate.sed_library(sed_dir,
                                             generate.rng_for(seed, 0))
    visit = expect.Visit(cfg, head, seds)
    wcs_by_det = {d: visit.wcs(d) for d in cfg["dets"]}
    rates = generate.sed_rates(seds, (stars, gals), visit.band,
                               visit.airmass)
    objs = generate.draw_objects(cfg, seed, wcs_by_det, visit.camera, rates,
                                 (stars, gals))
    if only_det is not None:
        objs = objs.take(np.nonzero(_box(
            visit, objs, only_det, cfg["objects"]["box_margin_px"]))[0])
    for k in ("z", "int_av", "mw_av"):
        objs[k] = np.round(objs[k], 4 if k == "z" else 3)
    over = dict(cfg["program"])
    over.update(overrides or {})
    if cfg["catalog"] == "instcat":
        path = os.path.join(workdir, "instcat.txt")
        objs = generate.write_instcat(path, head, objs)
        rows = objs
        prog = {"template": cfg["template"],
                "input.instance_catalog.file_name": path,
                "input.instance_catalog.sed_dir": sed_dir}
    else:
        path = os.path.join(workdir, "skycat.parquet")
        objs = generate.write_mapped_parquet(path, objs,
                                             generate.rng_for(seed, 2))
        rows = expect.components(objs)
        meta = {"fieldRA": head["rightascension"],
                "fieldDec": head["declination"],
                "observationStartMJD": head["mjd"],
                "band": generate.BANDS[int(head["filter"])],
                "rawSeeing": head["seeing"], "exptime": head["vistime"],
                "rotTelPos": head["rottelpos"],
                "observationId": head["obshistid"],
                "altitude": head["altitude"], "moonRA": head["moonra"],
                "moonDec": head["moondec"], "moonAlt": head["moonalt"],
                "moonPhase": head["moonphase"], "sunAlt": head["sunalt"],
                "seed": head["seed"]}
        prog = {"template": cfg["template"],
                "input.sky_catalog.file_name": path,
                "input.sky_catalog.sed_dir": sed_dir, "opsim_meta": meta}
    prog.update(over)
    return Inputs(visit=visit, objs=objs, rows=rows, program_cfg=prog,
                  workdir=workdir)
