"""Cells cut to a size the CPU renders in seconds: three CCDs of the
raft, a few hundred objects a CCD and no bright stars, no silicon, small
photon batches.  The harness, drivers and reference run unchanged."""
from __future__ import annotations

import copy

from portbench import harness


def cell(name: str) -> harness.Cell:
    """The cell `name` (<config>.<mix>) cut small; a pair that
    BENCHMARK.json does not hold yet takes the limits of a cell with the
    same mix."""
    bench = harness.benchmark()
    if name not in {w["name"] for w in bench["workloads"]}:
        config, mix = name.split(".")
        like = next(w["name"] for w in bench["workloads"]
                    if w["traffic"] == mix)
        bench["workloads"].append(dict(name=name, config=config,
                                       traffic=mix, chips=1, why="test"))
        c = harness.Cell(name, bench, limits=harness.load_json(
            harness.HERE, "limits", like + ".json"))
    else:
        c = harness.Cell(name, bench)
    cfg = copy.deepcopy(c.config)
    cfg["objects"].update(per_ccd_box=400, bright_per_ccd=0,
                          photons_per_px=2e5 / (4296 * 4204))
    cfg["dets"] = ["R22_S11", "R22_S12", "R22_S10"]
    cfg["program"]["output.only_dets"] = cfg["dets"]
    cfg["program"].update({"image.sensor.type": "none",
                           "image.batch_size": 100000})
    cfg["render"]["batch_size"] = 100000
    cfg["check"]["centroid"]["min_flux"] = 300
    c.config = cfg
    return c
