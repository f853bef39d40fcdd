"""BENCHMARK.json against the contract's shape, and the harness finding
every cell's and metric's files by name."""
import json
import os
import re

import pytest

from portbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert os.path.isfile(os.path.join(harness.ROOT, BENCH["command"][1]))
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    cell = harness.Cell(w["name"])
    assert w["name"] == f"{w['config']}.{w['traffic']}"
    assert NAME.match(w["name"]) and len(w["why"]) <= 200
    assert cell.chips == 1
    assert cell.driver().setup and cell.driver().window
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))
    assert set(cell.limits) >= {"kept_diff", "pos_px", "flux_rel",
                                "realized_chi2", "centroid_px", "readout_chi2"}


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    cfg = harness.load_json(harness.ROOT, c["file"])
    assert c["file"].startswith("portbench/configs/")
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    for k in c["reduced"]:
        assert NAME.match(k) and k in cfg
    assert c["source"].startswith("https://")


def test_metrics_names_units_and_layers():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    seen = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        moved = next(e for e in BENCH["end_to_end"]
                     if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
