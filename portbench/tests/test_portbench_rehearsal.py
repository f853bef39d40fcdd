"""Small rehearsals of every mix on the CPU, the look for a card
skipped: the last line has the contract's keys and the reference agrees
with the program; the control (the reference in bfloat16 in the
program's place) and a run with the timed path broken underneath come
out as not correct (so does one whose charge is scaled by 0.9).  The
card's own run of the cells is the benchmark itself (BENCHMARK.json)."""
import json

import numpy as np
import pytest
import torch

from portbench import control, run
from portbench.tests import tiny

SEED = 3_000_000_017          # past 32 signed bits, as the driver's are
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def _last_line(capsys, name, trace=0, seed=SEED):
    rc = run.main(["--workload", name, "--seed", str(seed), "--seconds",
                   "0.5", "--trace", str(trace)], device_check=False,
                  cell=tiny.cell(name))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name,trace", [("comcam_instcat.ccd", 0),
                                        ("comcam_skycat.visit", 1),
                                        ("comcam_instcat.visit", 0)])
def test_rehearsal_prints_the_contract_line(capsys, name, trace):
    out = _last_line(capsys, name, trace)
    assert set(out) == KEYS | ({"breakdown"} if trace else set())
    assert list(out)[-1] == "checks"
    cell = tiny.cell(name)
    want = cell.per_layer if trace else cell.end_to_end
    got = set(out["metrics"])
    assert got <= {m["name"] for m in want}
    if not trace:
        assert got == {m["name"] for m in want}
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["correct"], out["checks"]
    # the frozen host code gives the program's numbers
    assert out["checks"]["kept_diff"]["value"] == 0
    assert out["checks"]["pos_px"]["value"] < 1e-4
    assert out["checks"]["flux_rel"]["value"] < 1e-4


@pytest.mark.parametrize("name", ["comcam_instcat.ccd",
                                  "comcam_skycat.visit"])
def test_control_comes_out_not_correct(name):
    r = control.readings(tiny.cell(name), SEED, 0.5, "cpu")
    assert not [k for k, v in r["program"].items() if v > r["limits"][k]]
    assert {"pos_px", "centroid_px", "readout_chi2", "sky_chi2"} <= \
        set(r["control_fails"]), r
    # a charge and frame scaled by 0.9 fail every amount
    scaled = r["faults"]["scale_0.9"]
    assert {"charge_rel", "sky_chi2"} <= set(scaled)
    assert all(v > r["limits"][k] for k, v in scaled.items()), r


def _zero_render(monkeypatch):
    from imsim_tpu_torch.config import runner

    real = runner.render_ccd_pooled

    def unchanged(*a, **k):
        image, modes, realized = real(*a, **k)
        return torch.zeros_like(image), modes, realized

    monkeypatch.setattr(runner, "render_ccd_pooled", unchanged)


def _half_batch(monkeypatch):
    from imsim_tpu_torch.image import photon_pooling as PP

    real = PP.batch_from_obj_map

    def half(*a, **k):
        obj_idx, weight = real(*a, **k)
        weight = weight.clone()
        weight[len(weight) // 2:] = 0
        return obj_idx, weight

    monkeypatch.setattr(PP, "batch_from_obj_map", half)


def _scaled_charge(monkeypatch):
    from imsim_tpu_torch.config import runner

    real = runner.render_ccd_pooled

    def scaled(*a, **k):
        image, modes, realized = real(*a, **k)
        return image * 0.9, modes, realized

    monkeypatch.setattr(runner, "render_ccd_pooled", scaled)


def _altered_answer(monkeypatch):
    from imsim_tpu_torch.config import runner

    real = runner.prepare_ccd

    def altered(*a, **k):
        prep = real(*a, **k)
        prep.host.pix_x[np.argmin(prep.host.pix_x)] += 3.0
        return prep

    monkeypatch.setattr(runner, "prepare_ccd", altered)


@pytest.mark.parametrize("fault", [_zero_render, _half_batch,
                                   _scaled_charge, _altered_answer],
                         ids=["state_unchanged", "half_batch",
                              "charge_scaled", "answer_altered"])
@pytest.mark.parametrize("name", ["comcam_instcat.ccd",
                                  "comcam_instcat.visit"])
def test_broken_timed_path_is_not_correct(capsys, monkeypatch, fault, name):
    fault(monkeypatch)
    out = _last_line(capsys, name)
    assert not out["correct"], out["checks"]
