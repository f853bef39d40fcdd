"""The traced window's reduction: device busy time as the union of
device operations on every stream, the window's own annotation left
out, idle gaps named by the host operation in progress; and the
control's bfloat16 tally."""
import torch

from portbench import harness
from portbench.reference import compare


def _ev(name, start, end, device, annotation=False):
    return (name, start, end, device, annotation)


def test_busy_is_the_union_and_gaps_are_named():
    ev = [_ev("portbench.window", 0, 100, "CUDA", annotation=True),
          _ev("k_a", 10, 30, "CUDA"), _ev("k_b", 20, 40, "CUDA"),
          _ev("k_a", 70, 80, "CUDA"), _ev("aten::sum", 45, 65, "CPU")]
    r = harness.reduce_trace(ev, 0.0, 100.0)
    assert abs(r["busy_s"] - 40e-6) < 1e-12
    assert abs(r["kernels"]["k_a"] - 30e-6) < 1e-12
    assert [n for n, _ in r["device_ops"]] == ["k_a", "k_b"]
    gaps = dict((round(v * 1e6), n) for n, v in r["idle_gaps"])
    assert gaps[30] == "aten::sum"          # 40-70, host busy at 55
    assert gaps[10] == "host: no torch op"  # 0-10


def test_kineto_events_of_a_profiled_window():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("portbench.window"):
            torch.ones(8).sum()
    ev = harness.kineto_events(prof)
    mark = [e for e in ev if e[0] == "portbench.window"]
    assert mark and mark[0][3] == "CPU" and mark[0][4]
    assert any(e[0] == "aten::sum" and mark[0][1] <= e[1] <= mark[0][2]
               for e in ev)


def test_a_bf16_tally_stalls_where_the_control_says():
    t = torch.zeros(1, dtype=torch.bfloat16)
    for _ in range(300):
        t += 1
    assert float(t) == compare.BF16_TALLY_STALL
