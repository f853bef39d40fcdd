"""Run one cell of the port's benchmark once, on this machine's card.

    python3 portbench/run.py --workload <config>.<mix> --seed <n>
        --seconds <s> --trace <0|1>

Set-up (imports, the kernel build, the inputs from the seed, the
visit's context, preparation and warm-up) is timed as setup_s; then
the cell's driver runs the window for --seconds; then the reference
judges what the window produced.  With --trace 0 the result carries the
cell's end-to-end metrics, with --trace 1 (the window under
torch.profiler) its per-layer metrics.  The last line of standard
output is one JSON object; each compared number and its limit are also
the last lines of standard error.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ["USE_FLAX"] = "0"


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device_check: bool = True, cell=None) -> int:
    """device_check=False (the tests) skips the look for a card and runs
    the cell on the CPU; `cell` replaces the one BENCHMARK.json names."""
    args = parse(argv)
    from portbench import harness

    cell = cell or harness.Cell(args.workload)
    import torch

    if device_check:
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark runs only on the card",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2
    import imsim_tpu_torch  # noqa: F401  (fails where the port is absent)

    driver = cell.driver()
    state = driver.setup(cell, args.seed,
                         "cuda" if device_check else "cpu")
    rec = driver.window(state, args.seconds, bool(args.trace), T_START)
    device = harness.device_info(cell.chips) if device_check else dict(
        platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    checks = driver.check(state, rec)
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            v = harness.metric_reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
    else:
        metrics = {m["name"]: {"value": rec[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    ok = harness.passed(checks)
    out = dict(correct=ok, attempted=rec["attempted"], failed=rec["failed"],
               metrics=metrics, device=device)
    if args.trace:
        out["breakdown"] = dict(device_ops=rec["device_ops"],
                                idle_gaps=rec["idle_gaps"])
    out["checks"] = harness.checks_line(checks)
    if rec.get("detail"):
        print(f"detail {json.dumps(rec['detail'])}", file=sys.stderr)
    for k, (v, lim) in checks.items():
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
