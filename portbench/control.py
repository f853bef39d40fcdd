"""The control of `correct`: the reference put in the program's place,
computed in bfloat16 (the precision below the float32 the render, the
sky and the readout state), has to come out as not correct.

    python3 portbench/control.py --workload <cell> --seconds <s>
        --seeds <n> [<n> ...]

For each seed, one run of the cell with a short window, then, on the
same CCDs, the program's numbers and the control's beside each limit,
one JSON line a seed: {"seed", "program": {number: value},
"control": {number: value}, "faults": {fault: {number: value}},
"limits": {number: limit}, "control_fails": [numbers the control
exceeds]}.  The benchmark's own runs never run it.
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


def readings(cell, seed: int, seconds: float, device: str) -> dict:
    driver = cell.driver()
    state = driver.setup(cell, seed, device)
    rec = driver.window(state, seconds, False, time.perf_counter())
    prog, ctrl, faults = driver.check(state, rec, control=True)
    lim = {k: v[1] for k, v in prog.items()}
    return dict(seed=seed, program={k: v[0] for k, v in prog.items()},
                control=ctrl, faults=faults, limits=lim,
                control_fails=sorted(k for k, v in ctrl.items()
                                     if not v <= lim[k]))


def main(argv=None, device: str = "cuda", cell=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from portbench import harness

    cell = cell or harness.Cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.seconds, device)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
