"""CLI: `python -m imsim_tpu_torch user.yaml [key.path=value ...]`
(imsim_tpu/__main__.py counterpart): run a visit config with dotted-key
overrides on the card, or on `--device cpu`.  Flags: -v / -q logging,
--profile (per-detector wall time and peak RSS), --trace PATH (the
run's spans and counters, utils.trace, as Chrome-trace JSON), --visits
(opsim visit ids, `a:b` or `a,b,...`, rendered in turn), -n / -j (split
the visit's detectors over N jobs; this is job J).

Several ranks: `torchrun --nproc-per-node N -m imsim_tpu_torch user.yaml
output.mesh="{ccd: C, phot: M}"` (C x M <= N); with WORLD_SIZE > 1 the
CLI initializes the process group from torchrun's environment (NCCL
when each rank has a card, gloo on `--device cpu` or when ranks share a
card) and destroys it at the end.
"""
import argparse
import logging
import os
import sys
import time


def main(argv=None, on_result=None) -> int:
    """Run the CLI on `argv`; `on_result`, if given, is called with each
    CCD's result dict as the visit yields it (run_visit_iter's)."""
    p = argparse.ArgumentParser(
        prog="imsim_tpu_torch",
        description="Rubin/LSST image simulation, PyTorch and CUDA")
    p.add_argument("config", help="visit config YAML")
    p.add_argument("overrides", nargs="*",
                   help="dotted-key overrides: image.nbatch=4 ...")
    p.add_argument("-v", "--verbose", action="count", default=1)
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="log per-detector wall time and peak RSS")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="record the run's spans and counters and write "
                        "them to PATH (.rank<r> after it with several "
                        "ranks) as Chrome-trace JSON (timestamps on "
                        "torch.profiler's clock)")
    p.add_argument("--visits", default=None,
                   help="opsim visit ids to render in turn: a,b,... or "
                        "a:b (b excluded); each sets "
                        "input.opsim_data.visit")
    p.add_argument("-n", "--njobs", type=int, default=1,
                   help="split the visit's detectors over N jobs (with -j)")
    p.add_argument("-j", "--job", type=int, default=1,
                   help="which job (1..njobs) this run is")
    p.add_argument("--device", default="cuda",
                   help="torch device of the render (default cuda)")
    args = p.parse_args(argv)

    level = logging.WARNING if args.quiet else (
        logging.DEBUG if args.verbose > 1 else logging.INFO)
    logging.basicConfig(level=level, stream=sys.stdout,
                        format="%(asctime)s %(levelname)s %(message)s")
    logger = logging.getLogger("imsim_tpu_torch")

    group = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if group:
        import torch.distributed as dist

        from .parallel.mesh import init_group

        if dist.is_initialized():
            group = False      # the caller's group: the caller ends it
        else:
            init_group(args.device)
    if args.trace:
        from .utils import trace

        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            args.trace += f".rank{os.environ.get('RANK', '0')}"
        trace.reset()
        trace.enable()
    try:
        _run(args, logger, on_result)
    finally:
        if group:
            dist.destroy_process_group()
        if args.trace:
            trace.disable()
            trace.write_chrome_trace(args.trace)
    return 0


def _run(args, logger, on_result):
    """The visits of `args` in turn."""
    from .config.runner import run_visit_iter
    from .utils.process_info import stage_profile

    if args.visits:
        if ":" in args.visits:
            a, b = args.visits.split(":")
            visit_ids = list(range(int(a), int(b)))
        else:
            visit_ids = [int(v) for v in args.visits.split(",")]
    else:
        visit_ids = [None]

    t0 = time.time()
    for visit in visit_ids:
        overrides = list(args.overrides)
        if visit is not None:
            overrides.append(f"input.opsim_data.visit={visit}")
        if args.njobs > 1:
            overrides += [f"output.njobs={args.njobs}",
                          f"output.job={args.job}"]
        tv = time.time()
        with stage_profile("visit", logger, enabled=args.profile):
            for result in run_visit_iter(args.config, overrides,
                                         device=args.device, logger=logger):
                # no reference is kept: a result is released once its
                # (possibly pending) write is done; it is not changed
                # here, since the IO pool may still hold it
                if on_result is not None:
                    on_result(result)
                if args.profile:
                    logger.info("det %s done at +%.1fs",
                                result["det_name"], time.time() - tv)
        if visit is not None:
            logger.info("visit %s complete in %.1fs", visit,
                        time.time() - tv)
    logger.info("%d visit(s) complete in %.1fs", len(visit_ids),
                time.time() - t0)


if __name__ == "__main__":
    sys.exit(main())
