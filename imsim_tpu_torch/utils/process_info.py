"""Per-stage wall time and peak RSS, and the `process_info` extra
output (imsim_tpu/utils/process_info.py counterpart, the same rows): a
context manager logging a stage (the CLI's --profile), and a
per-detector row collector dumped as the process-info catalog at the end
of a visit.
"""
from __future__ import annotations

import contextlib
import os
import resource
import time

# per-stage rows of stage_profile
_rows: list[dict] = []


def rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


@contextlib.contextmanager
def stage_profile(name: str, logger=None, enabled: bool = True):
    t0 = time.time()
    cpu0 = time.process_time()
    try:
        yield
    finally:
        if enabled:
            row = dict(stage=name, pid=os.getpid(),
                       wall_s=time.time() - t0,
                       cpu_s=time.process_time() - cpu0,
                       maxrss_mb=rss_mb())
            _rows.append(row)
            if logger:
                logger.info("%s: wall %.2fs cpu %.2fs maxrss %.0f MB",
                            name, row["wall_s"], row["cpu_s"],
                            row["maxrss_mb"])


def rows():
    return list(_rows)


def write_catalog(path: str):
    """The stage rows as a catalog."""
    with open(path, "w") as f:
        f.write("# stage pid wall_s cpu_s maxrss_mb\n")
        for r in _rows:
            f.write(f"{r['stage']!r} {r['pid']} {r['wall_s']:.3f} "
                    f"{r['cpu_s']:.3f} {r['maxrss_mb']:.1f}\n")


# per-detector process rows (the reference's per-stamp catalog columns
# pid rss uss user_time unix_time; the unit of record is the detector)
_det_rows: list[dict] = []


def record_det_row(det_name: str, logger=None) -> None:
    try:
        import psutil

        proc = psutil.Process(os.getpid())
        mem = proc.memory_full_info()
        rss, uss = mem.rss / 1024 ** 3, mem.uss / 1024 ** 3
        user_time = proc.cpu_times().user
    except ImportError:             # without psutil: getrusage
        rss = rss_mb() / 1024.0
        uss = rss
        user_time = time.process_time()
    row = dict(det_name=det_name, pid=os.getpid(), rss=rss, uss=uss,
               user_time=user_time, unix_time=time.time())
    _det_rows.append(row)
    if logger:
        logger.info("det %s, pid %d, RSS %.2f GB, USS %.2f GB, "
                    "user_time %.2f, unix_time %.1f", det_name,
                    row["pid"], rss, uss, user_time, row["unix_time"])


def write_det_catalog(path: str) -> None:
    """The process_info extra-output catalog (one row per detector)."""
    with open(path, "w") as f:
        f.write("# det_name pid rss uss user_time unix_time\n")
        for r in _det_rows:
            f.write(f"{r['det_name']} {r['pid']} {r['rss']:.4f} "
                    f"{r['uss']:.4f} {r['user_time']:.2f} "
                    f"{r['unix_time']:.1f}\n")
    _det_rows.clear()
