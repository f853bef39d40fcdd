"""File-writing seconds per CCD over the window (write_outputs in the
IO pool: config/runner.HOST_TIMERS["io_s"])."""


def read(rec):
    if "host_timers" not in rec or not rec.get("ccds"):
        return None
    return rec["host_timers"]["io_s"] / rec["ccds"]
