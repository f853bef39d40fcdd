"""Seconds per CCD that the prefetch thread's preparation spends off its
CPU (waiting for the interpreter lock, IO or a core): over the program's
complete `prep` spans (config/runner.prepare_ccd), the mean of wall
seconds less the thread's CPU seconds."""
from portbench import spans


def read(rec):
    tr = spans.store()
    if tr is None:
        return None
    got = [s["host_s"] - s["cpu_s"] for s in tr.spans() if s["name"] == "prep"]
    return sum(got) / len(got) if got else None
