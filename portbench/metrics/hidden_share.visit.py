"""The share [%] of the window CCDs' steps (preparation, the render
thread's steps, readout, file writes) that the prefetch thread and the
IO pool hide: 1 - window wall / the steps' sum."""


def read(rec):
    if not rec.get("steps_s"):
        return None
    return 100.0 * (1.0 - rec["window_s"] / rec["steps_s"])
