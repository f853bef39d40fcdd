"""Host seconds per window CCD that the render thread waits for the
next CCD's preparation: the program's span `visit.wait_prep`
(config/runner.visit_loop, around the prefetch future's result)."""
from portbench import spans


def read(rec):
    return spans.per_ccd(rec, ("visit.wait_prep",), "host_s")
