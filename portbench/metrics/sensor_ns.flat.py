"""Device nanoseconds per photon of the silicon model in the flat: the
program's spans `flat.sensor` (sensor/silicon.accumulate_silicon) over
its counter `flat.photons` (the photons drawn)."""
from portbench import spans


def read(rec):
    s = spans.per_ccd(rec, ("flat.sensor",))
    n = spans.counter_total("flat.photons")
    if not s or not n:
        return None
    return 1e9 * s * rec["ccds"] / n
