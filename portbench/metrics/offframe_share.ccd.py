"""The share [%] of the photons handed to the binner that land outside
the frame (which its scatter sends to pixel 0 with flux 0): the
program's counters 100 x `sensor.off_frame` / `sensor.binned`."""
from portbench import spans


def read(rec):
    binned = spans.counter_total("sensor.binned")
    if not binned:
        return None
    return 100.0 * (spans.counter_total("sensor.off_frame") or 0.0) / binned
