"""Device seconds per flat of the program's span `sensor.bin`, summed over
the sub-batches: the binning scatter, a sorted index_put_ into the frame
and its tail slots (sensor/simple.accumulate)."""
from portbench import spans


def read(rec):
    return spans.per_ccd(rec, ("sensor.bin",))
