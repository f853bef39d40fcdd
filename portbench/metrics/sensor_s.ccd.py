"""Device seconds per CCD of the sensor, summed over the batches: the
program's span `render.sensor` (accumulate_silicon: K3 and the binning
scatter of sensor/simple.accumulate)."""
from portbench import spans


def read(rec):
    return spans.per_ccd(rec, ("render.sensor",))
