"""Device seconds per flat of the program's span `sensor.redistribute`,
summed over the sub-batches: the continuity update with the folded tree-
ring field (sensor/silicon.bf_redistribute)."""
from portbench import spans


def read(rec):
    return spans.per_ccd(rec, ("sensor.redistribute",))
