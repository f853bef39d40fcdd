"""Device seconds per flat of the program's span `sensor.field`, summed
over the sub-batches: the brighter-fatter field of the charge so far, K3
(sensor/silicon.displacement_field)."""
from portbench import spans


def read(rec):
    return spans.per_ccd(rec, ("sensor.field",))
