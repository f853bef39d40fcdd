"""Device seconds per flat of the program's span `sensor.displace`, summed
over the sub-batches: the silicon's draws, conversion depth and
diffusion (sensor/silicon.apply_silicon_displacements)."""
from portbench import spans


def read(rec):
    return spans.per_ccd(rec, ("sensor.displace",))
