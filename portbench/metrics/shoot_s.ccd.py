"""Device seconds per CCD of the photon shooting, summed over the
batches: the program's span `render.shoot` (render.shoot_full: the
intrinsic profiles, K2 and the screens; the realized tally)."""
from portbench import spans


def read(rec):
    return spans.per_ccd(rec, ("render.shoot",))
