"""Device seconds per CCD of the per-photon rows, summed over the
batches: the program's span `render.rows` (batch_from_obj_map and
materialize_rows_T: slot_deltas' scatter, its transpose and K1)."""
from portbench import spans


def read(rec):
    return spans.per_ccd(rec, ("render.rows",))
