"""Device seconds per flat of the program's span `flat.draw`, summed over
the sub-batches: the photons' positions and wavelengths from the inverse
CDF (image/flat._flat_photon_iteration)."""
from portbench import spans


def read(rec):
    return spans.per_ccd(rec, ("flat.draw",))
