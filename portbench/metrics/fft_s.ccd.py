"""Device seconds per CCD of the pooled render's FFT pass: the program's
span `render.fft` (photon_pooling._fft_pass: the bright stars' Fourier
synthesis and the galaxy stamps)."""
from portbench import spans


def read(rec):
    return spans.per_ccd(rec, ("render.fft",))
