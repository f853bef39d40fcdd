"""Frozen copies of the port's plain host code (numpy and CPU torch):
the WCS chain (astrometry, the optical design and its ray trace, the
TAN-SIP fit), the camera geometry and electronics constants, the SEDs,
dust and the synthetic Rubin bandpass.  Copied when the benchmark was
defined, so that a later change to the program does not move the
yardstick; the relative imports were rewritten to point here, the FEA
terms and the throughput-file readers were left out."""
