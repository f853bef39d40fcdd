"""Device seconds per CCD of the stages after the render: the program's
spans `ccd.sky`, `ccd.cosmic_rays` and `ccd.readout` (render_one_ccd's
steps: sky and noise, cosmic rays, the readout to raw amps)."""
from portbench import spans


def read(rec):
    return spans.per_ccd(rec, ("ccd.sky", "ccd.cosmic_rays", "ccd.readout"))
