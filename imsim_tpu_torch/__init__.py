"""imsim_tpu_torch — the PyTorch/CUDA port of imsim_tpu's device side.

The package mirrors `imsim_tpu`'s module layout where a module has a
counterpart.  Plain tensor code is PyTorch; every Pallas kernel of the
JAX package is hand-written CUDA C++ for Hopper (`csrc/`, built at first
use by `ops/_build.py`).  Every kernel wrapper launches its kernel for a
CUDA tensor and takes its plain PyTorch twin for a CPU tensor; the
caller picks the device.

The package never imports JAX.  A CCD's state (camera, WCS, telescope,
optics context, silicon, screen spec, samplers, readout) is built from
its pointing and detector by `convert.build_ccd_state`, on the host;
`convert.load_ccd_state` reads the bench fixture the JAX package
exported.

Entry points: `python -m imsim_tpu_torch user.yaml [key=value ...]`
and `config.runner.run_visit` (a visit from a YAML config to FITS files
on disk), `convert.build_ccd_state`,
`image.photon_pooling.render_ccd_pooled` (the pooled CCD,
through the optics chain or the analytic PSF), `image.ccd_render.
render_ccd` (the unpooled analytic CCD), `image.ccd_render.
add_sky_and_noise`, `image.cosmic_rays.paint_cosmic_rays`,
`electronics.readout.CcdReadout.chain`, and the flats
`image.flat.build_flat` and `build_flat_photons`.
"""
