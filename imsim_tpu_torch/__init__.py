"""imsim_tpu_torch — the PyTorch/CUDA port of imsim_tpu's pooled
full-physics CCD render.

The package mirrors `imsim_tpu`'s module layout where a module has a
counterpart.  Plain tensor code is PyTorch; the three Pallas kernels on
the pooled path are hand-written CUDA C++ for Hopper (`csrc/`, built at
first use by `ops/_build.py`).  Every kernel wrapper launches its kernel
for a CUDA tensor and takes its plain PyTorch twin for a CPU tensor; the
caller picks the device.

The package never imports JAX.  Per-CCD state built by the JAX package
(telescope, optics context, silicon, screens, samplers) crosses as numpy
data through `convert.py`.

Entry point: `imsim_tpu_torch.image.photon_pooling.render_ccd_pooled`.
"""
