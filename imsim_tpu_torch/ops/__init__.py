"""The port's hand-written Hopper kernels, one module each, with their
plain PyTorch twins beside them:

  scanrows.scan_slot_prefix  K1  slot-layout ordinal prefix sum
  raychain.field_to_sensor   K2  fused DCR + diffraction + ray trace
  stencil.stencil_pair       K3  brighter-fatter 2-output stencil

A wrapper launches its kernel for a CUDA tensor (or raises) and takes
the plain twin for a CPU tensor.  `_build` compiles `csrc/*.cu` with
nvcc at first use and counts launches.
"""
