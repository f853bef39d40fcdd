"""The port's hand-written Hopper kernels, one module each, with their
plain PyTorch twins beside them:

  scanrows.scan_slot_prefix  K1  slot-layout ordinal prefix sum
  raychain.field_to_sensor   K2  fused DCR + diffraction + ray trace
  stencil.stencil_pair       K3  brighter-fatter 2-output stencil
  binning.bin_scatter        K5  the binning scatter, atomic adds
  scanrows.scan_lanes        K4  (C, N) lane prefix sum
  probes.probe_copy2 ...     P1-P7  the stencil probes' kernels:
      probe_copy2 (P1), probe_window (P2), probe_window_tap (P3),
      probe_stencil1 (P4), probe_stencil2 (P5), probe_mk (P6),
      probe_mk2 (P7)

K1-K3 and K5 run in the render; K4 and P1-P7 run in the on-chip probes
(`imsim_tpu_torch.benchmarks`: `python3 -m
imsim_tpu_torch.benchmarks.probe_rows`, `...probe_pallas`,
`...probe_pallas2` on the card; add `--device cpu` and small sizes to
run the plain twins here).  chip_smoke.py drives both.

A wrapper launches its kernel for a CUDA tensor (or raises) and takes
the plain twin for a CPU tensor.  `_build` compiles `csrc/*.cu` with
nvcc at first use and counts launches.
"""
