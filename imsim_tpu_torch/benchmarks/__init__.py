"""The port's on-chip probes, one module per JAX probe in benchmarks/:

  probe_rows     row-materialization formulations (K4 lane scan, K1)
  probe_pallas   P1-P5: copy, window copy, one-tap window, 1- and
                 2-output 9 x 9 stencils
  probe_pallas2  P6, P7: the stencil formulations ka..kh, ki, kh2, kh3

Each has `main(device, ...)` at the probe's own sizes by default and a
command line (`python3 -m imsim_tpu_torch.benchmarks.<probe> --help`).
Nothing is allocated at import time.
"""
