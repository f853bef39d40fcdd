"""The port's on-chip probes, one module per JAX probe in benchmarks/:

  probe_rows     row-materialization formulations (K4 lane scan, K1)
  probe_pallas   P1-P5: copy, window copy, one-tap window, 1- and
                 2-output 9 x 9 stencils
  probe_pallas2  P6, P7: the stencil formulations ka..kh, ki, kh2, kh3

and the port's own measurements:

  profile_render  warm s/CCD of the render and its spans' seconds
  sass_stats      static SASS instruction mix of the built kernels
  chain_random    K2 against its twin on uniformly random photons

`_util` holds the timer, the bounds and yardsticks, and the bench
workload.  Each other module has a `main(...)` at its own sizes by
default and a command line
(`python3 -m imsim_tpu_torch.benchmarks.<name> --help`).
Nothing is allocated at import time.
"""
