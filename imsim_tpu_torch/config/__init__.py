"""The runner's per-CCD path (imsim_tpu/config counterpart)."""
