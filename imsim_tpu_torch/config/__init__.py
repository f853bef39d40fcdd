"""The YAML config layer and the visit driver (imsim_tpu/config
counterpart): yaml_subset, interpreter, registry, runner."""
