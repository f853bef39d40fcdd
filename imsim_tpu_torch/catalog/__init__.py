"""Visit and object inputs on the host: instance catalogs and their
headers, opsim databases, SEDs and bandpasses (copies of
imsim_tpu.catalog's numpy code)."""
