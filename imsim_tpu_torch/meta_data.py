"""Data-directory resolution (imsim_tpu/meta_data.py counterpart, the
same lookup): a bare file name in a config resolves against the
directory named by ``IMSIM_TPU_DATA_DIR`` (or the reference-compatible
``IMSIM_DATA_DIR``); absolute and existing relative paths pass through.
The port's own tables live in `imsim_tpu_torch/data/` and are found
without it.
"""
from __future__ import annotations

import os

ENV_VARS = ("IMSIM_TPU_DATA_DIR", "IMSIM_DATA_DIR")


def data_dir() -> str | None:
    for var in ENV_VARS:
        d = os.environ.get(var)
        if d:
            return d
    return None


def resolve_data_path(name):
    """Resolve a config file name: absolute paths and existing relative
    paths pass through; otherwise bare names are looked up under the
    data dir (matching the reference's fallback order,
    imsim/vignetting.py:25-31)."""
    if not name or not isinstance(name, (str, os.PathLike)):
        return name
    name = str(name)
    if os.path.isabs(name) or os.path.exists(name):
        return name
    d = data_dir()
    if d:
        cand = os.path.join(d, name)
        if os.path.exists(cand):
            return cand
    return name
