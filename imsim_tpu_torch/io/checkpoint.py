"""Crash-safe checkpointing (imsim_tpu/io/checkpoint.py counterpart, the
same protocol and API): named pickled blobs in one file per (visit,
band, detector), written with the backup/rename protocol, so a crash at
any instant leaves a recoverable file: write `<file>_new`, move the
current file to `<file>_bak`, rename `_new` to the current name, remove
`_bak`; on open, recover from whichever of (`_new`, `_bak`, current)
survived.

The container is a numpy `.npz` with one uint8 array per name (the JAX
package's is HDF5, which the card's machine lacks), so the two packages
cannot read each other's checkpoint files.  Payloads are host numpy: a
renderer pulls its device arrays before `save` and uploads a restored
state to its device.
"""
from __future__ import annotations

import os
import pickle

import numpy as np


class Checkpointer:
    def __init__(self, file_name: str, dir=None, init=True, logger=None):
        if dir:
            file_name = os.path.join(dir, file_name)
        self.file_name = file_name
        self.logger = logger
        if init:
            self._recover()

    def _recover(self):
        cur = self.file_name
        new = cur + "_new"
        bak = cur + "_bak"
        if os.path.exists(cur):
            # an intact current file wins: save() writes _new while the
            # current file exists, so a crash in that write leaves a
            # truncated _new beside a good current file
            if os.path.exists(new):
                os.remove(new)
            if os.path.exists(bak):
                os.remove(bak)
        elif os.path.exists(new):
            # a crash between the two renames: the current file was
            # already moved to _bak, and _new is complete
            os.replace(new, cur)
            if os.path.exists(bak):
                os.remove(bak)
        elif os.path.exists(bak):
            os.replace(bak, cur)
        os.makedirs(os.path.dirname(os.path.abspath(cur)), exist_ok=True)

    def _blobs(self) -> dict:
        if not os.path.exists(self.file_name):
            return {}
        with np.load(self.file_name, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    def save(self, name: str, data) -> None:
        """Pickle `data` under `name`, keeping every other name."""
        cur = self.file_name
        new = cur + "_new"
        bak = cur + "_bak"
        blobs = {k: v for k, v in self._blobs().items() if k != name}
        blobs[name] = np.frombuffer(pickle.dumps(data, protocol=4), np.uint8)
        # np.savez appends .npz to a name without it: write through a
        # file object so _new keeps its name
        with open(new, "wb") as f:
            np.savez(f, **blobs)
        if os.path.exists(cur):
            os.replace(cur, bak)
        os.replace(new, cur)
        if os.path.exists(bak):
            os.remove(bak)
        if self.logger:
            self.logger.debug("checkpoint save %s (%d bytes)", name,
                              blobs[name].nbytes)

    def load(self, name: str):
        """The stored object, or None if absent."""
        blob = self._blobs().get(name)
        return None if blob is None else pickle.loads(blob.tobytes())

    def names(self):
        return list(self._blobs())
