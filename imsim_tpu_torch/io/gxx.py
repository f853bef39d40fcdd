"""Host C++ codecs built at first use: `g++ -O3 -shared -fPIC` of one
source under io/native/ into `imsim_tpu_torch/_build/`, named by a hash
of the source, so an edited source never loads a stale library.  Without
g++ the build raises: no codec has a Python fallback."""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(_PKG, "io", "native")
BUILD_DIR = os.path.join(_PKG, "_build")

_lock = threading.Lock()
_libs: dict = {}


def library_path(src: str, prefix: str) -> str:
    """The built library's path for source `src`."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"{prefix}{digest}.so")


def load(src: str, prefix: str) -> ctypes.CDLL:
    """The shared library of `src`, built on first use (once a process)."""
    with _lock:
        so = library_path(src, prefix)
        if so in _libs:
            return _libs[so]
        if not os.path.isfile(so):
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError(f"g++ not found: {os.path.basename(src)} "
                                   f"cannot be built")
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run([gxx, "-O3", "-shared", "-fPIC", src, "-o", tmp],
                           check=True)
            os.replace(tmp, so)
        _libs[so] = ctypes.CDLL(so)
        return _libs[so]
