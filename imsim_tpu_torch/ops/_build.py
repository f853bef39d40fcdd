"""Build and load the port's CUDA kernels, and count their launches.

All `csrc/*.cu` files compile with nvcc into one shared library with a
plain C interface (no PyTorch headers: seconds, not minutes), loaded
with ctypes.  The build runs at first use into `imsim_tpu_torch/_build/`
(listed in .gitignore), named by a hash of the sources so an edited
kernel never loads a stale library.  Without nvcc the build raises: a
CUDA tensor never falls back to a kernel's plain twin.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# launches per kernel wrapper: bumped where the wrapper launches its
# kernel, and nowhere else
LAUNCHES = {"scan_slot_prefix": 0, "field_to_sensor": 0, "stencil_pair": 0}

_LIB = None
BUILD_INFO = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def sources() -> list:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> str:
    """Compile the kernels if the library for the current sources is
    missing; returns its path.  BUILD_INFO records the seconds taken and
    nvcc's -Xptxas -v report (registers, shared memory, spills)."""
    srcs = sources()
    h = hashlib.sha256()
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(ARCH_FLAGS).encode())
    lib = os.path.join(BUILD_DIR, f"libimsim_kernels_{h.hexdigest()[:12]}.so")
    if os.path.isfile(lib):
        BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO.setdefault("ptxas", "(cached build)")
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp,
           *[s for s in srcs if s.endswith(".cu")]]
    t0 = time.time()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, lib)
    BUILD_INFO["seconds"] = time.time() - t0
    BUILD_INFO["ptxas"] = (res.stdout + res.stderr).strip()
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        lib.imsim_error_string.argtypes = [ctypes.c_int]
        lib.imsim_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if status != 0:
        msg = library().imsim_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status}: {msg}")


def stream_ptr(t) -> ctypes.c_void_p:
    """PyTorch's current stream on t's device, for a launch."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require(t, name: str, shape=None) -> None:
    """Validate a tensor handed to a kernel: CUDA, float32, contiguous,
    and (optionally) of a given shape."""
    import torch

    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
