"""ctypes binding of the native instance-catalog tokenizer
`io/native/instcat.cc` (imsim_tpu/catalog/native_instcat.py
counterpart): the default parse path of catalog/instcat._parse_instcat,
whose Python loop (force_python=True) yields the same table.

The tokenizer is built with g++ at first use (io/gxx.py: into
`imsim_tpu_torch/_build/`, named by a hash of its source).  Without g++
the build raises: there is no silent fall back to the Python loop.

includeobj keeps ENCOUNTER ORDER: each file's buffer is split at its
includeobj directives and the included file's objects are parsed in
place of the directive line, as the line-by-line loop reads them.
"""
from __future__ import annotations

import ctypes
import gzip
import os
import threading

import numpy as np

from ..io import gxx

SRC = os.path.join(gxx.NATIVE_DIR, "instcat.cc")
NUMF = 15    # ra dec magnorm redshift g1 g2 mu p0..p3 iav irv gav grv

_lib = None
_lock = threading.Lock()


def _load():
    """The tokenizer's shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = gxx.load(SRC, "_instcat_")
        lib.instcat_parse.restype = ctypes.c_long
        lib.instcat_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
            ctypes.c_long, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_long)]
        _lib = lib
        return lib


def _read_file(filename: str) -> bytes:
    opener = gzip.open if filename.endswith(".gz") else open
    with opener(filename, "rb") as f:
        return f.read()


def _segments(filename: str):
    """Catalog byte buffers in encounter order, recursing into includeobj
    files at their directive lines."""
    if not os.path.isfile(filename):
        raise OSError(f"File not found: {filename}")
    base = os.path.dirname(os.path.abspath(filename))
    data = _read_file(filename)
    pos = 0
    while True:
        j = data.find(b"includeobj", pos)
        # only at a line start
        while j > 0 and data[j - 1:j] != b"\n":
            j = data.find(b"includeobj", j + 1)
        if j < 0:
            break
        eol = data.find(b"\n", j)
        eol = len(data) if eol < 0 else eol
        if j > pos:
            yield data[pos:j]
        sub = data[j:eol].split()[-1].decode()
        yield from _segments(os.path.join(base, sub))
        pos = eol + 1
    if pos < len(data):
        yield data[pos:]


def _parse_segment(data: bytes, flip_g2: bool, skip_invalid: bool):
    from .instcat import FITSIMAGE

    lib = _load()
    cap = max(data.count(b"\nobject"), 16) + (
        1 if data.startswith(b"object") else 0)
    num = np.empty((cap, NUMF), np.float64)
    code = np.empty(cap, np.int32)
    soff = np.empty((cap, 3), np.int64)
    slen = np.empty((cap, 3), np.int64)
    ntot = ctypes.c_long(0)
    n = lib.instcat_parse(
        data, len(data),
        num.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        code.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        soff.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        slen.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        cap, int(flip_g2), int(skip_invalid), ctypes.byref(ntot))
    if n < 0:
        at = -(n + 1)
        line = data[at:data.find(b"\n", at)].decode(errors="replace")
        raise RuntimeError(f"Unknown object type: {line.split()[12]}")
    ids = [data[o:o + ln].decode() for o, ln in zip(soff[:n, 0],
                                                    slen[:n, 0])]
    # SED names repeat (catalogs draw from a small library): decode each
    # distinct byte string once
    uniq: dict = {}
    seds = [uniq.setdefault(bytes(data[o:o + ln]), data[o:o + ln].decode())
            for o, ln in zip(soff[:n, 1], slen[:n, 1])]
    # token 12 is a string payload only for FITS-image objects
    t12 = np.full(n, "", object)
    for i in np.nonzero(code[:n] == FITSIMAGE)[0]:
        o, ln = soff[i, 2], slen[i, 2]
        t12[i] = data[o:o + ln].decode()
    return num[:n], code[:n], (ids, seds, t12), int(ntot.value)


def parse_instcat_native(file_name: str, flip_g2: bool = True,
                         skip_invalid: bool = True):
    """(ObjectTable, ntot) of every object line, through the native
    tokenizer."""
    from .instcat import ObjectTable

    nums, codes, ids, seds, imgs = [], [], [], [], []
    ntot = 0
    for seg in _segments(file_name):
        num, code, strs, nt = _parse_segment(seg, flip_g2, skip_invalid)
        nums.append(num)
        codes.append(code)
        ids += strs[0]
        seds += strs[1]
        imgs.append(strs[2])
        ntot += nt
    num = np.concatenate(nums) if nums else np.zeros((0, NUMF))
    code = np.concatenate(codes) if codes else np.zeros(0, np.int32)
    img = np.concatenate(imgs) if imgs else np.array([], object)
    z = np.zeros(len(code))
    tab = ObjectTable(
        id=np.array(ids, object), ra=num[:, 0], dec=num[:, 1],
        x=z, y=z.copy(), magnorm=num[:, 2], obj_type=code,
        p0=num[:, 7], p1=num[:, 8], p2=num[:, 9], p3=num[:, 10],
        g1=num[:, 4], g2=num[:, 5], mu=num[:, 6],
        sed_name=np.array(seds, object), redshift=num[:, 3],
        int_av=num[:, 11], int_rv=num[:, 12],
        mw_av=num[:, 13], mw_rv=num[:, 14],
        image_file=img)
    return tab, ntot
