"""RICE_1 tile compression (imsim_tpu/io/rice.py counterpart): a ctypes
binding of the host C++ codec `io/native/rice.cc` and the FITS tiled-
image HDU (de)serialization, one tile per image row.

The codec is built with g++ at first use (io/gxx.py: into
`imsim_tpu_torch/_build/`, named by a hash of its source); without g++
the build raises: there is no numpy fallback.  The encoder's bytes are
the JAX package's codec's bytes for the same int32 rows.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from . import gxx

SRC = os.path.join(gxx.NATIVE_DIR, "rice.cc")

_lib = None
_lock = threading.Lock()


def library_path() -> str:
    return gxx.library_path(SRC, "_rice_")


def _load():
    """The codec's shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = gxx.load(SRC, "_rice_")
        lib.rice_encode_i32.restype = ctypes.c_long
        lib.rice_encode_i32.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.rice_decode_i32.restype = ctypes.c_long
        lib.rice_decode_i32.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_long]
        lib.instcat_scan.restype = ctypes.c_long
        lib.instcat_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_long),
            ctypes.c_long]
        _lib = lib
        return lib


def rice_encode(a: np.ndarray) -> bytes:
    """Compress a 1-D int32 array."""
    lib = _load()
    a = np.ascontiguousarray(a, np.int32)
    out = np.empty(16 + 5 * a.size, np.uint8)
    n = lib.rice_encode_i32(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), a.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out[:n].tobytes()


def rice_decode(buf: bytes, n: int) -> np.ndarray:
    lib = _load()
    a = np.empty(n, np.int32)
    raw = np.frombuffer(buf, np.uint8)
    r = lib.rice_decode_i32(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), raw.size,
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n)
    if r != n:
        raise ValueError("RICE decode failed")
    return a


def instcat_object_offsets(data: bytes) -> np.ndarray:
    """The byte offsets of the lines of a catalog buffer that start with
    'object' (the native scan), int64."""
    lib = _load()
    max_lines = max(data.count(b"\n"), 16)
    out = np.empty(max_lines, np.int64)
    n = lib.instcat_scan(data, len(data),
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                         max_lines)
    return out[:n]


def serialize_rice_hdu(hdu) -> bytes:
    """An int32 image HDU as a RICE_1 tile-compressed BINTABLE (one tile
    per row), by the FITS Tiled Image Compression convention."""
    from .fits import _card, _header_bytes

    data = np.ascontiguousarray(hdu.data, np.int32)
    ny, nx = data.shape
    tiles = [rice_encode(data[y]) for y in range(ny)]
    heap = b"".join(tiles)
    # row entries: (nelem, offset) int32 pairs (1PB descriptor)
    desc = np.zeros((ny, 2), ">i4")
    off = 0
    for y, t in enumerate(tiles):
        desc[y, 0] = len(t)
        desc[y, 1] = off
        off += len(t)

    cards = [
        _card("XTENSION", "BINTABLE", "binary table extension"),
        _card("BITPIX", 8),
        _card("NAXIS", 2),
        _card("NAXIS1", 8),          # one descriptor pair per row
        _card("NAXIS2", ny),
        _card("PCOUNT", len(heap)),
        _card("GCOUNT", 1),
        _card("TFIELDS", 1),
        _card("TTYPE1", "COMPRESSED_DATA"),
        _card("TFORM1", "1PB(%d)" % max(len(t) for t in tiles)),
        _card("ZIMAGE", True),
        _card("ZCMPTYPE", "RICE_1"),
        _card("ZBITPIX", 32),
        _card("ZNAXIS", 2),
        _card("ZNAXIS1", nx),
        _card("ZNAXIS2", ny),
        _card("ZTILE1", nx),
        _card("ZTILE2", 1),
        _card("ZNAME1", "BLOCKSIZE"),
        _card("ZVAL1", 32),
        _card("ZNAME2", "BYTEPIX"),
        _card("ZVAL2", 4),
    ]
    if hdu.name:
        cards.append(_card("EXTNAME", hdu.name))
    for k, v in hdu.header.items():
        cards.append(_card(k, v))
    payload = desc.tobytes() + heap
    pad = (-len(payload)) % 2880
    return _header_bytes(cards) + payload + b"\0" * pad


def deserialize_rice_hdu(cards: dict, raw_table: bytes) -> np.ndarray:
    """The int32 image of a RICE_1 tile-compressed BINTABLE."""
    nx = cards["ZNAXIS1"]
    ny = cards["ZNAXIS2"]
    table_bytes = cards["NAXIS1"] * cards["NAXIS2"]
    desc = np.frombuffer(raw_table[:table_bytes], ">i4").reshape(ny, 2)
    heap = raw_table[table_bytes:]
    img = np.empty((ny, nx), np.int32)
    for y in range(ny):
        nb, off = int(desc[y, 0]), int(desc[y, 1])
        img[y] = rice_decode(heap[off:off + nb], nx)
    return img
