"""A parquet reader without pandas or pyarrow (the card's machine has
neither): the files pyarrow writes by default (`DataFrame.to_parquet`,
`pyarrow.parquet.write_table`), column by column into numpy arrays with
the values `pandas.read_parquet(path)[name].to_numpy()` gives under
pandas 3.

What it reads:

  * the Thrift compact-protocol footer (FileMetaData, SchemaElement,
    RowGroup, ColumnChunk) and page headers;
  * DATA_PAGE (v1) and DICTIONARY_PAGE pages, each decoded by its own
    encoding (pyarrow falls back from dictionary to PLAIN inside one
    chunk when the dictionary grows too large);
  * PLAIN values of BOOLEAN (bit-packed, LSB first), INT32, INT64, FLOAT,
    DOUBLE and BYTE_ARRAY (4-byte length prefixes; the STRING logical
    type as `str`), RLE_DICTIONARY / PLAIN_DICTIONARY indices, and the
    RLE / bit-packed hybrid of definition and repetition levels (the
    hybrid in io/native/snappy.cc);
  * REQUIRED and OPTIONAL columns, the three-level LIST
    (`name.list.element`) with empty and null lists and null elements,
    several row groups and several pages a chunk;
  * UNCOMPRESSED, SNAPPY (io/native/snappy.cc, built with g++ at first
    use) and GZIP (zlib) pages.

The values, as pandas 3 gives them: ints as their width's dtype, or
float64 with NaN where a column has nulls; floats with NaN for nulls;
bools, or an object array with None for nulls; strings as an object
array of `str` with NaN for nulls (bytes and None without the STRING
type); lists as an object array of numpy arrays (their elements as a
column of that type), None for a null list.  The index columns pandas
writes (`__index_level_N__`) are left out.

ZSTD, LZ4, BROTLI and LZO pages, DATA_PAGE_V2, INT96 and fixed-length
byte arrays, DECIMAL and the time types, maps and nested structs each
raise a ValueError that names the feature: nothing falls back.
"""
from __future__ import annotations

import ctypes
import os
import re
import struct
import threading
import zlib

import numpy as np

from . import gxx

SRC = os.path.join(gxx.NATIVE_DIR, "snappy.cc")

MAGIC = b"PAR1"
# parquet.thrift enums
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FIXED = range(8)
REQUIRED, OPTIONAL, REPEATED = range(3)
PLAIN, PLAIN_DICTIONARY, RLE_DICTIONARY = 0, 2, 8
DATA_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = 0, 2, 3
CODECS = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO",
          4: "BROTLI", 5: "LZ4", 6: "ZSTD", 7: "LZ4_RAW"}
ENCODINGS = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
             5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY",
             7: "DELTA_BYTE_ARRAY", 8: "RLE_DICTIONARY",
             9: "BYTE_STREAM_SPLIT"}
_PLAIN_DTYPE = {INT32: "<i4", INT64: "<i8", FLOAT: "<f4", DOUBLE: "<f8"}
# ConvertedType values this reader refuses, by name
_REFUSED_CONVERTED = {1: "MAP", 2: "MAP_KEY_VALUE", 5: "DECIMAL", 6: "DATE",
                      7: "TIME_MILLIS", 8: "TIME_MICROS",
                      9: "TIMESTAMP_MILLIS", 10: "TIMESTAMP_MICROS",
                      21: "INTERVAL"}
# LogicalType union members this reader refuses, by field id
_REFUSED_LOGICAL = {2: "MAP", 5: "DECIMAL", 6: "DATE", 7: "TIME",
                    8: "TIMESTAMP", 14: "UUID", 15: "FLOAT16"}
_INDEX_COLUMN = re.compile(r"__index_level_\d+__")


# ---- the native library --------------------------------------------------

_lib = None
_lock = threading.Lock()


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = gxx.load(SRC, "_snappy_")
        u8 = ctypes.POINTER(ctypes.c_uint8)
        lib.snappy_uncompressed_length.restype = ctypes.c_long
        lib.snappy_uncompressed_length.argtypes = [u8, ctypes.c_long]
        lib.snappy_decompress.restype = ctypes.c_long
        lib.snappy_decompress.argtypes = [u8, ctypes.c_long, u8,
                                          ctypes.c_long]
        lib.rle_hybrid_decode.restype = ctypes.c_long
        lib.rle_hybrid_decode.argtypes = [
            u8, ctypes.c_long, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_long]
        _lib = lib
        return lib


def _u8(buf: np.ndarray):
    return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def snappy_decompress(data: bytes) -> bytes:
    """One snappy raw block; ValueError on a corrupt stream."""
    lib = _load()
    src = np.frombuffer(data, np.uint8)
    n = lib.snappy_uncompressed_length(_u8(src), src.size)
    if n < 0:
        raise ValueError("corrupt snappy stream: bad length header")
    out = np.empty(max(n, 1), np.uint8)
    got = lib.snappy_decompress(_u8(src), src.size, _u8(out), n)
    if got != n:
        raise ValueError(f"corrupt snappy stream (code {got})")
    return out[:n].tobytes()


def rle_hybrid(buf: bytes, pos: int, end: int, bit_width: int,
               count: int) -> np.ndarray:
    """`count` values of the RLE / bit-packed hybrid in buf[pos:end] as
    int64."""
    out = np.zeros(count, np.uint32)
    if count == 0 or bit_width == 0:
        return out.astype(np.int64)
    src = np.frombuffer(buf, np.uint8, end - pos, pos)
    got = _load().rle_hybrid_decode(
        _u8(src), src.size, bit_width,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), count)
    if got < 0:
        raise ValueError("corrupt RLE / bit-packed run")
    return out.astype(np.int64)


# ---- Thrift compact protocol -------------------------------------------

class _Thrift:
    """A Thrift compact-protocol reader over `buf` from `pos`: structs as
    {field id: value}, lists as Python lists."""

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf, self.pos = buf, pos

    def byte(self) -> int:
        if self.pos >= len(self.buf):
            raise ValueError("truncated parquet metadata")
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        v = shift = 0
        while True:
            b = self.byte()
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
            if shift > 63:
                raise ValueError("bad varint in parquet metadata")

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def value(self, t: int):
        if t in (1, 2):                 # a bool field: the type is its value
            return t == 1
        if t == 3:
            b = self.byte()
            return b - 256 if b > 127 else b
        if t in (4, 5, 6):
            return self.zigzag()
        if t == 7:
            if self.pos + 8 > len(self.buf):
                raise ValueError("truncated parquet metadata")
            v = struct.unpack_from("<d", self.buf, self.pos)[0]
            self.pos += 8
            return v
        if t == 8:
            n = self.varint()
            if self.pos + n > len(self.buf):
                raise ValueError("truncated parquet metadata")
            v = bytes(self.buf[self.pos:self.pos + n])
            self.pos += n
            return v
        if t in (9, 10):
            h = self.byte()
            n, et = h >> 4, h & 0x0F
            if n == 15:
                n = self.varint()
            if et in (1, 2):            # bools in a list: one byte each
                return [self.byte() == 1 for _ in range(n)]
            return [self.value(et) for _ in range(n)]
        if t == 11:
            n = self.varint()
            if n == 0:
                return {}
            kv = self.byte()
            return {self.value(kv >> 4): self.value(kv & 0x0F)
                    for _ in range(n)}
        if t == 12:
            return self.struct()
        raise ValueError(f"unknown Thrift type {t} in parquet metadata")

    def struct(self) -> dict:
        out, fid = {}, 0
        while True:
            h = self.byte()
            if h == 0:
                return out
            delta, t = h >> 4, h & 0x0F
            fid = fid + delta if delta else self.zigzag()
            out[fid] = self.value(t)


# ---- the schema ------------------------------------------------------------

class _Leaf:
    """One column chunk's place in the schema: its top-level column, its
    physical type, levels and how its values read."""

    def __init__(self, top, path, elem, max_def, max_rep, is_list,
                 list_def):
        self.top, self.path = top, path
        self.ptype = elem.get(1)
        self.max_def, self.max_rep = max_def, max_rep
        self.is_list, self.list_def = is_list, list_def
        logical = elem.get(10) or {}
        # UTF8 / ENUM / JSON, as converted or logical types
        self.string = elem.get(6) in (0, 4, 19) or bool(
            {1, 4, 12} & set(logical))
        self.int_type = None
        if 10 in logical:               # INTEGER(bitWidth, isSigned)
            bits, signed = logical[10].get(1, 8), logical[10].get(2, True)
            self.int_type = np.dtype(f"{'i' if signed else 'u'}{bits // 8}")
        elif elem.get(6) in range(11, 19):   # UINT_8 .. INT_64
            code = elem.get(6)
            self.int_type = np.dtype(
                ("u1", "u2", "u4", "u8", "i1", "i2", "i4", "i8")[code - 11])
        _refuse_types(elem, path)
        if self.ptype in (INT96, FIXED):
            what = "INT96" if self.ptype == INT96 else "FIXED_LEN_BYTE_ARRAY"
            raise ValueError(f"parquet column {'.'.join(path)}: {what} "
                             f"values are not supported")


def _refuse_types(elem, path):
    name = ".".join(path)
    if elem.get(6) in _REFUSED_CONVERTED:
        raise ValueError(f"parquet column {name}: "
                         f"{_REFUSED_CONVERTED[elem[6]]} is not supported")
    for fid, what in _REFUSED_LOGICAL.items():
        if fid in (elem.get(10) or {}):
            raise ValueError(f"parquet column {name}: {what} is not "
                             f"supported")


def _schema_leaves(schema: list) -> list:
    """The leaves in column-chunk order, from the flattened schema."""
    leaves, i = [], 1
    n_top = schema[0].get(5, 0)
    for _ in range(n_top):
        elem = schema[i]
        name = elem[4].decode()
        rep = elem.get(3, REQUIRED)
        if rep == REPEATED:
            raise ValueError(f"parquet column {name}: a repeated field "
                             f"outside a LIST is not supported")
        nch = elem.get(5)
        if not nch:
            leaves.append(_Leaf(name, (name,), elem,
                                int(rep == OPTIONAL), 0, False, 0))
            i += 1
            continue
        logical = elem.get(10) or {}
        if elem.get(6) == 1 or 2 in logical:
            raise ValueError(f"parquet column {name}: maps are not "
                             f"supported")
        if not (elem.get(6) == 3 or 3 in logical):
            raise ValueError(f"parquet column {name}: nested structs are "
                             f"not supported")
        mid = schema[i + 1]
        if nch != 1 or mid.get(3) != REPEATED or mid.get(5) != 1:
            raise ValueError(f"parquet column {name}: only the three-level "
                             f"LIST is supported")
        leaf = schema[i + 2]
        if leaf.get(5):
            raise ValueError(f"parquet column {name}: lists of nested "
                             f"types are not supported")
        list_def = int(rep == OPTIONAL)
        max_def = list_def + 1 + int(leaf.get(3, REQUIRED) == OPTIONAL)
        leaves.append(_Leaf(name, (name, mid[4].decode(), leaf[4].decode()),
                            leaf, max_def, 1, True, list_def))
        i += 3
    return leaves


# ---- pages -----------------------------------------------------------------

def _decompress(codec: int, data: bytes, size: int) -> bytes:
    if codec == 0:
        return data
    if codec == 1:
        out = snappy_decompress(data)
    elif codec == 2:
        out = zlib.decompress(data, 47)
    else:
        raise ValueError(f"parquet codec {CODECS.get(codec, codec)} is not "
                         f"supported (UNCOMPRESSED, SNAPPY and GZIP are)")
    if len(out) != size:
        raise ValueError(f"parquet page decompressed to {len(out)} bytes, "
                         f"its header says {size}")
    return out


def _plain(ptype: int, buf: bytes, pos: int, end: int, n: int, leaf):
    """n PLAIN values from buf[pos:end]."""
    if ptype in _PLAIN_DTYPE:
        size = np.dtype(_PLAIN_DTYPE[ptype]).itemsize * n
        if pos + size > end:
            raise ValueError("parquet page shorter than its values")
        return np.frombuffer(buf, _PLAIN_DTYPE[ptype], n, pos).copy()
    if ptype == BOOLEAN:
        nb = (n + 7) // 8
        if pos + nb > end:
            raise ValueError("parquet page shorter than its values")
        bits = np.unpackbits(np.frombuffer(buf, np.uint8, nb, pos),
                             bitorder="little")
        return bits[:n].astype(bool)
    if ptype == BYTE_ARRAY:
        out = np.empty(n, object)
        mv = memoryview(buf)
        for k in range(n):
            if pos + 4 > end:
                raise ValueError("parquet page shorter than its values")
            m = int.from_bytes(mv[pos:pos + 4], "little")
            pos += 4
            if pos + m > end:
                raise ValueError("parquet page shorter than its values")
            b = bytes(mv[pos:pos + m])
            out[k] = b.decode("utf-8") if leaf.string else b
            pos += m
        return out
    raise ValueError(f"parquet physical type {ptype} is not supported")


def _levels(buf, pos, end, max_level, n):
    """(levels (n,), next position) of a v1 page's 4-byte-length-prefixed
    hybrid run."""
    if max_level == 0:
        return np.zeros(n, np.int64), pos
    if pos + 4 > end:
        raise ValueError("parquet page shorter than its levels")
    size = int.from_bytes(buf[pos:pos + 4], "little")
    pos += 4
    if pos + size > end:
        raise ValueError("parquet page shorter than its levels")
    lv = rle_hybrid(buf, pos, pos + size, int(max_level).bit_length(), n)
    return lv, pos + size


def _read_chunk(f, meta: dict, leaf: _Leaf):
    """(definition levels, repetition levels, non-null values) of one
    column chunk, page by page."""
    codec = meta.get(4, 0)
    if codec not in (0, 1, 2):
        raise ValueError(f"parquet codec {CODECS.get(codec, codec)} is not "
                         f"supported (UNCOMPRESSED, SNAPPY and GZIP are)")
    start = min(o for o in (meta.get(11), meta[9]) if o)
    total = meta[7]
    f.seek(start)
    raw = f.read(total)
    if len(raw) != total:
        raise ValueError("parquet file shorter than its column chunk")
    n_values = meta[5]
    pos, seen = 0, 0
    dictionary = None
    defs, reps, vals = [], [], []
    while seen < n_values:
        th = _Thrift(raw, pos)
        head = th.struct()
        pos = th.pos
        csize, usize = head[3], head[2]
        if pos + csize > len(raw):
            raise ValueError("parquet page past its column chunk")
        ptype = head[1]
        if ptype == DATA_PAGE_V2:
            raise ValueError("parquet DATA_PAGE_V2 pages are not supported")
        if ptype not in (DATA_PAGE, DICTIONARY_PAGE):
            raise ValueError(f"parquet page type {ptype} is not supported")
        page = _decompress(codec, raw[pos:pos + csize], usize)
        pos += csize
        if ptype == DICTIONARY_PAGE:
            dh = head[7]
            if dh.get(2, PLAIN) not in (PLAIN, PLAIN_DICTIONARY):
                raise ValueError("parquet dictionary page encoding "
                                 f"{ENCODINGS.get(dh.get(2))} is not "
                                 f"supported")
            dictionary = _plain(leaf.ptype, page, 0, len(page), dh[1], leaf)
            continue
        dh = head[5]
        n = dh[1]
        p, end = 0, len(page)
        rep, p = _levels(page, p, end, leaf.max_rep, n)
        dfn, p = _levels(page, p, end, leaf.max_def, n)
        n_present = int(np.count_nonzero(dfn == leaf.max_def))
        enc = dh[2]
        if enc == PLAIN:
            v = _plain(leaf.ptype, page, p, end, n_present, leaf)
        elif enc in (PLAIN_DICTIONARY, RLE_DICTIONARY):
            if dictionary is None:
                raise ValueError("parquet dictionary-encoded page without "
                                 "a dictionary")
            if n_present and p >= end:
                raise ValueError("parquet page shorter than its values")
            width = page[p] if n_present else 0
            idx = rle_hybrid(page, p + 1, end, width, n_present)
            if n_present and (idx.max() >= len(dictionary)):
                raise ValueError("parquet dictionary index out of range")
            v = dictionary[idx]
        else:
            raise ValueError(f"parquet encoding {ENCODINGS.get(enc, enc)} "
                             f"is not supported")
        defs.append(dfn)
        reps.append(rep)
        vals.append(v)
        seen += n
    cat = (lambda xs, dt: np.concatenate(xs) if xs else np.zeros(0, dt))
    return (cat(defs, np.int64), cat(reps, np.int64),
            cat(vals, object if leaf.ptype == BYTE_ARRAY else None))


def _fill(values, present, leaf):
    """A column of len(present) rows from the values of its present
    rows, nulls as pandas 3 reads them."""
    n = len(present)
    if leaf.int_type is not None and values.dtype != object:
        values = values.astype(leaf.int_type)
    if present.all():
        return values
    if leaf.ptype == BYTE_ARRAY:
        out = np.full(n, np.nan if leaf.string else None, object)
    elif leaf.ptype == BOOLEAN:
        out = np.full(n, None, object)
        values = values.astype(object)
    elif leaf.ptype == FLOAT:
        out = np.full(n, np.nan, np.float32)
    else:
        out = np.full(n, np.nan, np.float64)
    out[present] = values
    return out


def _empty_values(leaf):
    if leaf.ptype == BYTE_ARRAY:
        return np.zeros(0, object)
    if leaf.ptype == BOOLEAN:
        return np.zeros(0, bool)
    return np.zeros(0, leaf.int_type or _PLAIN_DTYPE[leaf.ptype])


def _assemble(defs, reps, vals, leaf):
    """The column's rows from its levels and non-null values."""
    if vals.size == 0:
        vals = _empty_values(leaf)
    if not leaf.is_list:
        return _fill(vals, defs == leaf.max_def, leaf)
    starts = np.flatnonzero(reps == 0)
    exists = defs >= leaf.list_def + 1
    elems = _fill(vals, defs[exists] == leaf.max_def, leaf)
    counts = np.add.reduceat(exists.astype(np.int64), starts) \
        if len(starts) else np.zeros(0, np.int64)
    out = np.empty(len(starts), object)
    ends = np.cumsum(counts)
    for r, (e, c) in enumerate(zip(ends, counts)):
        out[r] = elems[e - c:e]
    if leaf.list_def:
        for r in np.flatnonzero(defs[starts] < leaf.list_def):
            out[r] = None
    return out


# ---- files -------------------------------------------------------------

def read_metadata(path: str) -> dict:
    """The file's FileMetaData as a Thrift field-id dict."""
    with open(path, "rb") as f:
        f.seek(0, 2)
        size = f.tell()
        if size < 12:
            raise ValueError(f"{path}: not a parquet file")
        f.seek(0)
        head = f.read(4)
        f.seek(size - 8)
        tail = f.read(8)
        if head != MAGIC or tail[4:] != MAGIC:
            raise ValueError(f"{path}: not a parquet file (encrypted "
                             f"footers are not supported)")
        n = int.from_bytes(tail[:4], "little")
        if n > size - 12:
            raise ValueError(f"{path}: footer length {n} past the file")
        f.seek(size - 8 - n)
        return _Thrift(f.read(n)).struct()


def read_parquet(path: str, columns=None) -> dict:
    """{name: numpy column} of the file's columns (all, or those named in
    `columns`, in the file's order), with pandas 3's values."""
    fm = read_metadata(path)
    leaves = _schema_leaves(fm[2])
    names = [lf.top for lf in leaves if not _INDEX_COLUMN.fullmatch(lf.top)]
    if columns is not None:
        missing = [c for c in columns if c not in names]
        if missing:
            raise KeyError(f"{path}: no column {missing}")
        want = set(columns)
    else:
        want = set(names)
    parts = {lf.top: [] for lf in leaves if lf.top in want}
    with open(path, "rb") as f:
        for rg in fm.get(4, []):
            chunks = rg.get(1, [])
            if len(chunks) != len(leaves):
                raise ValueError(f"{path}: a row group has {len(chunks)} "
                                 f"columns, the schema {len(leaves)}")
            for leaf, chunk in zip(leaves, chunks):
                if leaf.top not in want:
                    continue
                if chunk.get(1):
                    raise ValueError(f"{path}: column chunks in other files "
                                     f"are not supported")
                parts[leaf.top].append(_assemble(
                    *_read_chunk(f, chunk[3], leaf), leaf))
    out = {}
    for leaf in leaves:
        if leaf.top not in want:
            continue
        cols = parts[leaf.top]
        if not cols:
            out[leaf.top] = (np.zeros(0, object) if leaf.is_list
                             else _empty_values(leaf))
            continue
        if not leaf.is_list and any(c.dtype != cols[0].dtype for c in cols):
            # a row group with nulls widens the whole column as pandas does
            if any(c.dtype == object for c in cols):
                dt = object
            elif leaf.ptype in (INT32, INT64):
                dt = np.float64
            else:
                dt = np.result_type(*(c.dtype for c in cols))
            cols = [c.astype(dt) for c in cols]
        out[leaf.top] = np.concatenate(cols)
    return out
