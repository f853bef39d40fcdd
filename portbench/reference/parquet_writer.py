"""A minimal parquet writer (a copy of the port's skycat workload
writer): one row group, one uncompressed page a column, OPTIONAL
columns with definition levels (bit-packed runs), PLAIN values except
the dictionary columns (RLE_DICTIONARY, as skyCatalogs writes
`sed_filepath`), and the three-level LIST."""
from __future__ import annotations

import numpy as np


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag(v: int) -> bytes:
    return _varint((v << 1) ^ (v >> 63))


def _thrift(fields: list) -> bytes:
    """A Thrift compact struct from [(field id, kind, value)], ids rising;
    kind 'i32' / 'i64' / 'bin' / 'struct' (value: a field list) /
    'list' (value: (element kind, items))."""
    out, last = bytearray(), 0
    code = {"i32": 5, "i64": 6, "bin": 8, "list": 9, "struct": 12}
    for fid, kind, value in fields:
        delta = fid - last
        out.append((delta << 4) | code[kind] if 0 < delta < 16 else
                   code[kind])
        if not 0 < delta < 16:
            out += _zigzag(fid)
        out += _thrift_value(kind, value)
        last = fid
    out.append(0)
    return bytes(out)


def _thrift_value(kind, value) -> bytes:
    if kind in ("i32", "i64"):
        return _zigzag(int(value))
    if kind == "bin":
        b = value.encode() if isinstance(value, str) else bytes(value)
        return _varint(len(b)) + b
    if kind == "struct":
        return _thrift(value)
    ekind, items = value
    code = {"i32": 5, "i64": 6, "bin": 8, "struct": 12}[ekind]
    head = bytes([(len(items) << 4) | code]) if len(items) < 15 else \
        bytes([0xF0 | code]) + _varint(len(items))
    return head + b"".join(_thrift_value(ekind, v) for v in items)


def _bitpacked(values: np.ndarray, width: int) -> bytes:
    """One bit-packed run of the RLE / bit-packed hybrid (values padded
    with zeros to a multiple of 8)."""
    n = len(values)
    groups = (n + 7) // 8
    v = np.zeros(groups * 8, np.uint64)
    v[:n] = values
    bits = ((v[:, None] >> np.arange(width, dtype=np.uint64)) & 1)
    packed = np.packbits(bits.astype(np.uint8).ravel(), bitorder="little")
    return _varint((groups << 1) | 1) + packed.tobytes()


def _levels(values: np.ndarray, max_level: int) -> bytes:
    body = _bitpacked(values, int(max_level).bit_length())
    return len(body).to_bytes(4, "little") + body


def _plain(kind: str, values) -> bytes:
    if kind == "f64":
        return np.asarray(values, "<f8").tobytes()
    if kind == "i64":
        return np.asarray(values, "<i8").tobytes()
    return b"".join(len(b).to_bytes(4, "little") + b
                    for b in (str(s).encode() for s in values))


_PTYPE = {"f64": 5, "i64": 2, "str": 6}


def write_parquet(path: str, columns: dict, dictionary=()) -> None:
    """`columns`: {name: values}, float64 (NaN written as null), int64,
    an object array of str (None as null) or an object array of float
    arrays (a list column; None as a null list).  Names in `dictionary`
    are RLE_DICTIONARY-encoded."""
    n_rows = len(next(iter(columns.values())))
    body = bytearray(b"PAR1")
    schema = [[(4, "bin", "schema"), (5, "i32", len(columns))]]
    chunks = []
    for name, vals in columns.items():
        vals = np.asarray(vals)
        is_list = vals.dtype == object and any(
            isinstance(v, np.ndarray) for v in vals)
        if is_list:
            kind = "f64"
            null_row = np.array([v is None for v in vals])
            lens = np.array([0 if v is None else len(v) for v in vals])
            # one level entry per element, or one for an empty / null list
            n_ent = np.maximum(lens, 1)
            rep = np.ones(int(n_ent.sum()), np.int64)
            rep[np.concatenate([[0], np.cumsum(n_ent)[:-1]])] = 0
            dfn = np.repeat(np.where(null_row, 0, np.where(lens == 0, 1, 3)),
                            n_ent)
            present = np.concatenate([np.asarray(v, float) for v in vals
                                      if v is not None and len(v)] or
                                     [np.zeros(0)])
            max_def, max_rep = 3, 1
            levels = _levels(rep, max_rep) + _levels(dfn, max_def)
            n_values = len(dfn)
            path_in_schema = [name, "list", "element"]
            schema += [
                [(3, "i32", 1), (4, "bin", name), (5, "i32", 1),
                 (6, "i32", 3), (10, "struct", [(3, "struct", [])])],
                [(3, "i32", 2), (4, "bin", "list"), (5, "i32", 1)],
                [(1, "i32", 5), (3, "i32", 1), (4, "bin", "element")]]
        else:
            kind = ("f64" if vals.dtype.kind == "f" else
                    "i64" if vals.dtype.kind in "iu" else "str")
            null = (np.isnan(vals) if kind == "f64" else
                    np.array([v is None for v in vals]) if kind == "str"
                    else np.zeros(n_rows, bool))
            present = vals[~null]
            levels = _levels((~null).astype(np.int64), 1)
            n_values = n_rows
            path_in_schema = [name]
            elem = [(1, "i32", _PTYPE[kind]), (3, "i32", 1),
                    (4, "bin", name)]
            if kind == "str":
                elem += [(6, "i32", 0), (10, "struct", [(1, "struct", [])])]
            schema.append(elem)
        start = len(body)
        dict_offset = None
        if name in dictionary:
            uniq, idx = np.unique(present.astype(str), return_inverse=True)
            page = _plain(kind, uniq)
            body += _thrift([(1, "i32", 2), (2, "i32", len(page)),
                             (3, "i32", len(page)),
                             (7, "struct", [(1, "i32", len(uniq)),
                                            (2, "i32", 0)])])
            body += page
            dict_offset = start
            width = max(1, int(len(uniq) - 1).bit_length())
            values = bytes([width]) + _bitpacked(idx, width)
            encoding = 8
        else:
            values = _plain(kind, present)
            encoding = 0
        data_offset = len(body)
        page = levels + values
        body += _thrift([(1, "i32", 0), (2, "i32", len(page)),
                         (3, "i32", len(page)),
                         (5, "struct", [(1, "i32", n_values),
                                        (2, "i32", encoding),
                                        (3, "i32", 3), (4, "i32", 3)])])
        body += page
        size = len(body) - start
        meta = [(1, "i32", _PTYPE[kind]),
                (2, "list", ("i32", [3, encoding] + ([0] if dict_offset
                                                      is not None else []))),
                (3, "list", ("bin", path_in_schema)), (4, "i32", 0),
                (5, "i64", n_values), (6, "i64", size), (7, "i64", size),
                (9, "i64", data_offset)]
        if dict_offset is not None:
            meta.append((11, "i64", dict_offset))
        chunks.append([(2, "i64", start), (3, "struct", meta)])
    total = len(body) - 4
    footer = _thrift([
        (1, "i32", 1), (2, "list", ("struct", schema)),
        (3, "i64", n_rows),
        (4, "list", ("struct", [[(1, "list", ("struct", chunks)),
                                 (2, "i64", total), (3, "i64", n_rows)]])),
        (6, "bin", "portbench")])
    body += footer + len(footer).to_bytes(4, "little") + b"PAR1"
    with open(path, "wb") as f:
        f.write(bytes(body))
