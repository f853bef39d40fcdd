"""A small column table in place of the pandas DataFrame the JAX
package's catalog readers use (the card's machine has no pandas): named
numpy columns holding the values `DataFrame[name].to_numpy()` gives
under pandas 3, row selection by a boolean mask, `concat` with
`ignore_index` semantics, and `read_table`, which picks the reader by the
file's suffix as the JAX package does: `.parquet` / `.pq` through
io/parquet.py, `.ecsv` as CSV with '#' comments, anything else as CSV.

CSV follows pandas' type inference on the files catalogs hold: int64
where every field is an integer, float64 where every field is a number
(empty and NA fields as NaN; integers with NA become float64), bool for
True / False fields, otherwise an object array of `str` with NaN for NA
fields; quoting as Python's csv module reads it.
"""
from __future__ import annotations

import csv
import re

import numpy as np

from ..io.parquet import read_parquet

# pandas' default NA strings (pandas.read_csv na_values)
NA_STRINGS = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))
TRUE_STRINGS = frozenset(("True", "TRUE", "true"))
FALSE_STRINGS = frozenset(("False", "FALSE", "false"))
_INT = re.compile(r"\s*[+-]?\d+\s*")
_FLOAT = re.compile(r"\s*[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?"
                    r"|(?i:inf|infinity))\s*")


def isna(values: np.ndarray) -> np.ndarray:
    """pandas' isna of a column: NaN in float columns, None and NaN in
    object columns."""
    values = np.asarray(values)
    if values.dtype.kind == "f":
        return np.isnan(values)
    if values.dtype == object:
        return np.array([v is None or (isinstance(v, float) and v != v)
                         for v in values], bool)
    return np.zeros(len(values), bool)


class Table:
    """Named columns of equal length (numpy arrays)."""

    def __init__(self, columns: dict | None = None):
        self._cols = {}
        for k, v in (columns or {}).items():
            self[k] = v

    @property
    def columns(self) -> list:
        return list(self._cols)

    def __len__(self) -> int:
        return len(next(iter(self._cols.values()))) if self._cols else 0

    def __contains__(self, name) -> bool:
        return name in self._cols

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._cols[key]
        mask = np.asarray(key)
        if mask.dtype != bool or mask.shape != (len(self),):
            raise TypeError("rows are selected by a boolean mask of the "
                            "table's length")
        return Table({k: v[mask] for k, v in self._cols.items()})

    def __setitem__(self, name: str, values):
        if np.ndim(values) == 0:
            n = len(self)
            values = np.full(n, values, object if isinstance(values, str)
                             else None)
        values = np.asarray(values)
        if values.dtype.kind in "US":
            values = values.astype(object)
        if self._cols and len(values) != len(self):
            raise ValueError(f"column {name!r} has {len(values)} rows, the "
                             f"table {len(self)}")
        self._cols[name] = values

    def row(self, i: int) -> dict:
        """Row i as `dict(DataFrame.iloc[i])` gives it: where every column
        is numeric (not bool) one common dtype for all, else each value
        as its column holds it."""
        dts = [v.dtype for v in self._cols.values()]
        if dts and all(d.kind in "iuf" for d in dts):
            common = np.result_type(*dts)
            return {k: v[i:i + 1].astype(common)[0]
                    for k, v in self._cols.items()}
        return {k: v[i] for k, v in self._cols.items()}


def _concat_column(parts: list) -> np.ndarray:
    """One column over tables, None where a table lacks it (NaN rows)."""
    present = [p for p, _ in parts if p is not None]
    kinds = {p.dtype.kind for p in present}
    missing = any(p is None for p, _ in parts)
    if "O" in kinds or (missing and "b" in kinds) or (
            "b" in kinds and len(kinds) > 1):
        dt = object
    elif missing:
        dt = np.result_type(np.float64, *(p.dtype for p in present))
    else:
        dt = np.result_type(*(p.dtype for p in present))
    return np.concatenate([
        (np.full(n, np.nan, dt) if p is None else p.astype(dt, copy=False))
        for p, n in parts]) if parts else np.zeros(0)


def concat(tables: list) -> Table:
    """pandas.concat(tables, ignore_index=True): the columns in order of
    first appearance, NaN where a table lacks one, dtypes widened as
    pandas widens them (int with NaN to float64, anything with strings
    to object)."""
    names = []
    for t in tables:
        names += [c for c in t.columns if c not in names]
    return Table({c: _concat_column([(t[c] if c in t else None, len(t))
                                     for t in tables]) for c in names})


_POW10 = [float(f"1e{k}") for k in range(309)]


def _digits(s: str, i: int) -> int:
    while i < len(s) and "0" <= s[i] <= "9":
        i += 1
    return i


def precise_xstrtod(text: str) -> float:
    """A decimal number as pandas' C parser reads it (tokenizer.c
    precise_xstrtod, read_csv's default): at most 17 significant digits
    accumulated in double arithmetic, then one multiplication or division
    by a power of ten; not always the correctly rounded float(text).  The
    caller has matched `text` against _FLOAT's decimal forms."""
    s = text.strip()
    i, neg = 0, False
    if s[i] in "+-":
        neg, i = s[i] == "-", i + 1
    number, exponent, nd = 0.0, 0, 0
    while i < len(s) and "0" <= s[i] <= "9":
        if nd < 17:
            number = number * 10.0 + (ord(s[i]) - 48)
            nd += 1
        else:
            exponent += 1
        i += 1
    if i < len(s) and s[i] == ".":
        i += 1
        ndec = 0
        while nd < 17 and i < len(s) and "0" <= s[i] <= "9":
            number = number * 10.0 + (ord(s[i]) - 48)
            nd, ndec, i = nd + 1, ndec + 1, i + 1
        i = _digits(s, i)
        exponent -= ndec
    if neg:
        number = -number
    if i < len(s) and s[i] in "eE":
        i += 1
        eneg = False
        if i < len(s) and s[i] in "+-":
            eneg, i = s[i] == "-", i + 1
        n = ne = 0
        while ne < 17 and i < len(s) and "0" <= s[i] <= "9":
            n, ne, i = n * 10 + (ord(s[i]) - 48), ne + 1, i + 1
        exponent += -n if eneg else n
    if exponent > 308:
        return float("-inf") if neg else float("inf")
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        if exponent < -616:
            return -0.0 if neg else 0.0
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _to_float(text: str) -> float:
    t = text.strip()
    if t.lstrip("+-").lower() in ("inf", "infinity"):
        return float("-inf") if t.startswith("-") else float("inf")
    return precise_xstrtod(t)


def _infer(fields: list) -> np.ndarray:
    """One CSV column's values, typed as pandas.read_csv types them."""
    na = np.array([f in NA_STRINGS for f in fields], bool)
    vals = [f for f, m in zip(fields, na) if not m]
    if not vals:
        return np.full(len(fields), np.nan)
    if all(_INT.fullmatch(v) for v in vals):
        ints = np.array([int(v) for v in vals], np.int64) \
            if all(abs(int(v)) < 2**63 for v in vals) else None
        if ints is not None:
            if not na.any():
                return ints
            out = np.full(len(fields), np.nan)
            out[~na] = ints
            return out
    if all(_FLOAT.fullmatch(v) for v in vals):
        out = np.full(len(fields), np.nan)
        out[~na] = [_to_float(v) for v in vals]
        return out
    if all(v in TRUE_STRINGS or v in FALSE_STRINGS for v in vals):
        b = np.array([v in TRUE_STRINGS for v in vals])
        if not na.any():
            return b
        out = np.full(len(fields), np.nan, object)
        out[~na] = b.astype(object)
        return out
    out = np.full(len(fields), np.nan, object)
    out[~na] = vals
    return out


def read_csv(path: str, comment: str | None = None,
             columns=None) -> Table:
    """A CSV file with a header line; `comment`: a character after which
    a line is ignored (lines left empty are skipped, as blank lines
    are)."""
    with open(path, newline="") as f:
        lines = f.read().splitlines()
    if comment:
        lines = [ln.split(comment, 1)[0] for ln in lines]
    rows = list(csv.reader(ln for ln in lines if ln.strip()))
    if not rows:
        raise ValueError(f"{path}: no columns")
    header, body = rows[0], rows[1:]
    width = len(header)
    for k, r in enumerate(body):
        if len(r) > width:
            raise ValueError(f"{path}: line {k + 2} has {len(r)} fields, "
                             f"the header {width}")
    cols = {}
    for j, name in enumerate(header):
        if columns is not None and name not in columns:
            continue
        cols[name] = _infer([r[j] if j < len(r) else "" for r in body])
    return Table(cols)


def read_table(path: str, columns=None) -> Table:
    """A catalog table by the file's suffix (parquet, ECSV or CSV)."""
    path = str(path)
    if path.endswith((".parquet", ".pq")):
        return Table(read_parquet(path, columns))
    return read_csv(path, "#" if path.endswith(".ecsv") else None, columns)
