"""One row of a table file as config values (imsim_tpu/catalog/
table_row.py counterpart; the reference's RowData): the row whose key
column equals the key value, its columns by name, with a unit scale.
The file is read by catalog/table.read_table (CSV, ECSV or parquet), not
pandas."""
from __future__ import annotations

import functools

import numpy as np

from .table import Table, read_table

_UNIT_SCALE = {
    None: 1.0, "": 1.0,
    "deg": np.pi / 180.0, "degree": np.pi / 180.0,
    "arcsec": np.pi / 180.0 / 3600.0,
    "rad": 1.0,
    "um": 1e-6, "micron": 1e-6, "mm": 1e-3, "m": 1.0,
}


@functools.lru_cache(maxsize=32)
def _read_table(file_name: str) -> Table:
    return read_table(file_name)


def _matches(col: np.ndarray, value) -> np.ndarray:
    """col == value element by element, as a pandas column compares: a
    string never equals a number."""
    if col.dtype == object:
        return np.array([v == value for v in col], bool)
    if isinstance(value, (str, bytes)):
        return np.zeros(len(col), bool)
    return np.asarray(col == value, bool)


def load_row(file_name: str, key_column: str, key_value) -> dict:
    """The one row with key_column == key_value, as
    `dict(DataFrame.iloc[0])` gives it; KeyError without a match,
    ValueError with several."""
    tab = _read_table(file_name)
    hit = np.flatnonzero(_matches(tab[key_column], key_value))
    if len(hit) == 0:
        raise KeyError(f"{key_column}=={key_value!r} not in {file_name}")
    if len(hit) > 1:
        raise ValueError(f"{key_column}=={key_value!r} matches "
                         f"{len(hit)} rows in {file_name}")
    return tab.row(int(hit[0]))


def row_data(node: dict, view) -> object:
    """The config value {type: RowData, file_name, key_column, key_value,
    field[, to_unit]}: numbers scaled to the unit."""
    row = load_row(str(view.resolve(node["file_name"])),
                   str(view.resolve(node["key_column"])),
                   view.resolve(node["key_value"]))
    val = row[str(view.resolve(node["field"]))]
    unit = node.get("to_unit")
    if unit is not None and isinstance(val, (int, float, np.floating)):
        val = float(val) * _UNIT_SCALE.get(unit, 1.0)
    return val
