"""The port's parquet reader (imsim_tpu_torch/io/parquet.py) and CSV
reader (catalog/table.py) against pyarrow and pandas, on the CPU:

  * files pyarrow writes with snappy, gzip and no compression, with the
    dictionary on and off, and with small pages and row groups (many
    pages, several groups), holding nulls, lists (empty and null ones,
    null elements), bool, int8/32/64, float32/64 and unicode strings:
    every column bit-equal to `pandas.read_parquet(path)[name].to_numpy()`
    (pyarrow's read), NaN and None in the same places, with the same
    dtypes;
  * the skyCatalogs workload writer's files read back by pyarrow;
  * the features the reader refuses raise a ValueError naming them, and a
    corrupt snappy page raises;
  * CSV type inference against pandas.read_csv."""
import os

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from imsim_tpu_torch.benchmarks import skycat_workload as W
from imsim_tpu_torch.catalog.table import (Table, concat, precise_xstrtod,
                                           read_csv, read_table)
from imsim_tpu_torch.io import parquet as P

N = 3000


def _table(seed=0, n=N):
    rng = np.random.default_rng(seed)
    null = rng.uniform(size=n) < 0.1

    def lists(kind):
        out = []
        for _ in range(n):
            if rng.uniform() < 0.05:
                out.append(None)
                continue
            m = int(rng.integers(0, 5))
            if kind == "f":
                out.append([float(v) if rng.uniform() > 0.1 else None
                            for v in rng.normal(size=m)])
            elif kind == "i":
                out.append([int(v) for v in rng.integers(-9, 9, m)])
            else:
                out.append([f"é{v}" for v in rng.integers(0, 5, m)])
        return out

    return pa.table({
        "i64": pa.array(rng.integers(-2**40, 2**40, n), pa.int64(),
                        mask=null),
        "i64_full": pa.array(rng.integers(-2**62, 2**62, n), pa.int64()),
        "i32": pa.array(rng.integers(-2**31, 2**31, n).astype(np.int32)),
        "i32_null": pa.array(rng.integers(-9, 9, n).astype(np.int32),
                             mask=null),
        "i8": pa.array(rng.integers(-100, 100, n).astype(np.int8)),
        "f32": pa.array(rng.normal(size=n).astype(np.float32), mask=null),
        "f64": pa.array(rng.normal(size=n)),
        "f64_null": pa.array(rng.normal(size=n), mask=null),
        "b": pa.array(rng.uniform(size=n) < 0.5),
        "b_null": pa.array(rng.uniform(size=n) < 0.5, mask=null),
        "s_dict": pa.array([f"sed/ü{int(v)}.txt" for v in
                            rng.integers(0, 40, n)], mask=null),
        "s_plain": pa.array([f"{v!r}€" for v in rng.normal(size=n)]),
        "l_f64": pa.array(lists("f"), pa.list_(pa.float64())),
        "l_i64": pa.array(lists("i"), pa.list_(pa.int64())),
        "l_str": pa.array(lists("s"), pa.list_(pa.string())),
    })


def _norm(v):
    """A value as a comparable key: arrays by dtype and bytes, NaN as
    one token."""
    if isinstance(v, np.ndarray):
        if v.dtype == object:
            return ("obj", tuple(_norm(x) for x in v))
        return ("arr", str(v.dtype), v.tobytes())
    if isinstance(v, float) and v != v:
        return "nan"
    return (type(v).__name__, v)


def assert_same_as_pandas(path, columns=None):
    got = P.read_parquet(path, columns)
    want = pd.read_parquet(path, columns=columns)
    assert list(got) == list(want.columns)
    for c in want.columns:
        w, g = want[c].to_numpy(), got[c]
        assert g.dtype == w.dtype, (c, g.dtype, w.dtype)
        if w.dtype == object:
            assert [_norm(v) for v in g] == [_norm(v) for v in w], c
        else:
            assert g.tobytes() == w.tobytes(), c


@pytest.mark.parametrize("kw", [
    {}, {"compression": "gzip"}, {"compression": "none"},
    {"use_dictionary": False},
    {"compression": "gzip", "use_dictionary": False},
    {"data_page_size": 256, "row_group_size": 700},
    {"compression": "none", "data_page_size": 100, "row_group_size": 333,
     "use_dictionary": False}])
def test_reads_what_pyarrow_writes(tmp_path, kw):
    path = str(tmp_path / "t.parquet")
    pq.write_table(_table(), path, **kw)
    md = pq.ParquetFile(path).metadata
    if "row_group_size" in kw:
        assert md.num_row_groups > 1
    assert_same_as_pandas(path)


def test_a_chunk_that_falls_back_from_dictionary_to_plain(tmp_path):
    """200,000 random doubles overflow pyarrow's dictionary: one chunk
    holds dictionary pages and PLAIN ones, each decoded by its own
    encoding."""
    path = str(tmp_path / "ra.parquet")
    rng = np.random.default_rng(1)
    pq.write_table(pa.table({"ra": rng.uniform(0, 360, 200_000)}), path)
    enc = pq.ParquetFile(path).metadata.row_group(0).column(0).encodings
    assert "PLAIN" in enc and "RLE_DICTIONARY" in enc
    assert_same_as_pandas(path)


def test_dataframe_files_and_column_selection(tmp_path):
    """DataFrame.to_parquet (pandas' metadata, a non-range index written
    as a column that pandas makes the index) and reading only some
    columns."""
    rng = np.random.default_rng(2)
    df = pd.DataFrame({"a": rng.normal(size=50), "b": np.arange(50),
                       "s": [f"x{i}" for i in range(50)]},
                      index=np.arange(50) * 3)
    path = str(tmp_path / "df.parquet")
    df.to_parquet(path)
    assert "__index_level_0__" in pq.ParquetFile(path).schema.names
    assert list(P.read_parquet(path)) == ["a", "b", "s"]
    assert_same_as_pandas(path)
    assert_same_as_pandas(path, ["s", "a"][::-1])
    assert list(P.read_parquet(path, ["s"])) == ["s"]
    with pytest.raises(KeyError):
        P.read_parquet(path, ["nope"])


def test_the_workload_writer_reads_back_in_pyarrow(tmp_path):
    """The generator's own writer (benchmarks/skycat_workload): pyarrow
    reads its columns back as written, and the port reads them as
    pandas does."""
    rng = np.random.default_rng(3)
    n = 500
    lists = np.empty(n, object)
    for i in range(n):
        lists[i] = None if i % 17 == 0 else rng.normal(size=i % 4)
    cols = {"id": np.arange(n, dtype=np.int64),
            "x": np.where(rng.uniform(size=n) < 0.1, np.nan,
                          rng.normal(size=n)),
            "sed_filepath": np.array([f"galaxySED/g{i % 7}.txt.gz"
                                      for i in range(n)], object),
            "name": np.array([None if i % 5 == 0 else f"ö{i}"
                              for i in range(n)], object),
            "sed_val": lists}
    path = str(tmp_path / "w.parquet")
    W.write_parquet(path, cols, dictionary=("sed_filepath",))
    t = pq.read_table(path)
    assert t.column("id").to_pylist() == list(range(n))
    x = t.column("x").to_numpy(zero_copy_only=False)
    assert np.array_equal(np.isnan(x), np.isnan(cols["x"]))
    assert t.column("sed_filepath").to_pylist() == list(cols["sed_filepath"])
    assert t.column("name").to_pylist() == list(cols["name"])
    for got, want in zip(t.column("sed_val").to_pylist(), lists):
        assert (got is None and want is None) or got == list(want)
    enc = pq.ParquetFile(path).metadata.row_group(0).column(2).encodings
    assert "RLE_DICTIONARY" in enc
    assert_same_as_pandas(path)


def test_generated_workload_files(tmp_path):
    """Every parquet file of a small generated workload: the port reads
    what pandas reads."""
    res = W.write_workload(str(tmp_path), n_rows=400, window=(256, 256),
                           margin=20.0, n_bright=1, total_photons=1e5,
                           n_gal_native=40, n_star_native=10,
                           native_photons=1e4)
    for rel in res["sha256"]:
        assert_same_as_pandas(os.path.join(str(tmp_path), rel))
    assert_same_as_pandas(res["tables"]["parquet"])


@pytest.mark.parametrize("kind, match", [
    ("zstd", "ZSTD"), ("brotli", "BROTLI"), ("lz4", "LZ4"),
    ("v2", "DATA_PAGE_V2"), ("int96", "INT96"), ("decimal", "DECIMAL"),
    ("map", "map"), ("struct", "struct"), ("timestamp", "TIMESTAMP")])
def test_refused_features_raise(tmp_path, kind, match):
    path = str(tmp_path / "r.parquet")
    t = pa.table({"a": pa.array([1.0, 2.0])})
    kw = {}
    if kind in ("zstd", "brotli", "lz4"):
        kw["compression"] = kind
    elif kind == "v2":
        kw["data_page_version"] = "2.0"
    elif kind == "int96":
        t = pa.table({"a": pa.array([1, 2], pa.timestamp("ns"))})
        kw["use_deprecated_int96_timestamps"] = True
    elif kind == "decimal":
        import decimal

        t = pa.table({"a": pa.array([decimal.Decimal("1.5")],
                                    pa.decimal128(5, 2))})
    elif kind == "map":
        t = pa.table({"a": pa.array([[("k", 1)]],
                                    pa.map_(pa.string(), pa.int64()))})
    elif kind == "struct":
        t = pa.table({"a": pa.array([{"x": 1, "y": 2.0}])})
    elif kind == "timestamp":
        t = pa.table({"a": pa.array([1, 2], pa.timestamp("ms"))})
    pq.write_table(t, path, **kw)
    with pytest.raises(ValueError, match=match):
        P.read_parquet(path)


def _snappy_streams():
    """A valid snappy stream from pyarrow and corruptions of it."""
    rng = np.random.default_rng(4)
    data = (b"abcdefgh" * 50 + rng.integers(0, 255, 300, np.uint8).tobytes()
            + b"xyz" * 40)
    comp = pa.compress(data, codec="snappy", asbytes=True)
    return data, comp


def test_snappy_decodes_and_refuses_corrupt_streams():
    data, comp = _snappy_streams()
    assert P.snappy_decompress(comp) == data
    rng = np.random.default_rng(5)
    bad = [comp[:len(comp) // 2], comp[:1] + b"\xff" * 8,
           b"\xff\xff\xff\xff\x0f", comp + b"\x01"]
    # a copy reaching before the output's start
    bad.append(bytes([8, 0b01 | (3 << 2), 200]))
    for k in range(200):
        b = bytearray(comp)
        for _ in range(3):
            b[int(rng.integers(1, len(b)))] = int(rng.integers(0, 256))
        bad.append(bytes(b))
    n_raised = 0
    for b in bad:
        try:
            out = P.snappy_decompress(b)
        except ValueError:
            n_raised += 1
            continue
        # a corruption that still parses must decode to the declared size
        assert isinstance(out, bytes)
    assert n_raised >= 5


def test_rle_hybrid_runs():
    """The hybrid decoder: an RLE run, then a bit-packed run whose last
    group is padding."""
    vals = np.array([5] * 10 + [1, 2, 3, 4, 5, 6, 7, 0, 1, 2, 3])
    width = 3
    rle = bytes([10 << 1, 5])
    packed = W._bitpacked(vals[10:], width)
    buf = rle + packed
    assert np.array_equal(P.rle_hybrid(buf, 0, len(buf), width, len(vals)),
                          vals)
    with pytest.raises(ValueError):
        P.rle_hybrid(buf[:4], 0, 4, width, len(vals))


# ---- CSV -------------------------------------------------------------------

CSV_CASES = {
    "types": ("a,b,c,d,e,f,g,h,i\n1,1.5,True,x,,1,+3, 2,NA\n"
              "2,,False,,,1e5,-4,3 ,1\n"),
    "quoted": 'name,v,w\n"x,1",2,-0.0\n"y""q",3,inf\nplain,4,-Infinity\n',
    "bools": "a,b,c\ntrue,TRUE,True\nfalse,False,\n",
    "mixed": "a,b\n1,x\n2.5,\n-,3\n",
    "nan_strings": "a,b\nNaN,None\nn/a,NULL\n1,z\n",
}


@pytest.mark.parametrize("name", sorted(CSV_CASES))
def test_csv_inference_matches_pandas(tmp_path, name):
    path = str(tmp_path / f"{name}.csv")
    with open(path, "w") as f:
        f.write(CSV_CASES[name])
    want = pd.read_csv(path)
    got = read_csv(path)
    assert got.columns == list(want.columns)
    for c in want.columns:
        w, g = want[c].to_numpy(), got[c]
        assert g.dtype == w.dtype, (c, g.dtype, w.dtype)
        if w.dtype == object:
            assert [_norm(v) for v in g] == [_norm(v) for v in w], c
        else:
            assert g.tobytes() == w.tobytes(), c


def test_csv_floats_are_pandas_bits(tmp_path):
    """pandas' C parser reads 17-digit decimals through its own
    accumulate-then-scale converter, not always the correctly rounded
    float: precise_xstrtod gives its bits."""
    rng = np.random.default_rng(6)
    n = 20000
    df = pd.DataFrame({"a": rng.normal(size=n) * 10.0 ** rng.integers(
        -12, 12, n), "b": rng.uniform(size=n), "c": np.round(
            rng.uniform(size=n), 4)})
    path = str(tmp_path / "f.csv")
    df.to_csv(path, index=False)
    want = pd.read_csv(path)
    got = read_csv(path)
    for c in "abc":
        assert got[c].tobytes() == want[c].to_numpy().tobytes(), c
    text = open(path).read().split("\n")[1:-1]
    python = np.array([float(t.split(",")[0]) for t in text])
    # the case the converter exists for: Python's float differs
    assert (python != want["a"].to_numpy()).any()
    assert precise_xstrtod("1.5e3") == 1500.0


def test_ecsv_comments_and_tables(tmp_path):
    """read_table: .ecsv skips '#' comments, parquet goes through
    io/parquet; boolean selection and concat as pandas' concat with
    ignore_index."""
    path = str(tmp_path / "t.ecsv")
    with open(path, "w") as f:
        f.write("# %ECSV 1.0\n# ---\n# datatype:\n# - {name: a}\n"
                "a,b\n1,x # trailing\n\n2,y\n")
    want = pd.read_csv(path, comment="#")
    got = read_table(path)
    assert got["a"].tobytes() == want["a"].to_numpy().tobytes()
    assert list(got["b"]) == list(want["b"].to_numpy())
    sel = got[got["a"] > 1]
    assert len(sel) == 1 and list(sel["b"]) == ["y"]
    t1 = Table({"a": np.array([1, 2]), "s": np.array(["u", "v"], object)})
    t2 = Table({"a": np.array([3]), "f": np.array([0.5])})
    t3 = Table({"a": np.array([4.5]), "b": np.array([True])})
    cat = concat([t1, t2, t3])
    pcat = pd.concat([pd.DataFrame({"a": [1, 2], "s": ["u", "v"]}),
                      pd.DataFrame({"a": [3], "f": [0.5]}),
                      pd.DataFrame({"a": [4.5], "b": [True]})],
                     ignore_index=True)
    assert cat.columns == list(pcat.columns)
    for c in pcat.columns:
        w = pcat[c].to_numpy()
        assert cat[c].dtype == w.dtype, c
        assert [_norm(v) for v in cat[c]] == [_norm(v) for v in w], c


def test_the_codec_build_raises_without_gxx(tmp_path, monkeypatch):
    """No g++, no codec: a source not built yet raises (no Python
    fallback)."""
    from imsim_tpu_torch.io import gxx

    src = tmp_path / "snappy_copy.cc"
    src.write_text(open(P.SRC).read() + "\n// a copy not built yet\n")
    monkeypatch.setattr(gxx.shutil, "which", lambda name: None)
    monkeypatch.setattr(gxx, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        gxx.load(str(src), "_snappy_test_")
