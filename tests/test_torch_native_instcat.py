"""The port's native instance-catalog tokenizer
(imsim_tpu_torch.catalog.native_instcat, io/native/instcat.cc), the
default parse path of catalog/instcat._parse_instcat, against its plain
twin (the Python loop, force_python=True) and the JAX package's native
tokenizer, on synthetic catalogs with flip_g2 and skip_invalid both ways
(dust markers, invalid rows, the inf sentinel), a Sersic index at a
rounding tie, gzip with includeobj in encounter order, a FITS-image row,
the example catalog and the instance-catalog workload
(benchmarks/instcat_workload.py, 120,000 lines); an unknown type raises
in both paths.  Also io/rice.instcat_object_offsets against the JAX
package's.

The native table equals the JAX package's native table bit for bit.  It
equals the Python loop's bit for bit except in two columns, where the
JAX package's two paths differ the same way: a Sersic index whose 20 n
is a tie (x.5) rounds half away from zero in C++ (std::round) and half
to even in Python (round), 0.05 apart; mu = 1 / ((1 - kappa)^2 - ...)
squares with a product in C++ and with pow in Python: the denominators
differ in their last bit, mu by at most 2 ulp."""
import gzip
import os

import numpy as np
import pytest

from imsim_tpu.catalog.native_instcat import parse_instcat_native as jnative
from imsim_tpu.io.rice import instcat_object_offsets as j_offsets
from imsim_tpu_torch.catalog import instcat as TI
from imsim_tpu_torch.catalog.native_instcat import parse_instcat_native
from imsim_tpu_torch.io.rice import instcat_object_offsets

from test_native_instcat import CAT, LINES

TIE_LINE = ("object 4001 30.12 -20.12 21.4 galaxySED/g.spec 0.1 0 0 0 0 0 "
            "sersic2d 1.0 0.5 10.0 1.325 none none\n")
FITS_LINE = ("object 3001 30.11 -20.11 21.2 galaxySED/f.spec 0.1 0 0 0 0 0 "
             "stamps/gal_3001.fits 0.2 30.0 CCM 0.03 3.1 none\n")
COLS = ("ra", "dec", "magnorm", "redshift", "g1", "g2", "mu", "p0", "p1",
        "p2", "p3", "int_av", "int_rv", "mw_av", "mw_rv")


def _bit_equal(a, b):
    assert len(a) == len(b)
    for f in ("id", "sed_name", "image_file"):
        assert list(getattr(a, f)) == list(getattr(b, f)), f
    assert getattr(a, "obj_type").dtype == getattr(b, "obj_type").dtype
    np.testing.assert_array_equal(a.obj_type, b.obj_type)
    for f in COLS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype == np.float64, f
        assert x.tobytes() == y.tobytes(), f


def _twin_equal(nat, py):
    """The native table against the Python loop's: bit-equal but for the
    Sersic index at rounding ties and mu's last bits.  Returns the
    numbers of rows that differ in p1 and mu."""
    _bit_equal_except(nat, py, ("p1", "mu"))
    d1 = np.nonzero(nat.p1 != py.p1)[0]
    assert np.all(nat.obj_type[d1] == TI.SERSIC)
    np.testing.assert_allclose(np.abs(nat.p1[d1] - py.p1[d1]), 0.05,
                               rtol=1e-9)
    mid = 10.0 * (nat.p1[d1] + py.p1[d1])          # 20 x the midpoint
    np.testing.assert_allclose(mid - np.floor(mid), 0.5, atol=1e-9)
    # half to even in Python: 20 n rounds to an even integer there
    assert np.all(np.round(20 * py.p1[d1]) % 2 == 0)
    dm = np.nonzero(nat.mu != py.mu)[0]
    # the denominators differ in their last bit: mu by at most 2 ulp
    ulp = np.maximum(np.spacing(nat.mu[dm]), np.spacing(py.mu[dm]))
    assert np.all(np.abs(nat.mu[dm] - py.mu[dm]) <= 2 * ulp)
    return len(d1), len(dm)


def _bit_equal_except(a, b, skip):
    assert len(a) == len(b)
    for f in ("id", "sed_name", "image_file"):
        assert list(getattr(a, f)) == list(getattr(b, f)), f
    np.testing.assert_array_equal(a.obj_type, b.obj_type)
    for f in COLS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype == np.float64, f
        if f not in skip:
            assert x.tobytes() == y.tobytes(), f


def _three(path, **kw):
    """(native, Python loop, JAX native) of the port's parse."""
    nat = TI._parse_instcat(path, **kw)
    py = TI._parse_instcat(path, force_python=True, **kw)
    jax = jnative(path, **kw)
    assert nat[1] == py[1] == jax[1]
    return nat[0], py[0], jax[0]


@pytest.mark.parametrize("flip_g2", [True, False])
@pytest.mark.parametrize("skip_invalid", [True, False])
def test_synthetic_catalog_bit_equal(tmp_path, flip_g2, skip_invalid):
    p = str(tmp_path / "cat.txt")
    with open(p, "w") as f:
        f.write("# header\nrightascension 30.0\n" + LINES + FITS_LINE)
    nat, py, jax = _three(p, flip_g2=flip_g2, skip_invalid=skip_invalid)
    assert len(nat) == (7 if skip_invalid else 9)
    _bit_equal(nat, py)          # no rounding tie, no mu to its last bit
    _bit_equal(nat, jax)


def test_sersic_index_tie(tmp_path):
    """20 n = 26.5: the native paths keep 1.35, the Python loop 1.3."""
    p = str(tmp_path / "cat.txt")
    with open(p, "w") as f:
        f.write(TIE_LINE)
    nat, py, jax = _three(p)
    _bit_equal(nat, jax)
    assert (nat.p1[0], py.p1[0]) == (1.35, 1.3)
    assert _twin_equal(nat, py) == (1, 0)


def test_fits_image_row(tmp_path):
    p = str(tmp_path / "cat.txt")
    with open(p, "w") as f:
        f.write(FITS_LINE)
    nat, py, jax = _three(p)
    assert list(nat.image_file) == ["stamps/gal_3001.fits"]
    assert nat.obj_type[0] == TI.FITSIMAGE and nat.int_av[0] == 0.03
    _bit_equal(nat, py)
    _bit_equal(nat, jax)


def test_gzip_and_includeobj_in_encounter_order(tmp_path):
    sub = tmp_path / "part.txt.gz"
    with gzip.open(sub, "wt") as f:
        f.write(LINES)
    inner = tmp_path / "inner.txt"
    inner.write_text(FITS_LINE)
    main = tmp_path / "main.txt.gz"
    with gzip.open(main, "wt") as f:
        f.write("rightascension 30.0\n"
                "object 2001 30.0 -20.0 21.5 starSED/x.txt 0 0 0 0 0 0"
                " point none none\n"
                "includeobj part.txt.gz\n"
                "object 2002 30.1 -20.1 21.6 starSED/y.txt 0 0 0 0 0 0"
                " point none none\n"
                "includeobj inner.txt\n")
    nat, py, jax = _three(str(main))
    assert list(nat.id) == ["2001", "1001", "1002", "1003", "1004",
                            "1008", "1009", "2002", "3001"]
    _bit_equal(nat, py)
    _bit_equal(nat, jax)


def test_example_catalog(tmp_path):
    nat, py, jax = _three(CAT)
    assert len(nat) > 0
    _bit_equal(nat, jax)
    _twin_equal(nat, py)


def test_unknown_type_raises(tmp_path):
    p = str(tmp_path / "bad.txt")
    with open(p, "w") as f:
        f.write("object 1 1.0 1.0 20.0 s.txt 0 0 0 0 0 0 blob 1 2\n")
    for kw in ({}, {"force_python": True}):
        with pytest.raises(RuntimeError, match="Unknown object type: blob"):
            TI._parse_instcat(p, **kw)


def test_read_instcat_parses_natively(tmp_path, monkeypatch):
    """read_instcat goes through the native tokenizer (a stub that
    raises is reached) and returns its table sorted by magnitude."""
    p = str(tmp_path / "cat.txt")
    with open(p, "w") as f:
        f.write(LINES + FITS_LINE)
    TI._parse_instcat_cached.cache_clear()
    got = TI.read_instcat(p)
    nat, _ = TI._parse_instcat(p)
    from imsim_tpu_torch.catalog import native_instcat

    def no_native(*a, **k):
        raise AssertionError("the native tokenizer ran")

    monkeypatch.setattr(native_instcat, "parse_instcat_native", no_native)
    TI._parse_instcat_cached.cache_clear()
    with pytest.raises(AssertionError, match="native tokenizer ran"):
        TI.read_instcat(p)
    _bit_equal(got, nat.select(np.argsort(nat.magnorm)))
    TI._parse_instcat_cached.cache_clear()


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    from imsim_tpu_torch.benchmarks import instcat_workload as WL

    return WL.write_workload(str(tmp_path_factory.mktemp("wl")))


def test_workload_catalog(workload):
    nat, py, jax = _three(workload["catalog"]["r"])
    assert len(nat) > 100_000
    _bit_equal(nat, jax)
    # 708 Sersic ties and 80 rows of mu's last bits in the 120,000 rows
    n_p1, n_mu = _twin_equal(nat, py)
    assert 0 < n_p1 < 0.01 * len(nat) and 0 < n_mu < 0.001 * len(nat)


def test_object_offsets(tmp_path, workload):
    with open(workload["catalog"]["r"], "rb") as f:
        data = f.read()
    off = instcat_object_offsets(data)
    np.testing.assert_array_equal(off, j_offsets(data))
    assert off.dtype == np.int64 and len(off) > 100_000
    assert all(data[o:o + 6] == b"object" for o in off[:100])
    small = ("rightascension 30\n" + LINES).encode()
    np.testing.assert_array_equal(instcat_object_offsets(small),
                                  j_offsets(small))
    assert len(instcat_object_offsets(small)) == 9
