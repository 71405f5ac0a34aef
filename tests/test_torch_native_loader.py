"""The port's native host loader (lightgbm_tpu_torch/io/native.py over
lightgbm_tpu_torch/csrc/data_loader.cpp) against the JAX package's
(lightgbm_tpu/io/native.py over csrc/data_loader.cpp), on the CPU.

The JAX package's tests/test_native_loader.py, ported to the repo's own
``examples/*/`` files: the port's ``parse_file_native`` is held bit-equal
to the JAX package's, and against the port's own Python read as the JAX
test holds its own.  Besides:

* a seeded Higgs-like CSV (5000 x 28, written with ``repr``) reads to
  the same bits through both packages' ``parse_file``, with nothing
  patched, where the port's Python read differs in the last bits;
* a one-round ``Dataset(path)`` of a clean example gives mappers and
  bins byte-equal to the JAX package's one-round load;
* ``values_to_bins_native`` equals ``searchsorted`` at 70000 values in
  uint8 and uint16, NaN in bin 0, and ``BinMapper.value_to_bin`` takes
  it from 65536 values;
* the counters show that ``Dataset(path)``, ``parallel/ingest.py`` and
  the C API's file entry points took the native path, and a dirty file
  the guarded Python path with its ``file:line`` diagnostics;
* concurrent builds never leave a partial library, and without a
  compiler the loader says why and the reads go through Python.

The tests skip only where no C++ compiler is on ``PATH``.
"""

import ctypes
import threading
import unittest.mock as mock

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu.io import native as jnative
from lightgbm_tpu.io import parser as jparser

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.capi import impl as capi
from lightgbm_tpu_torch.io import native
from lightgbm_tpu_torch.io import parser as tparser
from lightgbm_tpu_torch.io.binning import NATIVE_BIN_MIN, BinMapper
from lightgbm_tpu_torch.parallel.ingest import load_file_sharded

import chip_smoke as cs
from test_torch_train import make_higgs_like

pytestmark = pytest.mark.torch

EX = cs.REPO + "/examples"
EXAMPLE_FILES = [
    f"{EX}/regression/regression.train",            # tsv
    f"{EX}/regression/regression.test",
    f"{EX}/binary_classification/binary.train",
    f"{EX}/binary_classification/binary.test",      # tsv
    f"{EX}/multiclass_classification/multiclass.train",
    f"{EX}/multiclass_classification/multiclass.test",
    f"{EX}/lambdarank/rank.train",                  # libsvm
    f"{EX}/lambdarank/rank.test",
]


@pytest.fixture(scope="module")
def lib():
    if native.compiler() is None:
        pytest.skip("no C++ compiler on PATH")
    got = native.get_lib()
    assert got is not None, native.status()
    assert native.status() in ("built", "loaded")
    assert jnative.get_lib() is not None
    return got


def _python_parse(path, **kw):
    """The port's Python path (the native read patched away)."""
    with mock.patch("lightgbm_tpu_torch.io.native.parse_file_native",
                    return_value=None):
        return tparser.parse_file(path, **kw)


def _bits(a):
    return np.ascontiguousarray(a, np.float64).view(np.int64)


def _same_bits(a, b):
    assert a.shape == b.shape
    np.testing.assert_array_equal(_bits(a), _bits(b))


def _both_native(path, **kw):
    t = native.parse_file_native(path, **kw)
    j = jnative.parse_file_native(path, **kw)
    _same_bits(t[0], j[0])
    _same_bits(t[1], j[1])
    assert t[2:] == j[2:]
    return t


def _ulps(a, b):
    """Units in the last place between same-signed f64 arrays."""
    return np.abs(_bits(a) - _bits(b))


@pytest.mark.parametrize("path", EXAMPLE_FILES)
def test_native_matches_python_on_example_files(lib, path):
    y_n, X_n, _, bad = _both_native(path)
    assert bad == -1
    y_p, X_p, _ = _python_parse(path)
    assert X_n.shape == X_p.shape
    np.testing.assert_allclose(y_n, y_p, rtol=1e-12)
    np.testing.assert_allclose(X_n, X_p, rtol=1e-9, atol=1e-12)


def test_native_no_trailing_newline(lib, tmp_path):
    p = tmp_path / "d.csv"
    p.write_text("1,0.5,2\n0,1.5,3")  # last line unterminated
    y, X, _, bad = _both_native(str(p))
    assert bad == -1
    np.testing.assert_allclose(y, [1, 0])
    np.testing.assert_allclose(X, [[0.5, 2.0], [1.5, 3.0]])


def test_native_libsvm_label_less_rows(lib, tmp_path):
    # predict-time LibSVM: a first token that is an index:value pair means
    # the row has no label; feature 0 must not swallow the first pair
    p = tmp_path / "d.svm"
    p.write_text("0:1.5 2:2.5\n1:3.5\n")
    y_n, X_n, fmt, bad = _both_native(str(p))
    assert fmt == "libsvm" and bad == -1
    y_p, X_p, _ = _python_parse(str(p))
    assert X_n.shape == X_p.shape == (2, 3)
    np.testing.assert_allclose(y_n, [0.0, 0.0])
    np.testing.assert_allclose(X_n, [[1.5, 0.0, 2.5], [0.0, 3.5, 0.0]])
    np.testing.assert_allclose(X_n, X_p)
    np.testing.assert_allclose(y_n, y_p)


def test_native_csv_with_header_and_exponents(lib, tmp_path):
    p = tmp_path / "d.csv"
    p.write_text("label,a,b\n1,0.5,-2e3\n0,1.25e-2,3\n2,-0.75,+4.5\n")
    native.reset_counts()
    y, X, header = tparser.parse_file(str(p), has_header=True)
    assert native.counts()["parse"] == 1
    np.testing.assert_allclose(y, [1, 0, 2])
    np.testing.assert_allclose(X, [[0.5, -2000.0], [0.0125, 3.0],
                                   [-0.75, 4.5]])
    assert header == ["a", "b"]
    jy, jX, jheader = jparser.parse_file(str(p), has_header=True)
    _same_bits(X, jX)
    _same_bits(y, jy)
    assert header == jheader
    # the label column elsewhere, and a width asked for
    y2, X2, h2 = tparser.parse_file(str(p), has_header=True, label_idx=2,
                                    num_features=3)
    jy2, jX2, jh2 = jparser.parse_file(str(p), has_header=True,
                                       label_idx=2, num_features=3)
    _same_bits(X2, jX2)
    _same_bits(y2, jy2)
    assert h2 == jh2 == ["label", "a"] and X2.shape == (3, 3)


def test_values_to_bins_matches_searchsorted(lib):
    rng = np.random.RandomState(0)
    values = rng.normal(size=100_000) * 10
    bounds = np.sort(rng.normal(size=31) * 10)
    bounds = np.concatenate([bounds, [np.inf]])
    got = native.values_to_bins_native(values, bounds, np.uint8)
    want = np.searchsorted(bounds[:-1], values, side="left")
    np.testing.assert_array_equal(got.astype(np.int64), want)
    np.testing.assert_array_equal(
        got, jnative.values_to_bins_native(values, bounds, np.uint8))


def test_values_to_bins_u16(lib):
    rng = np.random.RandomState(1)
    values = rng.uniform(0, 1000, size=70_000)
    bounds = np.concatenate([np.linspace(1, 999, 999), [np.inf]])
    got = native.values_to_bins_native(values, bounds, np.uint16)
    want = np.searchsorted(bounds[:-1], values, side="left")
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got.astype(np.int64), want)


def test_native_nan_token_and_no_label(lib, tmp_path):
    # NA spellings and empty fields are missing values (NaN), not dirt
    p = tmp_path / "d.csv"
    p.write_text("1,nan,2\n0,3,na\n1,NULL,\n")
    y, X, _, bad = _both_native(str(p))
    assert bad == -1
    np.testing.assert_allclose(
        X, [[np.nan, 2.0], [3.0, np.nan], [np.nan, np.nan]])
    # label_idx=-1: no label column, every column a feature
    y2, X2, _, _ = _both_native(str(p), label_idx=-1)
    np.testing.assert_allclose(y2, [0.0, 0.0, 0.0])
    assert X2.shape == (3, 3)


def test_native_na_parity_with_python(lib, tmp_path):
    p = tmp_path / "na.csv"
    p.write_text("1,na,2.5\n0,3.5,NaN\n1,NULL,none\n0,,4.5\n")
    y_n, X_n, _, bad = _both_native(str(p))
    assert bad == -1
    y_p, X_p, _ = _python_parse(str(p))
    np.testing.assert_allclose(y_n, y_p)
    np.testing.assert_allclose(X_n, X_p)
    assert np.isnan(X_p[0, 0]) and np.isnan(X_p[1, 1])
    assert np.isnan(X_p[2, 0]) and np.isnan(X_p[2, 1])
    assert np.isnan(X_p[3, 0])


def test_native_flags_malformed_rows(lib, tmp_path):
    p = tmp_path / "dirty.csv"
    p.write_text("1,0.5,2\n0,xx,3\n1,4,5\n")
    assert _both_native(str(p))[3] == 2
    r = tmp_path / "ragged.csv"
    r.write_text("1,0.5,2\n0,3\n")
    assert _both_native(str(r))[3] == 2
    s = tmp_path / "neg.svm"
    s.write_text("1 0:1.5\n0 -2:3.0\n")
    assert _both_native(str(s))[3] == 2
    c = tmp_path / "clean.csv"
    c.write_text("1,0.5,2\n0,1.5,3\n")
    assert _both_native(str(c))[3] == -1


@pytest.mark.parametrize("n", [500, 70_000])
def test_binning_nan_goes_to_bin_zero(n):
    """Below NATIVE_BIN_MIN through ``searchsorted``, at or above it
    through the native search where it builds: NaN in bin 0 either
    way."""
    rng = np.random.RandomState(0)
    m = BinMapper().find_bin(rng.normal(size=500), 500, 16, 3, 0)
    vals = rng.normal(size=n)
    vals[::7] = np.nan
    native.reset_counts()
    bins = m.value_to_bin(vals)
    assert native.counts()["bins"] == (n >= NATIVE_BIN_MIN
                                       and native.get_lib() is not None)
    assert (bins[::7] == 0).all()
    want = np.searchsorted(m.bin_upper_bound[:-1], vals, side="left")
    want = np.where(np.isnan(vals), 0, want)
    np.testing.assert_array_equal(bins, want)
    assert bins.dtype == np.int64


# ---------------------------------------------------------------------------
# the whole-file reads and the callers


@pytest.fixture(scope="module")
def higgs_csv(tmp_path_factory):
    """5000 x 28 Higgs-like rows in f64, label first, every value written
    with ``repr`` (17 significant digits)."""
    X, y = make_higgs_like(5000, seed=3)
    rng = np.random.RandomState(4)
    X = X.astype(np.float64) + rng.normal(size=X.shape) * 1e-3
    path = tmp_path_factory.mktemp("higgs") / "higgs.csv"
    with open(path, "w") as fh:
        for label, row in zip(y, X):
            fh.write(",".join([repr(float(label))]
                              + [repr(float(v)) for v in row]) + "\n")
    return str(path)


def test_higgs_like_csv_reads_to_jax_bits_with_nothing_patched(
        lib, higgs_csv):
    native.reset_counts()
    y, X, header = tparser.parse_file(higgs_csv)
    assert native.counts() == {"parse": 1, "flagged": 0, "bins": 0}
    jy, jX, jheader = jparser.parse_file(higgs_csv)
    assert X.shape == (5000, 28) and header is None and jheader is None
    _same_bits(X, jX)
    _same_bits(y, jy)
    # the port's Python read rounds correctly; the loader may not
    _, Xp, _ = _python_parse(higgs_csv)
    ulps = _ulps(X, Xp)
    assert 0 < ulps.max() <= 8
    assert (ulps > 0).mean() > 0.1


def test_one_round_dataset_of_an_example_equals_jax(lib):
    path = f"{EX}/regression/regression.train"
    params = {"max_bin": 255, "verbose": -1}
    native.reset_counts()
    t = lt.Dataset(path, params=dict(params)).construct()._binned
    assert native.counts()["parse"] == 1
    j = lgb.Dataset(path, params=dict(params)).construct()._binned
    np.testing.assert_array_equal(t.bins, j.bins)
    assert t.bins.dtype == j.bins.dtype
    assert t.feature_infos() == j.feature_infos()
    assert len(t.mappers) == len(j.mappers)
    for tm, jm in zip(t.mappers, j.mappers):
        assert (tm.num_bin, tm.bin_type, tm.default_bin) == \
            (jm.num_bin, jm.bin_type, jm.default_bin)
        _same_bits(tm.bin_upper_bound, jm.bin_upper_bound)
    _same_bits(t.metadata.label, j.metadata.label)


def test_a_model_from_the_file_equals_jax_thresholds_exactly(lib):
    """Both packages read the file natively, so thresholds (midpoints of
    the parsed values) agree exactly, not only within the 1e-9 the
    example-parity tests allow."""
    path = f"{EX}/binary_classification/binary.train"
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1}
    bt = lt.train(params, lt.Dataset(path, params=params), 2,
                  device="cpu")
    bj = lgb.train(params, lgb.Dataset(path, params=params), 2,
                   verbose_eval=False)
    tt = bt._booster.models
    jt = bj._booster.models
    assert len(tt) == len(jt) == 2
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        _same_bits(np.asarray(a.threshold), np.asarray(b.threshold))


def test_parallel_ingest_reads_natively(lib, higgs_csv):
    native.reset_counts()
    shards, header = load_file_sharded(higgs_csv, 3)
    assert native.counts()["parse"] == 1
    _, jX, _ = jparser.parse_file(higgs_csv)
    _same_bits(np.concatenate([s[0] for s in shards]), jX)
    assert [len(s[0]) for s in shards] == [1667, 1667, 1666]


def test_capi_file_entry_points_read_natively(lib, tmp_path):
    path = f"{EX}/binary_classification/binary.train"
    native.reset_counts()
    ds = [0]
    assert capi.LGBM_DatasetCreateFromFile(
        ctypes.c_char_p(path.encode()), ctypes.c_char_p(b"max_bin=63"),
        None, ds) == 0
    assert native.counts()["parse"] == 1
    booster = [0]
    try:
        assert capi.LGBM_BoosterCreate(ds[0], ctypes.c_char_p(
            b"objective=binary num_leaves=4 max_bin=63 device=cpu"),
            booster) == 0
        finished = [0]
        assert capi.LGBM_BoosterUpdateOneIter(booster[0], finished) == 0
        out = tmp_path / "pred.txt"
        test = f"{EX}/binary_classification/binary.test"
        assert capi.LGBM_BoosterPredictForFile(
            booster[0], ctypes.c_char_p(test.encode()), 0, 0, -1,
            ctypes.c_char_p(str(out).encode())) == 0
        assert native.counts()["parse"] == 2
        assert len(out.read_text().splitlines()) == 2000
    finally:
        capi.LGBM_BoosterFree(booster[0])
        capi.LGBM_DatasetFree(ds[0])


def test_a_dirty_file_goes_through_the_guarded_python_path(lib, tmp_path):
    p = tmp_path / "dirty.csv"
    rows = [f"{i % 2},{i * 0.5},{i}" for i in range(40)]
    rows[6] = "1,oops,3"
    p.write_text("\n".join(rows) + "\n")
    native.reset_counts()
    with pytest.raises(LightGBMError, match=r"dirty\.csv:7: .*oops"):
        tparser.parse_file(str(p))
    assert native.counts() == {"parse": 0, "flagged": 1, "bins": 0}
    ds = lt.Dataset(str(p), params={"bad_data_policy": "quarantine",
                                    "min_data_in_leaf": 5,
                                    "verbose": -1}).construct()
    assert ds.num_data() == 39
    q = (tmp_path / "dirty.csv.quarantine").read_text().splitlines()
    assert any(line.startswith("7\t") for line in q)


# ---------------------------------------------------------------------------
# the build


def test_concurrent_builds_leave_one_whole_library(lib, tmp_path):
    cxx = native.compiler()
    out = tmp_path / "libdata_loader-concurrent.so"
    errors = []

    def build():
        errors.append(native._build(cxx, out))

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert errors == [None] * 4
    assert [f.name for f in tmp_path.iterdir()] == [out.name]
    loaded = native._bind(ctypes.CDLL(str(out)))
    got = np.zeros(3, np.uint8)
    v = np.array([-1.0, 0.5, np.nan])
    b = np.array([0.0, 1.0, np.inf])
    loaded.lgbt_values_to_bins(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), 3,
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), 3,
        got.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), None, 0)
    np.testing.assert_array_equal(got, [0, 1, 0])


def test_compiler_choice_follows_cxx_then_ccs_sibling(tmp_path,
                                                      monkeypatch):
    for name in ("g++", "my-c++"):
        exe = tmp_path / name
        exe.write_text("#!/bin/sh\n")
        exe.chmod(0o755)
    monkeypatch.setenv("CXX", str(tmp_path / "my-c++"))
    assert native.compiler() == str(tmp_path / "my-c++")
    monkeypatch.delenv("CXX")
    monkeypatch.setenv("CC", str(tmp_path / "gcc"))
    assert native.compiler() == str(tmp_path / "g++")
    monkeypatch.setenv("CC", "clang")
    monkeypatch.setenv("PATH", str(tmp_path / "none"))
    assert native.compiler() is None


def test_without_a_compiler_reads_go_through_python_and_say_why(
        tmp_path, monkeypatch):
    p = tmp_path / "d.csv"
    p.write_text("1,0.5,2\n0,1.5,3\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_status", "not tried")
    monkeypatch.setattr(native, "compiler", lambda: None)
    warned = []
    monkeypatch.setattr(native.log, "warning",
                        lambda msg, *a: warned.append(msg % a))
    native.reset_counts()
    y, X, _ = tparser.parse_file(str(p))
    np.testing.assert_allclose(X, [[0.5, 2.0], [1.5, 3.0]])
    np.testing.assert_allclose(y, [1, 0])
    tparser.parse_file(str(p))
    assert native.status().startswith("no C++ compiler")
    assert len(warned) == 1 and "no C++ compiler" in warned[0]
    assert native.counts() == {"parse": 0, "flagged": 0, "bins": 0}
    assert native.values_to_bins_native(np.zeros(3), np.array([np.inf])) \
        is None
