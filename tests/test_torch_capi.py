"""The port's C API (``lightgbm_tpu_torch/capi/``) against the JAX
package's ``capi.impl``, on the CPU.

The port's library is built from its C shim and loaded with ``ctypes``
in this process (its first call joins this interpreter and binds
``impl.py``); the JAX reference is its ``impl`` driven in-process through
a plain ``cffi.FFI()`` (``tests/test_model_merge.py`` does the same).
``Api`` writes each call sequence once, over two small adapters, so the
same calls with the same numpy inputs go to both.  The data are the
repo's ``examples/binary_classification`` files (5000 training rows,
2000 test rows, 28 features).  Every booster of the port says
``device=cpu``, except where a test shows the refusal without it.

Held: JAX's four C API scenarios (error reporting, push rows, dataset
I/O, train and predict), the port's model text against its Python
``Booster``, a compiled C program that boots the interpreter itself,
every argument form, the errors, and the refusal of a Booster whose
``max_bin`` is below its dataset's.
"""

import ctypes
import json
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

import chip_smoke as cs
import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.capi import cdef as jax_cdef
from lightgbm_tpu_torch.capi import build as capi_build
from lightgbm_tpu_torch.capi import cdef, impl
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch

cffi = pytest.importorskip("cffi")

REPO = Path(__file__).resolve().parent.parent
EXAMPLE = REPO / "examples" / "binary_classification"
TRAIN_FILE = str(EXAMPLE / "binary.train")
TEST_FILE = str(EXAMPLE / "binary.test")
CPU = "device=cpu"
PARAMS = "objective=binary metric=auc num_leaves=15 max_bin=63 verbose=-1"
ROUNDS = 6
F32, F64, I32, I64 = 0, 1, 2, 3
NORMAL, RAW, LEAF = 0, 1, 2
# the model texts' trees (chip_smoke.compare_model_texts): thresholds to
# 1e-9 relative, leaf values within 1e-5 of a tree's largest, a split
# flipped only at an f32 near-tie of gains
TIE_RTOL = LEAF_RTOL = 1e-5
PRED_ATOL = 1e-6            # tests/test_torch_api.py's tolerance
FILE_ATOL = 5e-6            # %g text against the doubles (JAX's pin)
DEMO_TIMEOUT_S = 120


# ---------------------------------------------------------------------------
# the same calls through either package


class Api:
    """The LGBM_* call sequences of these tests, written once over the
    primitives of a binding (``ctypes`` for the port's library, ``cffi``
    for the JAX ``impl``).  ``ok`` raises with the last error on -1."""

    def ok(self, rc):
        assert rc == 0, self.error()
        return rc

    def dataset_from_mat(self, X, params, ref=None, row_major=True):
        X = np.ascontiguousarray(X if row_major else X.T, np.float64)
        n, f = (X.shape if row_major else X.shape[::-1])
        h = self.handle()
        self.ok(self.fn("LGBM_DatasetCreateFromMat")(
            self.ptr(X), F64, n, f, int(row_major), self.s(params),
            self.h(ref), self.ref(h)))
        return self.value(h)

    def dataset_from_file(self, path, params):
        h = self.handle()
        self.ok(self.fn("LGBM_DatasetCreateFromFile")(
            self.s(path), self.s(params), self.null, self.ref(h)))
        return self.value(h)

    def dataset_from_csr(self, X, params, ref=None, ip_type=I32,
                         data_type=F64):
        csr = sp.csr_matrix(X)
        ip = csr.indptr.astype(np.int32 if ip_type == I32 else np.int64)
        data = csr.data.astype(np.float32 if data_type == F32
                               else np.float64)
        idx = csr.indices.astype(np.int32)
        h = self.handle()
        self.ok(self.fn("LGBM_DatasetCreateFromCSR")(
            self.ptr(ip), ip_type, self.typed(idx, "int32_t"),
            self.ptr(data), data_type, len(ip), csr.nnz, X.shape[1],
            self.s(params), self.h(ref), self.ref(h)))
        return self.value(h)

    def dataset_from_csc(self, X, params, ref=None, ip_type=I32,
                         data_type=F64):
        csc = sp.csc_matrix(X)
        cp = csc.indptr.astype(np.int32 if ip_type == I32 else np.int64)
        data = csc.data.astype(np.float32 if data_type == F32
                               else np.float64)
        idx = csc.indices.astype(np.int32)
        h = self.handle()
        self.ok(self.fn("LGBM_DatasetCreateFromCSC")(
            self.ptr(cp), ip_type, self.typed(idx, "int32_t"),
            self.ptr(data), data_type, len(cp), csc.nnz, X.shape[0],
            self.s(params), self.h(ref), self.ref(h)))
        return self.value(h)

    def set_field(self, ds, name, arr, dtype_code):
        arr = np.ascontiguousarray(arr, cs_dtype(dtype_code))
        return self.fn("LGBM_DatasetSetField")(
            ds, self.s(name), self.ptr(arr), len(arr), dtype_code)

    def get_field(self, ds, name):
        n, t, p = self.out("int"), self.out("int"), self.handle()
        self.ok(self.fn("LGBM_DatasetGetField")(
            ds, self.s(name), self.ref(n), self.ref(p), self.ref(t)))
        dt = np.dtype(cs_dtype(self.value(t)))
        count = self.value(n)
        addr = self.address(self.value(p))
        raw = ctypes.string_at(addr, count * dt.itemsize)
        return np.frombuffer(raw, dt).copy()

    def count(self, name, handle, ctype="int"):
        out = self.out(ctype)
        self.ok(self.fn(name)(handle, self.ref(out)))
        return self.value(out)

    def free_dataset(self, ds):
        self.ok(self.fn("LGBM_DatasetFree")(ds))

    def booster(self, ds, params):
        h = self.handle()
        self.ok(self.fn("LGBM_BoosterCreate")(ds, self.s(params),
                                              self.ref(h)))
        return self.value(h)

    def booster_from_string(self, text):
        n, h = self.out("int"), self.handle()
        self.ok(self.fn("LGBM_BoosterLoadModelFromString")(
            self.s(text), self.ref(n), self.ref(h)))
        return self.value(h)

    def update(self, b):
        fin = self.out("int")
        self.ok(self.fn("LGBM_BoosterUpdateOneIter")(b, self.ref(fin)))
        return self.value(fin)

    def get_eval(self, b, data_idx):
        res = np.zeros(8, np.float64)
        n = self.out("int")
        self.ok(self.fn("LGBM_BoosterGetEval")(
            b, data_idx, self.ref(n), self.typed(res, "double")))
        return res[:self.value(n)].copy()

    def strings(self, name, handle, count):
        bufs, arr = self.string_buffers(count)
        n = self.out("int")
        self.ok(self.fn(name)(handle, self.ref(n), arr))
        return [self.read_string(b) for b in bufs[:self.value(n)]]

    def model_string(self, b, num_iteration=-1, name=
                     "LGBM_BoosterSaveModelToString"):
        n = self.out("int")
        self.ok(self.fn(name)(b, num_iteration, 0, self.ref(n),
                              self.null))
        buf = np.zeros(self.value(n), np.uint8)
        self.ok(self.fn(name)(b, num_iteration, len(buf), self.ref(n),
                              self.ptr(buf)))
        return buf[:-1].tobytes().decode()

    def predict_mat(self, b, X, predict_type=NORMAL, num_iteration=-1,
                    row_major=True):
        X = np.ascontiguousarray(X, np.float64)
        out = np.zeros(X.shape[0] * self.per_row(b, predict_type,
                                                 num_iteration))
        data = X if row_major else np.ascontiguousarray(X.T)
        n = self.out("int64_t")
        self.ok(self.fn("LGBM_BoosterPredictForMat")(
            b, self.ptr(data), F64, X.shape[0], X.shape[1], int(row_major),
            predict_type, num_iteration, self.ref(n),
            self.typed(out, "double")))
        assert self.value(n) == len(out)
        return out

    def predict_csr(self, b, X, predict_type=NORMAL, ip_type=I32,
                    data_type=F64):
        csr = sp.csr_matrix(X)
        ip = csr.indptr.astype(np.int32 if ip_type == I32 else np.int64)
        data = csr.data.astype(np.float32 if data_type == F32
                               else np.float64)
        idx = csr.indices.astype(np.int32)
        out = np.zeros(X.shape[0] * self.per_row(b, predict_type, -1))
        n = self.out("int64_t")
        self.ok(self.fn("LGBM_BoosterPredictForCSR")(
            b, self.ptr(ip), ip_type, self.typed(idx, "int32_t"),
            self.ptr(data), data_type, len(ip), csr.nnz, X.shape[1],
            predict_type, -1, self.ref(n), self.typed(out, "double")))
        return out

    def predict_csc(self, b, X, predict_type=NORMAL, ip_type=I32,
                    data_type=F64):
        csc = sp.csc_matrix(X)
        cp = csc.indptr.astype(np.int32 if ip_type == I32 else np.int64)
        data = csc.data.astype(np.float32 if data_type == F32
                               else np.float64)
        idx = csc.indices.astype(np.int32)
        out = np.zeros(X.shape[0] * self.per_row(b, predict_type, -1))
        n = self.out("int64_t")
        self.ok(self.fn("LGBM_BoosterPredictForCSC")(
            b, self.ptr(cp), ip_type, self.typed(idx, "int32_t"),
            self.ptr(data), data_type, len(cp), csc.nnz, X.shape[0],
            predict_type, -1, self.ref(n), self.typed(out, "double")))
        return out

    def per_row(self, b, predict_type, num_iteration):
        n = self.out("int64_t")
        self.ok(self.fn("LGBM_BoosterCalcNumPredict")(
            b, 1, predict_type, num_iteration, self.ref(n)))
        return self.value(n)

    def train(self, X, y, params, rounds, valid=None):
        """Dataset, label, booster (and a valid set on the training
        mappers), ``rounds`` updates; the booster and each round's
        valid metrics."""
        ds = self.dataset_from_mat(X, params)
        self.ok(self.set_field(ds, "label", y, F32))
        b = self.booster(ds, params)
        evals = []
        if valid is not None:
            vs = self.dataset_from_mat(valid[0], params, ref=ds)
            self.ok(self.set_field(vs, "label", valid[1], F32))
            self.ok(self.fn("LGBM_BoosterAddValidData")(b, vs))
        for _ in range(rounds):
            self.update(b)
            if valid is not None:
                evals.append(self.get_eval(b, 1))
        return b, np.asarray(evals)


def cs_dtype(code):
    return {F32: np.float32, F64: np.float64, I32: np.int32,
            I64: np.int64}[int(code)]


class PortApi(Api):
    """The port's library through ``ctypes`` (prototypes from
    ``cdef.declare``)."""

    def __init__(self, lib):
        self.lib = lib
        self.null = None

    def fn(self, name):
        return getattr(self.lib, name)

    def error(self):
        return self.lib.LGBM_GetLastError().decode()

    def ptr(self, arr):
        return arr.ctypes.data

    def typed(self, arr, ctype):
        return arr.ctypes.data_as(ctypes.POINTER(
            cdef.ctypes_of(ctype)))

    def s(self, text):
        return text.encode() if isinstance(text, str) else text

    def h(self, handle):
        return handle

    def handle(self):
        return ctypes.c_void_p()

    def out(self, ctype):
        return cdef.ctypes_of(ctype)()

    def ref(self, obj):
        return ctypes.byref(obj)

    def value(self, obj):
        return obj.value

    def address(self, value):
        return value

    def string_buffers(self, count):
        bufs = [ctypes.create_string_buffer(255) for _ in range(count)]
        return bufs, (ctypes.c_char_p * count)(*map(ctypes.addressof,
                                                    bufs))

    def read_string(self, buf):
        return buf.value.decode()


class JaxApi(Api):
    """The JAX package's ``capi.impl`` in-process through ``cffi``."""

    def __init__(self):
        from lightgbm_tpu.capi import impl as jax_impl
        self.ffi = cffi.FFI()
        jax_impl.bind(self.ffi, register_externs=False)
        self.impl = jax_impl
        self.null = self.ffi.NULL

    def fn(self, name):
        return getattr(self.impl, name)

    def error(self):
        return self.ffi.string(self.impl.LGBM_GetLastError()).decode()

    def ptr(self, arr):
        return self.ffi.cast("void *", arr.ctypes.data)

    def typed(self, arr, ctype):
        return self.ffi.cast(ctype + " *", arr.ctypes.data)

    def s(self, text):
        return self.ffi.new("char[]", text.encode() if isinstance(
            text, str) else text)

    def h(self, handle):
        return self.null if handle is None else handle

    def handle(self):
        return self.ffi.new("void **")

    def out(self, ctype):
        return self.ffi.new(ctype + " *")

    def ref(self, obj):
        return obj

    def value(self, obj):
        return obj[0]

    def address(self, value):
        return int(self.ffi.cast("uintptr_t", value))

    def string_buffers(self, count):
        bufs = [self.ffi.new("char[255]") for _ in range(count)]
        return bufs, self.ffi.new("char *[]", bufs)

    def read_string(self, buf):
        return self.ffi.string(buf).decode()


# ---------------------------------------------------------------------------
# fixtures


@pytest.fixture(scope="module")
def lib_path():
    return capi_build.build_library()


@pytest.fixture(scope="module")
def port(lib_path):
    lib = ctypes.CDLL(lib_path)
    cdef.declare(lib)
    return PortApi(lib)


@pytest.fixture(scope="module")
def jax():
    return JaxApi()


@pytest.fixture(scope="module")
def data():
    tr, te = np.loadtxt(TRAIN_FILE), np.loadtxt(TEST_FILE)
    return (tr[:, 1:], tr[:, 0].astype(np.float32), te[:, 1:],
            te[:, 0].astype(np.float32))


@pytest.fixture(scope="module")
def port_run(port, data):
    X, y, Xt, yt = data
    b, evals = port.train(X, y, f"{PARAMS} {CPU}", ROUNDS, valid=(Xt, yt))
    return b, evals


@pytest.fixture(scope="module")
def jax_run(jax, data):
    X, y, Xt, yt = data
    b, evals = jax.train(X, y, PARAMS, ROUNDS, valid=(Xt, yt))
    return b, evals


# ---------------------------------------------------------------------------
# the port's copies of the JAX package's tables (parity guards)


def test_cdef_and_api_names_equal_jax():
    assert cdef.CDEF == jax_cdef.CDEF
    assert cdef.API_NAMES == jax_cdef.API_NAMES
    assert len(cdef.API_NAMES) == 48 == len(set(cdef.API_NAMES))


def test_signature_table_and_the_shim_follow_cdef():
    """Every name parsed, each ctypes prototype of the arity of its C
    declaration, the shim's forwarders declared with CDEF's types and its
    table slots in API_NAMES order."""
    assert list(cdef.SIGNATURES) == cdef.API_NAMES
    declared = dict(re.findall(r"(LGBM_\w+)\(([^)]*)\);", cdef.CDEF))
    for name, (ret, args) in cdef.SIGNATURES.items():
        arity = len([a for a in declared[name].split(",") if a.strip()])
        assert len(args) == arity, name
        proto = ctypes.CFUNCTYPE(cdef.ctypes_of(ret),
                                 *[cdef.ctypes_of(a) for a in args])
        assert len(proto._argtypes_) == arity, name
    src = (REPO / "lightgbm_tpu_torch" / "capi" / "c_api.c").read_text()
    shim = {}
    for ret, name, args in re.findall(
            r"EXPORT\s+([\w\s\*]+?)\s*(LGBM_\w+)\(([^)]*)\)\s*\{", src):
        ret = " ".join(ret.split()).replace(" *", "*")
        types = [cdef._arg_type(a) for a in args.split(",")
                 if a.strip() and a.strip() != "void"]
        shim[name] = (ret, types)
    for name in cdef.API_NAMES:
        assert shim[name] == cdef.SIGNATURES[name], name
    assert set(shim) - set(cdef.API_NAMES) == {"LGBM_TorchSetLastError",
                                               "LGBM_TorchBind"}
    slots = re.findall(r"^\s*K_(LGBM_\w+),", src, re.M)
    assert slots == cdef.API_NAMES


def test_c_sources_name_no_module_of_the_jax_package():
    sources = sorted((REPO / "lightgbm_tpu_torch").rglob("*.c"))
    assert {p.name for p in sources} >= {"c_api.c", "demo.c"}
    for path in sources:
        hits = re.findall(r"(?<![\w])lightgbm_tpu(?!_torch)[\w./]*",
                          path.read_text())
        assert not hits, f"{path.name} names {hits}"


# ---------------------------------------------------------------------------
# the library


def test_every_symbol_resolves_and_the_shim_took_47_callbacks(port,
                                                              lib_path):
    for name in cdef.API_NAMES:
        assert getattr(port.lib, name) is not None
    # a call on a NULL handle boots, if nothing has yet, and fails
    assert port.fn("LGBM_DatasetGetNumData")(
        None, ctypes.byref(ctypes.c_int())) == -1
    # LGBM_GetLastError never enters Python: 47 callbacks for 48 names
    assert impl.bind_library(lib_path) == 47
    assert set(impl._callbacks[lib_path]) == set(cdef.API_NAMES) - {
        "LGBM_GetLastError"}
    bind = port.lib.LGBM_TorchBind
    bind.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]
    assert bind((ctypes.c_void_p * 3)(), 3) == -1


BOOT_FAILS = r"""
import ctypes, json, sys, threading
lib = ctypes.CDLL(sys.argv[1])
lib.LGBM_GetLastError.restype = ctypes.c_char_p
n = ctypes.c_int()
seen = [(lib.LGBM_DatasetGetNumData(None, ctypes.byref(n)),
         lib.LGBM_GetLastError().decode())]
t = threading.Thread(target=lambda: seen.append(
    (lib.LGBM_BoosterGetNumClasses(None, ctypes.byref(n)),
     lib.LGBM_GetLastError().decode())))
t.start()
t.join(30)
print(json.dumps(seen))
"""


def test_a_failed_boot_fails_every_call_by_name(tmp_path):
    """A library whose boot cannot import the port (its baked sys.path
    names no checkout, the host runs isolated from the repo) returns -1
    from every call, on every thread, with the boot's error."""
    lib = tmp_path / "lib_boot_fails.so"
    subprocess.run(
        [capi_build.compiler(), *capi_build.CFLAGS,
         "-DLGBM_TORCH_BOOT_PATHS=\"['/nonexistent']\"", "-o", str(lib),
         str(capi_build.SOURCE), *capi_build.LDFLAGS], check=True)
    proc = subprocess.run([sys.executable, "-I", "-c", BOOT_FAILS,
                           str(lib)], capture_output=True, text=True,
                          timeout=60, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    assert [rc for rc, _ in seen] == [-1, -1]
    for _, msg in seen:
        assert msg.startswith("C API boot failed: ModuleNotFoundError"), msg
        assert "lightgbm_tpu_torch" in msg


def test_build_is_cached_and_refuses_without_a_compiler(lib_path,
                                                        monkeypatch):
    assert capi_build.build_library() == lib_path
    assert Path(lib_path).parent == REPO / "lightgbm_tpu_torch" / "build"
    monkeypatch.setenv("CC", "no-such-compiler")
    monkeypatch.setenv("PATH", "")
    with pytest.raises(lt.LightGBMError, match="no C compiler"):
        capi_build.compiler()


# ---------------------------------------------------------------------------
# JAX's four scenarios (tests/c_api_worker.py), on the repo's example files


def test_error_reporting_like_jax(port, jax, tmp_path):
    missing = str(tmp_path / "no_such_file.txt")
    for api in (port, jax):
        h = api.handle()
        rc = api.fn("LGBM_DatasetCreateFromFile")(
            api.s(missing), api.s(""), api.null, api.ref(h))
        assert rc == -1
        assert "no_such_file.txt" in api.error()


def test_push_rows_like_jax(port, jax):
    """CreateFromSampledColumn + PushRows in two chunks: the port's bins
    and one round's raw predictions bit-equal to its CreateFromMat, and
    within PRED_ATOL of JAX's."""
    rng = np.random.RandomState(7)
    X = rng.normal(size=(400, 3)).astype(np.float64)
    y = (X[:, 0] > 0).astype(np.float32)
    dparams = "max_bin=31 min_data_in_leaf=5"
    bparams = "objective=binary num_leaves=7 verbose=-1 min_data_in_leaf=5"
    preds = {}
    for name, api, extra in (("port", port, f" {CPU}"), ("jax", jax, "")):
        cols = [np.ascontiguousarray(X[:, i]) for i in range(3)]
        idxs = [np.arange(400, dtype=np.int32) for _ in range(3)]
        num_per_col = np.full(3, 400, np.int32)
        if api is port:
            col_ptrs = (ctypes.POINTER(ctypes.c_double) * 3)(
                *[c.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
                  for c in cols])
            idx_ptrs = (ctypes.POINTER(ctypes.c_int) * 3)(
                *[i.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
                  for i in idxs])
        else:
            col_ptrs = api.ffi.new("double *[]", [
                api.ffi.cast("double *", c.ctypes.data) for c in cols])
            idx_ptrs = api.ffi.new("int *[]", [
                api.ffi.cast("int *", i.ctypes.data) for i in idxs])
        h = api.handle()
        api.ok(api.fn("LGBM_DatasetCreateFromSampledColumn")(
            col_ptrs, idx_ptrs, 3, api.typed(num_per_col, "int"), 400,
            400, api.s(dparams), api.ref(h)))
        pushed = api.value(h)
        for start, stop in ((0, 250), (250, 400)):
            chunk = np.ascontiguousarray(X[start:stop])
            api.ok(api.fn("LGBM_DatasetPushRows")(
                pushed, api.ptr(chunk), F64, stop - start, 3, start))
        api.ok(api.set_field(pushed, "label", y, F32))
        direct = api.dataset_from_mat(X, dparams)
        api.ok(api.set_field(direct, "label", y, F32))
        out = []
        for ds in (pushed, direct):
            b = api.booster(ds, bparams + extra)
            api.update(b)
            out.append(api.predict_mat(b, X, RAW))
        preds[name] = out
        if api is port:
            np.testing.assert_array_equal(_binned(port, pushed).bins,
                                          _binned(port, direct).bins)
    np.testing.assert_array_equal(preds["port"][0], preds["port"][1])
    np.testing.assert_allclose(preds["port"][0], preds["jax"][0], rtol=0,
                               atol=PRED_ATOL)


def test_dataset_io_like_jax(port, jax, data, tmp_path):
    """From the file, from a matrix, CSR and CSC on the training
    mappers, and a binary file round trip: the same counts as JAX's, the
    same bins and labels."""
    _, _, Xt, yt = data
    counts = {}
    for name, api in (("port", port), ("jax", jax)):
        train = api.dataset_from_file(TRAIN_FILE, "max_bin=15")
        got = [api.count("LGBM_DatasetGetNumData", train),
               api.count("LGBM_DatasetGetNumFeature", train)]
        for make in (api.dataset_from_mat, api.dataset_from_csr,
                     api.dataset_from_csc):
            h = make(Xt, "max_bin=15", ref=train)
            got.append(api.count("LGBM_DatasetGetNumData", h))
            api.free_dataset(h)
        label = api.get_field(train, "label")
        path = str(tmp_path / f"{name}.bin")
        api.ok(api.fn("LGBM_DatasetSaveBinary")(train, api.s(path)))
        api.free_dataset(train)
        again = api.dataset_from_file(path, "max_bin=15")
        got.append(api.count("LGBM_DatasetGetNumData", again))
        counts[name] = (got, label, _binned(api, again).bins)
    assert counts["port"][0] == counts["jax"][0] == [5000, 28, 2000, 2000,
                                                     2000, 5000]
    np.testing.assert_array_equal(counts["port"][1], counts["jax"][1])
    np.testing.assert_array_equal(counts["port"][2], counts["jax"][2])


def _binned(api, ds):
    if isinstance(api, JaxApi):
        return api.impl._handles[int(api.ffi.cast("uintptr_t",
                                                  ds))].binned
    return impl._handles[ds].binned


def test_train_predict_like_jax(port, jax, port_run, jax_run, data,
                                tmp_path):
    """The reference's training flow: counts, eval names, every round's
    valid AUC, the trees, and predictions from a matrix, CSR and CSC,
    leaf indices, and a file."""
    X, y, Xt, yt = data
    (pb, pe), (jb, je) = port_run, jax_run
    for name in ("LGBM_BoosterGetCurrentIteration",
                 "LGBM_BoosterGetEvalCounts", "LGBM_BoosterGetNumClasses",
                 "LGBM_BoosterGetNumFeature"):
        assert port.count(name, pb) == jax.count(name, jb), name
    assert port.count("LGBM_BoosterGetCurrentIteration", pb) == ROUNDS
    assert port.strings("LGBM_BoosterGetEvalNames", pb, 1) == \
        jax.strings("LGBM_BoosterGetEvalNames", jb, 1) == ["auc"]
    assert port.strings("LGBM_BoosterGetFeatureNames", pb, 28) == \
        jax.strings("LGBM_BoosterGetFeatureNames", jb, 28)
    trees, flip, _ = cs.compare_model_texts(
        port.model_string(pb), jax.model_string(jb), "capi train",
        names=("torch", "jax"), tie_rtol=TIE_RTOL, leaf_rtol=LEAF_RTOL)
    assert flip is None and trees == ROUNDS
    np.testing.assert_allclose(pe, je, rtol=0, atol=1e-6)
    for how in ("predict_mat", "predict_csr", "predict_csc"):
        np.testing.assert_allclose(getattr(port, how)(pb, Xt),
                                   getattr(jax, how)(jb, Xt), rtol=0,
                                   atol=PRED_ATOL, err_msg=how)
    np.testing.assert_array_equal(port.predict_mat(pb, Xt[:5], LEAF),
                                  jax.predict_mat(jb, Xt[:5], LEAF))
    out = str(tmp_path / "pred.txt")
    port.ok(port.fn("LGBM_BoosterPredictForFile")(
        pb, port.s(TEST_FILE), 0, NORMAL, -1, port.s(out)))
    np.testing.assert_allclose(np.loadtxt(out), port.predict_mat(pb, Xt),
                               rtol=0, atol=FILE_ATOL)


# ---------------------------------------------------------------------------
# the port's C API against its Python API


def _label_hist_free(text):
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith("label_hist="))


def test_model_text_byte_equal_to_the_python_booster(port, jax, port_run,
                                                     jax_run, data):
    """The C API's model text is the Python Booster's, byte for byte,
    but for the fingerprint's ``label_hist`` line: the C API sets the
    label after the dataset is built (``LGBM_DatasetSetField``), so its
    fingerprint has no label histogram.  JAX's two routes differ on that
    line in the same way.  Predictions bit-equal."""
    X, y, Xt, yt = data
    params = {"objective": "binary", "metric": "auc", "num_leaves": 15,
              "max_bin": 63, "verbose": -1}
    bst = lt.Booster(params=params, train_set=lt.Dataset(
        X, y, params=params), device="cpu")
    jbst = lgb.Booster(params=params, train_set=lgb.Dataset(
        X, y, params=params))
    for _ in range(ROUNDS):
        bst.update()
        jbst.update()
    texts = {"port": (port.model_string(port_run[0]),
                      bst.model_to_string()),
             "jax": (jax.model_string(jax_run[0]),
                     jbst.model_to_string())}
    for name, (c_text, py_text) in texts.items():
        c_lines, py_lines = c_text.splitlines(), py_text.splitlines()
        extra = [ln for ln in py_lines if ln not in c_lines]
        assert [ln.split("=")[0] for ln in extra] == ["label_hist"], name
        assert _label_hist_free(c_text) == _label_hist_free(py_text), name
    np.testing.assert_array_equal(port.predict_mat(port_run[0], Xt),
                                  bst.predict(Xt))
    # the same route on both sides: the label set after construction
    ds = lt.Dataset(X, params=params)
    ds.construct().set_label(y)
    late = lt.Booster(params=params, train_set=ds, device="cpu")
    late.add_valid(ds.create_valid(Xt, yt), "valid")
    for _ in range(ROUNDS):
        late.update()
    assert texts["port"][0] == late.model_to_string()


def test_c_program_boots_the_interpreter_and_writes_the_same_model(
        port, data, tmp_path):
    """demo.c, compiled against nothing but dlopen, trains 5 rounds and
    predicts the test rows in a process that is not Python (its first
    call boots the interpreter through Py_InitializeEx): its model file
    and predictions equal this process's run of the same calls."""
    X, y, Xt, yt = data
    train, test = tmp_path / "train.f64", tmp_path / "test.f64"
    np.column_stack([y, X]).astype(np.float64).tofile(train)
    np.column_stack([yt, Xt]).astype(np.float64).tofile(test)
    params = f"{PARAMS} {CPU}"
    model, pred = tmp_path / "model.txt", tmp_path / "pred.f64"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [capi_build.build_demo(), capi_build.build_library(), str(train),
         str(test), "28", params, "5", str(model), str(pred)],
        capture_output=True, text=True, timeout=DEMO_TIMEOUT_S, env=env,
        cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["iteration"] == 5 and report["test_rows"] == 2000
    b, _ = port.train(X, y, params, 5)
    assert model.read_text() == port.model_string(b)
    np.testing.assert_array_equal(np.fromfile(pred, np.float64),
                                  port.predict_mat(b, Xt))


# ---------------------------------------------------------------------------
# every argument form


@pytest.mark.parametrize("code", [F32, F64, I32, I64])
def test_set_field_and_get_field_take_every_dtype(port, jax, data, code):
    X, y, _, _ = data
    got = {}
    for name, api in (("port", port), ("jax", jax)):
        ds = api.dataset_from_mat(X[:600], "max_bin=15")
        api.ok(api.set_field(ds, "label", y[:600], code))
        api.ok(api.set_field(ds, "weight", np.arange(600) % 3 + 1, code))
        api.ok(api.set_field(ds, "group", np.full(6, 100), code))
        got[name] = [api.get_field(ds, f) for f in ("label", "weight",
                                                     "group")]
        api.free_dataset(ds)
    for a, b in zip(got["port"], got["jax"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got["port"][0], y[:600])
    np.testing.assert_array_equal(got["port"][2], np.arange(7) * 100)


@pytest.mark.parametrize("ip_type,data_type", [(I32, F64), (I64, F64),
                                               (I32, F32), (I64, F32)])
def test_csr_and_csc_take_both_index_and_value_types(port, port_run, data,
                                                     ip_type, data_type):
    """CSR and CSC indptr as int32 or int64 and values as f32 or f64:
    the same bins as the dense matrix, and the same predictions as the
    dense matrix rounded the same way."""
    X, _, Xt, _ = data
    ref = port.dataset_from_mat(X, "max_bin=63")
    rows = Xt[:300].astype(cs_dtype(data_type)).astype(np.float64)
    want = _binned(port, port.dataset_from_mat(rows, "", ref=ref)).bins
    for make in (port.dataset_from_csr, port.dataset_from_csc):
        h = make(Xt[:300], "", ref=ref, ip_type=ip_type,
                 data_type=data_type)
        np.testing.assert_array_equal(_binned(port, h).bins, want)
        port.free_dataset(h)
    dense = port.predict_mat(port_run[0], rows)
    for how in (port.predict_csr, port.predict_csc):
        np.testing.assert_array_equal(
            how(port_run[0], Xt[:300], ip_type=ip_type,
                data_type=data_type), dense)


def test_column_major_matrix(port, port_run, data):
    X, _, Xt, _ = data
    row = port.dataset_from_mat(X[:800], "max_bin=15")
    col = port.dataset_from_mat(X[:800], "max_bin=15", row_major=False)
    np.testing.assert_array_equal(_binned(port, row).bins,
                                  _binned(port, col).bins)
    np.testing.assert_array_equal(
        port.predict_mat(port_run[0], Xt, row_major=False),
        port.predict_mat(port_run[0], Xt))


def test_save_model_to_string_with_a_small_buffer(port, port_run):
    b = port_run[0]
    text = port.model_string(b)
    n = ctypes.c_int()
    buf = ctypes.create_string_buffer(b"\x7f" * 64, 64)
    port.ok(port.lib.LGBM_BoosterSaveModelToString(
        b, -1, 64, ctypes.byref(n), buf))
    assert n.value == len(text.encode()) + 1
    assert buf.raw == b"\x7f" * 64


def test_dump_model_equals_jax(port, jax, jax_run):
    """The same model text loaded in both packages dumps the same
    JSON."""
    text = jax.model_string(jax_run[0])
    dumps = [json.loads(api.model_string(api.booster_from_string(text),
                                         name="LGBM_BoosterDumpModel"))
             for api in (port, jax)]
    assert dumps[0] == dumps[1]
    assert len(dumps[0]["tree_info"]) == ROUNDS


def test_leaf_value_round_trip_and_a_predict_after_set_sees_it(port, data):
    """Get/SetLeafValue round-trip; a predict after SetLeafValue walks
    the new value (the frozen forest is dropped): raw scores change by
    the difference exactly where that leaf is reached, nowhere else."""
    X, y, Xt, _ = data
    b, _ = port.train(X, y, f"{PARAMS} {CPU}", 3)
    before = port.predict_mat(b, Xt, RAW)
    leaves = port.predict_mat(b, Xt, LEAF).reshape(len(Xt), -1)
    tree, leaf = 1, int(np.bincount(leaves[:, 1].astype(int)).argmax())
    old = ctypes.c_double()
    port.ok(port.lib.LGBM_BoosterGetLeafValue(b, tree, leaf,
                                              ctypes.byref(old)))
    new = old.value + 0.5
    port.ok(port.lib.LGBM_BoosterSetLeafValue(b, tree, leaf, new))
    got = ctypes.c_double()
    port.ok(port.lib.LGBM_BoosterGetLeafValue(b, tree, leaf,
                                              ctypes.byref(got)))
    assert got.value == new
    after = port.predict_mat(b, Xt, RAW)
    hit = leaves[:, tree] == leaf
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(after[~hit], before[~hit])
    np.testing.assert_allclose(after[hit] - before[hit], 0.5, rtol=0,
                               atol=1e-6)


def test_merge_refuses_a_width_mismatch_like_jax(port, jax, data):
    X, y, _, _ = data
    errors = []
    for api, extra in ((port, f" {CPU}"), (jax, "")):
        narrow, _ = api.train(X[:, :20], y, PARAMS + extra, 1)
        wide, _ = api.train(X, y, PARAMS + extra, 1)
        assert api.fn("LGBM_BoosterMerge")(wide, narrow) == -1
        errors.append(api.error())
    assert all("feature width mismatch" in e for e in errors), errors


def test_rollback_then_predict_equals_the_previous_iteration(port, data):
    X, y, Xt, _ = data
    b, _ = port.train(X, y, f"{PARAMS} {CPU}", 4)
    at3 = port.predict_mat(b, Xt, num_iteration=3)
    full = port.predict_mat(b, Xt)
    port.ok(port.lib.LGBM_BoosterRollbackOneIter(b))
    assert port.count("LGBM_BoosterGetCurrentIteration", b) == 3
    rolled = port.predict_mat(b, Xt)
    np.testing.assert_array_equal(rolled, at3)
    assert not np.array_equal(rolled, full)


# ---------------------------------------------------------------------------
# errors


@pytest.mark.parametrize("case", ["bad_handle", "missing_file",
                                  "unknown_field"])
def test_a_failed_call_returns_minus_one_with_a_message(port, tmp_path,
                                                        case):
    if case == "bad_handle":
        rc, want = port.fn("LGBM_DatasetGetNumData")(
            12345678, ctypes.byref(ctypes.c_int())), "Invalid handle"
    elif case == "missing_file":
        h = ctypes.c_void_p()
        rc, want = port.fn("LGBM_BoosterCreateFromModelfile")(
            str(tmp_path / "gone.txt").encode(),
            ctypes.byref(ctypes.c_int()), ctypes.byref(h)), "gone.txt"
    else:
        ds = port.dataset_from_mat(np.eye(30), "")
        rc, want = port.set_field(ds, "colour", np.zeros(30), F64), \
            "Unknown field name 'colour'"
    assert rc == -1
    assert want in port.error()


def test_last_error_is_per_thread(port):
    barrier = threading.Barrier(2, timeout=30)
    seen = {}

    def worker(k):
        port.fn("LGBM_DatasetGetNumData")(1000000 + k,
                                          ctypes.byref(ctypes.c_int()))
        barrier.wait()      # both failed before either reads
        seen[k] = port.error()

    threads = [threading.Thread(target=worker, args=(k,)) for k in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert seen == {1: "_CApiError: Invalid handle 1000001",
                    2: "_CApiError: Invalid handle 1000002"}


@pytest.mark.parametrize("device", ["device=cuda", ""])
def test_booster_create_without_device_cpu_names_the_missing_card(
        port, data, device):
    X, y, _, _ = data
    ds = port.dataset_from_mat(X[:500], "max_bin=15")
    port.ok(port.set_field(ds, "label", y[:500], F32))
    h = ctypes.c_void_p()
    assert port.fn("LGBM_BoosterCreate")(
        ds, f"objective=binary {device}".encode(), ctypes.byref(h)) == -1
    assert "no CUDA device is available" in port.error()


def test_a_loaded_model_predicts_only_once_asked_for_the_host(port, jax,
                                                              jax_run,
                                                              data):
    _, _, Xt, _ = data
    text = jax.model_string(jax_run[0])
    b = port.booster_from_string(text)
    out = np.zeros(len(Xt))
    n = ctypes.c_int64()
    rc = port.fn("LGBM_BoosterPredictForMat")(
        b, Xt.ctypes.data, F64, len(Xt), 28, 1, NORMAL, -1,
        ctypes.byref(n), port.typed(out, "double"))
    assert rc == -1 and "no CUDA device is available" in port.error()
    port.ok(port.fn("LGBM_BoosterResetParameter")(b, CPU.encode()))
    np.testing.assert_allclose(port.predict_mat(b, Xt),
                               jax.predict_mat(jax_run[0], Xt), rtol=0,
                               atol=PRED_ATOL)


def test_reset_parameter_refuses_device_on_a_training_booster(port,
                                                              port_run):
    assert port.fn("LGBM_BoosterResetParameter")(
        port_run[0], b"device=cuda") == -1
    assert "cannot change device" in port.error()


def test_update_one_iter_custom_matches_the_python_fobj(port, data):
    """Host f32 gradients through LGBM_BoosterUpdateOneIterCustom grow
    the Python ``update(fobj=...)`` trees."""
    X, y, _, _ = data
    params = "objective=none num_leaves=7 max_bin=15 verbose=-1"
    ds = port.dataset_from_mat(X, params)
    port.ok(port.set_field(ds, "label", y, F32))
    b = port.booster(ds, f"{params} {CPU}")
    grad = np.ascontiguousarray(0.5 - y, np.float32)
    hess = np.full(len(y), 0.25, np.float32)
    fin = ctypes.c_int()
    for _ in range(2):
        port.ok(port.fn("LGBM_BoosterUpdateOneIterCustom")(
            b, port.typed(grad, "float"), port.typed(hess, "float"),
            ctypes.byref(fin)))
    pyds = lt.Dataset(X, params={"max_bin": 15})
    pyds.construct().set_label(y)
    bst = lt.Booster(params={"objective": "none", "num_leaves": 7,
                             "max_bin": 15, "verbose": -1},
                     train_set=pyds, device="cpu")
    for _ in range(2):
        bst.update(fobj=lambda preds, _: (grad, hess))
    assert port.model_string(b) == bst.model_to_string()


# ---------------------------------------------------------------------------
# a Booster max_bin below its dataset's (ROADMAP Queue C item 2)


def test_a_narrower_booster_max_bin_is_refused_where_jax_trains(port, jax,
                                                                data):
    """The dataset binned with max_bin=255, the Booster asking for 31:
    JAX's C API trains (bins past 31 fall out of its histograms); the
    port refuses by name, through the C API and the Python Booster."""
    X, y, _, _ = data
    for api, extra in ((port, f" {CPU}"), (jax, "")):
        ds = api.dataset_from_mat(X, "max_bin=255")
        api.ok(api.set_field(ds, "label", y, F32))
        h = api.handle()
        rc = api.fn("LGBM_BoosterCreate")(
            ds, api.s("objective=binary max_bin=31 verbose=-1" + extra),
            api.ref(h))
        if api is jax:
            assert rc == 0
            assert api.update(api.value(h)) == 0
        else:
            assert rc == -1
            assert "max_bin=255" in api.error() and \
                "max_bin=31" in api.error()
    built = lt.Dataset(X, y).construct()
    with pytest.raises(lt.LightGBMError, match="max_bin=255.*max_bin=31"):
        lt.Booster(params={"objective": "binary", "max_bin": 31},
                   train_set=built, device="cpu")
