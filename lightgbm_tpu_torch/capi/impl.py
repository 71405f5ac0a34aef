"""The functions behind the LGBM_* symbols of the port's C API.

Each function implements one entry point of the reference ``c_api.h``
(``cdef.py``) with the semantics of the reference ``src/c_api.cpp``, as
the JAX package's ``capi/impl.py`` does: the handle registry, the 0/-1
return convention with a thread-local last error, GetPredictAt's
sigmoid/softmax transform, SaveModelToString's ``buffer_len``/``out_len``
re-allocation protocol.  They are backed by the port's ``io/`` and
``models/``.

The library (``c_api.c``, built by ``build.py``) calls them through
``ctypes`` callbacks: ``bind_library(path)`` makes one ``CFUNCTYPE``
callback per entry point from ``cdef.SIGNATURES`` and hands their
addresses to the library's ``LGBM_TorchBind``.  Arguments arrive as
``ctypes`` values: addresses as ints (or None for NULL), typed pointers
as ``ctypes`` pointers.  ``LGBM_GetLastError`` stays in C; a failed call
writes its message there through ``LGBM_TorchSetLastError``.

The device: ``LGBM_BoosterCreate`` trains on ``Config(params).device``
(default ``cuda``; with no card that is a named error, never the host).
A booster loaded from a model file or string resolves its device at its
first predict, from its parameters: ``LGBM_BoosterResetParameter(h,
"device=cpu")`` asks for the host.  Predictions of scores walk the
forest-walk kernel (``serve/forest.py`` ``CompiledForest``), cached by
``num_iteration`` and dropped by every call that changes the trees;
leaf indices take the f64 host walk, as in both packages' ``Booster``.
"""

from __future__ import annotations

import ctypes
import json
import threading
from typing import Dict, List, Optional

import numpy as np

from ..config import Config, apply_aliases
from ..device import resolve_device
from ..io.binning import NUMERICAL, BinMapper
from ..io.dataset import BinnedDataset, Metadata
from ..io.parser import parse_file
from ..models import create_boosting
from ..models.gbdt import GBDT
from ..utils.log import LightGBMError
from .cdef import API_NAMES, SIGNATURES, ctypes_of

C_API_DTYPE_FLOAT32 = 0
C_API_DTYPE_FLOAT64 = 1
C_API_DTYPE_INT32 = 2
C_API_DTYPE_INT64 = 3

C_API_PREDICT_NORMAL = 0
C_API_PREDICT_RAW_SCORE = 1
C_API_PREDICT_LEAF_INDEX = 2

_NP_DTYPE = {C_API_DTYPE_FLOAT32: np.float32, C_API_DTYPE_FLOAT64: np.float64,
             C_API_DTYPE_INT32: np.int32, C_API_DTYPE_INT64: np.int64}

_handles: Dict[int, object] = {}
_next_id = [1]
_lock = threading.Lock()
# the bound libraries by path, with the callbacks each one calls (kept
# alive here as long as the process: the library holds their addresses)
_libs: Dict[str, ctypes.CDLL] = {}
_callbacks: Dict[str, Dict[str, object]] = {}


class _CApiError(Exception):
    pass


def _set_last_error(msg: str) -> None:
    """The message ``LGBM_GetLastError`` returns on the calling thread."""
    raw = msg.encode("utf-8", "replace")[:511]
    for lib in _libs.values():
        lib.LGBM_TorchSetLastError(raw)


def _register(obj) -> int:
    with _lock:
        hid = _next_id[0]
        _next_id[0] += 1
        _handles[hid] = obj
    return hid


def _from_handle(handle):
    hid = int(handle or 0)
    try:
        return _handles[hid]
    except KeyError:
        raise _CApiError(f"Invalid handle {hid}")


def _free_handle(handle) -> None:
    _handles.pop(int(handle or 0), None)


def _addr(ptr) -> int:
    """The address a pointer argument holds (0 for NULL)."""
    if ptr is None or isinstance(ptr, int):
        return int(ptr or 0)
    return ctypes.cast(ptr, ctypes.c_void_p).value or 0


def _str(char_p, default="") -> str:
    addr = _addr(char_p)
    if addr == 0:
        return default
    return ctypes.string_at(addr).decode("utf-8")


def _np_from_ptr(ptr, dtype_code: int, count: int) -> np.ndarray:
    """A copy of ``count`` values of the C type ``dtype_code`` at
    ``ptr``."""
    dt = np.dtype(_NP_DTYPE[int(dtype_code)])
    count = int(count)
    if count <= 0:
        return np.zeros(0, dt)
    addr = _addr(ptr)
    if addr == 0:
        raise _CApiError("NULL data pointer")
    buf = (ctypes.c_char * (count * dt.itemsize)).from_address(addr)
    return np.frombuffer(buf, dtype=dt).copy()


def _write_strings(out_strs, names: List[str]) -> None:
    """Each name, cut to 254 bytes and NUL-ended, into the caller's
    buffers ``out_strs[i]`` (the reference expects 255-byte ones)."""
    slots = ctypes.cast(out_strs, ctypes.POINTER(ctypes.c_void_p))
    for i, name in enumerate(names):
        raw = name.encode("utf-8")[:254] + b"\x00"
        ctypes.memmove(slots[i], raw, len(raw))


def _parse_params(parameters) -> Dict[str, str]:
    """key1=value1 key2=value2 (ConfigBase::Str2Map, config.cpp:15-28)."""
    out: Dict[str, str] = {}
    for tok in _str(parameters).replace("\n", " ").split():
        if "=" in tok:
            k, v = tok.split("=", 1)
            out[k.strip()] = v.strip()
    return out


# ---------------------------------------------------------------------------
# wrapper objects
# ---------------------------------------------------------------------------

class _CDataset:
    """DatasetHandle payload: a BinnedDataset, or a push-mode dataset being
    filled row-by-row (c_api.cpp push flows)."""

    def __init__(self, binned: BinnedDataset, params: Dict[str, str]):
        self.binned = binned
        self.params = params
        # GetField's arrays, alive while the caller reads them
        self.field_cache: Dict[str, np.ndarray] = {}

    # -- push-mode construction -----------------------------------------
    @classmethod
    def from_mappers(cls, mappers_per_real: List[Optional[BinMapper]],
                     num_total_row: int, max_bin: int,
                     params: Dict[str, str]) -> "_CDataset":
        """Empty dataset with pre-agreed mappers, to be filled by PushRows
        (Dataset::CreateValid-like allocation, c_api.cpp:341-415)."""
        ds = BinnedDataset()
        ds.num_total_features = len(mappers_per_real)
        ds.max_bin = max_bin
        ds.feature_names = [f"Column_{i}"
                            for i in range(ds.num_total_features)]
        ds.real_to_inner = np.full(ds.num_total_features, -1, dtype=np.int64)
        used, mappers = [], []
        for f, m in enumerate(mappers_per_real):
            if m is None or m.is_trivial:
                continue
            ds.real_to_inner[f] = len(used)
            used.append(f)
            mappers.append(m)
        ds.used_feature_map = used
        ds.mappers = mappers
        dtype = np.uint8 if max([m.num_bin for m in mappers] or [1]) <= 256 \
            else np.uint16
        ds.bins = np.zeros((len(used), num_total_row), dtype=dtype)
        ds.metadata = Metadata(num_total_row)
        ds.metadata.set_label(np.zeros(num_total_row, dtype=np.float32))
        return cls(ds, params)

    def push_rows(self, rows: np.ndarray, start_row: int) -> None:
        ds = self.binned
        if rows.shape[1] < ds.num_total_features:
            # a CSR chunk can be narrower than the dataset (trailing
            # all-zero columns absent); the reference treats the missing
            # columns as 0.0
            rows = np.pad(rows,
                          ((0, 0), (0, ds.num_total_features - rows.shape[1])))
        stop = start_row + rows.shape[0]
        for inner, f in enumerate(ds.used_feature_map):
            ds.bins[inner, start_row:stop] = ds.mappers[inner].value_to_bin(
                rows[:, f]).astype(ds.bins.dtype)
        # nrow + start_row == num_total_row triggers FinishLoad in the
        # reference; binning is already done per push here, so nothing more.


class _CBooster:
    """BoosterHandle payload (c_api.cpp Booster, :28-252), with the
    device it trains or predicts on (None until a loaded model's first
    predict) and the forest its predictions walk."""

    def __init__(self, booster: GBDT, config: Config, device=None):
        self.b = booster
        self.config = config
        self.device = device
        self.valid_handles: List[_CDataset] = []
        self._forest = None          # (num_iteration, CompiledForest)

    def trains(self) -> bool:
        return getattr(self.b, "train_set", None) is not None

    def trees_changed(self) -> None:
        """Drop the frozen forest: the next predict freezes the trees
        as they are now."""
        self._forest = None

    # eval name list shared by all datasets (Booster::GetEvalNames)
    def eval_names(self) -> List[str]:
        names: List[str] = []
        for m in getattr(self.b, "train_metrics", []):
            names.extend(m.names)
        return names

    def eval_at(self, data_idx: int) -> List[float]:
        # eval_set reads an f64 host copy of exactly num_data scores:
        # one device -> host copy a call
        key = "training" if data_idx == 0 else f"valid_{data_idx}"
        return [float(v) for _, v, _ in self.b.eval_set(key)]

    def predict_at(self, data_idx: int) -> np.ndarray:
        """GetPredictAt (gbdt.cpp:817-851): raw scores with the softmax /
        sigmoid output transform applied, class-major [num_class * n]."""
        b = self.b
        dd = b.train_data if data_idx == 0 else b.valid_data[data_idx - 1]
        raw = dd.host_score()
        return np.asarray(b.objective.convert_output(raw)).reshape(-1)

    def n_pred_per_row(self, predict_type: int, num_iteration: int) -> int:
        b = self.b
        if predict_type == C_API_PREDICT_LEAF_INDEX:
            n_models = len(b.models)
            if num_iteration > 0:
                n_models = min(n_models, num_iteration * b.num_class)
            return n_models
        return b.num_class

    def predict_device(self):
        """The device predictions run on: the training device, else the
        one the parameters name (``device=cpu`` to ask for the host)."""
        if self.device is None:
            self.device = resolve_device(self.config.device)
        return self.device

    def forest(self, num_iteration: int):
        """The trees frozen for the forest-walk kernel (as
        ``basic.Booster._compiled`` freezes them)."""
        if self._forest is None or self._forest[0] != int(num_iteration):
            from ..serve.forest import CompiledForest
            cfg = self.config
            cf = CompiledForest.from_booster(
                self.b, device=self.predict_device(),
                num_iteration=num_iteration,
                buckets=list(cfg.predict_buckets) or None,
                serve_walk=cfg.serve_walk,
                quantize_leaves=bool(cfg.serve_quantize_leaves))
            cf._xfer_phase = "predict"
            self._forest = (int(num_iteration), cf)
        return self._forest[1]

    def predict_mat(self, X: np.ndarray, predict_type: int,
                    num_iteration: int) -> np.ndarray:
        """Row-major [n, n_pred_per_row] like Predictor's per-row writer
        (predictor.hpp:81-129)."""
        b = self.b
        self.predict_device()
        if predict_type == C_API_PREDICT_LEAF_INDEX:
            return np.asarray(b.predict_leaf_index(X, num_iteration),
                              np.float64)
        if b.num_trees() == 0 or X.shape[0] == 0:
            raw = np.zeros((b.num_class, X.shape[0]), np.float64)
        else:
            raw = self.forest(num_iteration).raw_scores(X)
        if predict_type == C_API_PREDICT_NORMAL and \
                getattr(b, "objective", None) is not None:
            raw = np.asarray(b.objective.convert_output(raw), np.float64)
        return np.asarray(raw, np.float64).T  # [n, num_class]


# ---------------------------------------------------------------------------
# dataset construction helpers
# ---------------------------------------------------------------------------

def _dataset_params(params: Dict[str, str]):
    cfg = Config({**params, "task": "train"})
    return cfg


def _binned_from_matrix(X: np.ndarray, params: Dict[str, str],
                        reference: Optional[BinnedDataset]) -> BinnedDataset:
    if reference is not None:
        return reference.create_valid(X, None)
    cfg = _dataset_params(params)
    return BinnedDataset.from_matrix(
        X, None, max_bin=cfg.max_bin, min_data_in_bin=cfg.min_data_in_bin,
        min_data_in_leaf=cfg.min_data_in_leaf,
        bin_construct_sample_cnt=cfg.bin_construct_sample_cnt,
        categorical_features=[], data_random_seed=cfg.data_random_seed,
        enable_bundle=bool(cfg.enable_bundle),
        max_conflict_rate=float(cfg.max_conflict_rate),
        is_enable_sparse=bool(cfg.is_enable_sparse),
        keep_raw=bool(cfg.linear_tree))


def _csr_to_dense(indptr, indptr_type, indices, data, data_type,
                  nindptr, nelem, num_col) -> np.ndarray:
    ip = _np_from_ptr(indptr, indptr_type, int(nindptr)).astype(np.int64)
    idx = _np_from_ptr(indices, C_API_DTYPE_INT32, int(nelem))
    val = _np_from_ptr(data, data_type, int(nelem)).astype(np.float64)
    nrow = int(nindptr) - 1
    ncol = int(num_col)
    if ncol <= 0:
        ncol = int(idx.max()) + 1 if nelem else 0
    X = np.zeros((nrow, ncol), dtype=np.float64)
    rows = np.repeat(np.arange(nrow), np.diff(ip))
    X[rows, idx] = val
    return X


def _csc_to_dense(col_ptr, col_ptr_type, indices, data, data_type,
                  ncol_ptr, nelem, num_row) -> np.ndarray:
    cp = _np_from_ptr(col_ptr, col_ptr_type, int(ncol_ptr)).astype(np.int64)
    idx = _np_from_ptr(indices, C_API_DTYPE_INT32, int(nelem))
    val = _np_from_ptr(data, data_type, int(nelem)).astype(np.float64)
    ncol = int(ncol_ptr) - 1
    X = np.zeros((int(num_row), ncol), dtype=np.float64)
    cols = np.repeat(np.arange(ncol), np.diff(cp))
    X[idx, cols] = val
    return X


def _mat_to_dense(data, data_type, nrow, ncol, is_row_major) -> np.ndarray:
    flat = _np_from_ptr(data, data_type, int(nrow) * int(ncol))
    if int(is_row_major):
        return flat.reshape(int(nrow), int(ncol)).astype(np.float64,
                                                         copy=False)
    return flat.reshape(int(ncol), int(nrow)).T.astype(np.float64)


# ---------------------------------------------------------------------------
# the C API functions
# ---------------------------------------------------------------------------
# Every function below is bound under its own name by bind_library(); the
# @_capi decorator adds the 0/-1 + LastError convention.

def _capi(fn):
    def wrapper(*args):
        try:
            fn(*args)
            return 0
        except Exception as exc:  # noqa: BLE001 - C boundary
            _set_last_error(f"{type(exc).__name__}: {exc}")
            return -1
    wrapper.__name__ = fn.__name__
    wrapper._raw = fn
    return wrapper


@_capi
def LGBM_DatasetCreateFromFile(filename, parameters, reference, out):
    params = _parse_params(parameters)
    path = _str(filename)
    ref = _from_handle(reference).binned if reference else None
    if BinnedDataset.is_binary_file(path):
        binned = BinnedDataset.load_binary(path)
    else:
        # alias-resolved config ('header=' -> has_header etc., config.py)
        cfg = _dataset_params(params)
        from ..io.guard import IngestGuard
        label, X, header = parse_file(
            path, has_header=bool(cfg.has_header),
            label_idx=int(cfg.label_column or 0),
            guard=IngestGuard(
                path, policy=str(cfg.bad_data_policy),
                max_bad_rows=int(cfg.max_bad_rows),
                max_bad_row_fraction=float(cfg.max_bad_row_fraction)))
        binned = _binned_from_matrix(X, params, ref)
        if label is not None:
            binned.metadata.set_label(label)
        if header:
            binned.feature_names = list(header)
        binned.metadata.load_side_files(path)
    ds = _CDataset(binned, params)
    out[0] = _register(ds)


@_capi
def LGBM_DatasetCreateFromSampledColumn(sample_data, sample_indices, ncol,
                                        num_per_col, num_sample_row,
                                        num_total_row, parameters, out):
    """Construct mappers from per-column samples, then await PushRows
    (DatasetLoader::CostructFromSampleData, dataset_loader.cpp:657-722)."""
    params = _parse_params(parameters)
    cfg = _dataset_params(params)
    n_total = int(num_total_row)
    n_sample = int(num_sample_row)
    filter_cnt = int(0.95 * cfg.min_data_in_leaf / max(1, n_total) * n_sample)
    mappers: List[Optional[BinMapper]] = []
    for c in range(int(ncol)):
        col = _np_from_ptr(sample_data[c], C_API_DTYPE_FLOAT64,
                           int(num_per_col[c]))
        nonzero = col[col != 0.0]
        m = BinMapper().find_bin(nonzero, n_sample, cfg.max_bin,
                                 cfg.min_data_in_bin, filter_cnt, NUMERICAL)
        mappers.append(None if m.is_trivial else m)
    ds = _CDataset.from_mappers(mappers, n_total, cfg.max_bin, params)
    out[0] = _register(ds)


@_capi
def LGBM_DatasetCreateByReference(reference, num_total_row, out):
    ref = _from_handle(reference)
    rb = ref.binned
    mappers: List[Optional[BinMapper]] = [None] * rb.num_total_features
    for inner, f in enumerate(rb.used_feature_map):
        mappers[f] = rb.mappers[inner]
    ds = _CDataset.from_mappers(mappers, int(num_total_row), rb.max_bin,
                                dict(ref.params))
    ds.binned.feature_names = list(rb.feature_names)
    out[0] = _register(ds)


@_capi
def LGBM_DatasetPushRows(dataset, data, data_type, nrow, ncol, start_row):
    ds = _from_handle(dataset)
    rows = _mat_to_dense(data, data_type, nrow, ncol, 1)
    ds.push_rows(rows, int(start_row))


@_capi
def LGBM_DatasetPushRowsByCSR(dataset, indptr, indptr_type, indices, data,
                              data_type, nindptr, nelem, num_col, start_row):
    ds = _from_handle(dataset)
    rows = _csr_to_dense(indptr, indptr_type, indices, data, data_type,
                         nindptr, nelem, num_col)
    ds.push_rows(rows, int(start_row))


@_capi
def LGBM_DatasetCreateFromCSR(indptr, indptr_type, indices, data, data_type,
                              nindptr, nelem, num_col, parameters, reference,
                              out):
    params = _parse_params(parameters)
    ref = _from_handle(reference).binned if reference else None
    X = _csr_to_dense(indptr, indptr_type, indices, data, data_type,
                      nindptr, nelem, num_col)
    ds = _CDataset(_binned_from_matrix(X, params, ref), params)
    out[0] = _register(ds)


@_capi
def LGBM_DatasetCreateFromCSC(col_ptr, col_ptr_type, indices, data, data_type,
                              ncol_ptr, nelem, num_row, parameters, reference,
                              out):
    params = _parse_params(parameters)
    ref = _from_handle(reference).binned if reference else None
    X = _csc_to_dense(col_ptr, col_ptr_type, indices, data, data_type,
                      ncol_ptr, nelem, num_row)
    ds = _CDataset(_binned_from_matrix(X, params, ref), params)
    out[0] = _register(ds)


@_capi
def LGBM_DatasetCreateFromMat(data, data_type, nrow, ncol, is_row_major,
                              parameters, reference, out):
    params = _parse_params(parameters)
    ref = _from_handle(reference).binned if reference else None
    X = _mat_to_dense(data, data_type, nrow, ncol, is_row_major)
    ds = _CDataset(_binned_from_matrix(X, params, ref), params)
    out[0] = _register(ds)


@_capi
def LGBM_DatasetGetSubset(handle, used_row_indices, num_used_row_indices,
                          parameters, out):
    ds = _from_handle(handle)
    idx = _np_from_ptr(used_row_indices, C_API_DTYPE_INT32,
                       int(num_used_row_indices))
    sub = _CDataset(ds.binned.subset(idx), _parse_params(parameters))
    out[0] = _register(sub)


@_capi
def LGBM_DatasetSetFeatureNames(handle, feature_names, num_feature_names):
    ds = _from_handle(handle)
    ds.binned.feature_names = [
        feature_names[i].decode("utf-8")
        for i in range(int(num_feature_names))]


@_capi
def LGBM_DatasetGetFeatureNames(handle, feature_names, num_feature_names):
    names = _from_handle(handle).binned.feature_names
    _write_strings(feature_names, names)
    num_feature_names[0] = len(names)


@_capi
def LGBM_DatasetFree(handle):
    _free_handle(handle)


@_capi
def LGBM_DatasetSaveBinary(handle, filename):
    _from_handle(handle).binned.save_binary(_str(filename))


@_capi
def LGBM_DatasetSetField(handle, field_name, field_data, num_element, type_):
    ds = _from_handle(handle)
    name = _str(field_name)
    n = int(num_element)
    md = ds.binned.metadata
    if name == "label":
        md.set_label(_np_from_ptr(field_data, type_, n))
    elif name == "weight":
        md.set_weights(_np_from_ptr(field_data, type_, n))
    elif name in ("init_score",):
        md.set_init_score(_np_from_ptr(field_data, type_, n))
    elif name in ("group", "query"):
        md.set_query(_np_from_ptr(field_data, type_, n))
    elif name in ("group_id", "query_id"):
        md.set_query_id(_np_from_ptr(field_data, type_, n))
    else:
        raise _CApiError(f"Unknown field name {name!r}")


@_capi
def LGBM_DatasetGetField(handle, field_name, out_len, out_ptr, out_type):
    ds = _from_handle(handle)
    name = _str(field_name)
    md = ds.binned.metadata
    if name == "label":
        arr, t = np.ascontiguousarray(md.label, np.float32), \
            C_API_DTYPE_FLOAT32
    elif name == "weight":
        if md.weights is None:
            raise _CApiError("weight field is empty")
        arr, t = np.ascontiguousarray(md.weights, np.float32), \
            C_API_DTYPE_FLOAT32
    elif name == "init_score":
        if md.init_score is None:
            raise _CApiError("init_score field is empty")
        arr, t = np.ascontiguousarray(md.init_score, np.float64), \
            C_API_DTYPE_FLOAT64
    elif name in ("group", "query"):
        if md.query_boundaries is None:
            raise _CApiError("group field is empty")
        # the reference returns the NUM_QUERY+1 cumulative boundaries
        arr, t = np.ascontiguousarray(md.query_boundaries, np.int32), \
            C_API_DTYPE_INT32
    else:
        raise _CApiError(f"Unknown field name {name!r}")
    # the caller reads the array after the call: it lives on the handle
    ds.field_cache[name] = arr
    out_len[0] = arr.shape[0]
    out_ptr[0] = arr.ctypes.data
    out_type[0] = t


@_capi
def LGBM_DatasetGetNumData(handle, out):
    out[0] = int(_from_handle(handle).binned.num_data)


@_capi
def LGBM_DatasetGetNumFeature(handle, out):
    out[0] = int(_from_handle(handle).binned.num_total_features)


# --- Booster ---------------------------------------------------------------

@_capi
def LGBM_BoosterCreate(train_data, parameters, out):
    ds = _from_handle(train_data)
    cfg = Config(_parse_params(parameters))
    device = resolve_device(cfg.device)
    booster = create_boosting(cfg, ds.binned, device=device)
    out[0] = _register(_CBooster(booster, cfg, device))


@_capi
def LGBM_BoosterCreateFromModelfile(filename, out_num_iterations, out):
    with open(_str(filename)) as fh:
        model_str = fh.read()
    cfg = Config({})
    booster = create_boosting(cfg, None, model_str=model_str)
    out_num_iterations[0] = booster.num_init_iteration
    out[0] = _register(_CBooster(booster, cfg))


@_capi
def LGBM_BoosterLoadModelFromString(model_str, out_num_iterations, out):
    cfg = Config({})
    booster = create_boosting(cfg, None, model_str=_str(model_str))
    out_num_iterations[0] = booster.num_init_iteration
    out[0] = _register(_CBooster(booster, cfg))


@_capi
def LGBM_BoosterFree(handle):
    _free_handle(handle)


@_capi
def LGBM_BoosterMerge(handle, other_handle):
    """Append other's trees (GBDT::MergeFrom, gbdt.cpp:90-99: models are
    merged; score updaters are deliberately left untouched).  Routed
    through the validated merge so incompatible boosters (num_class /
    feature width / objective) refuse with a named error instead of
    silently corrupting predictions."""
    cb = _from_handle(handle)
    other = _from_handle(other_handle)
    cb.b.merge_from(other.b)
    cb.trees_changed()


@_capi
def LGBM_BoosterAddValidData(handle, valid_data):
    cb = _from_handle(handle)
    ds = _from_handle(valid_data)
    cb.b.add_valid_dataset(ds.binned)
    cb.valid_handles.append(ds)


@_capi
def LGBM_BoosterResetTrainingData(handle, train_data):
    cb = _from_handle(handle)
    cb.b.reset_training_data(_from_handle(train_data).binned)
    cb.trees_changed()


@_capi
def LGBM_BoosterResetParameter(handle, parameters):
    cb = _from_handle(handle)
    params = _parse_params(parameters)
    banned = ["num_class", "boosting_type", "boosting", "metric"]
    if cb.trains():
        # the training buffers live on the booster's device
        banned.append("device")
    keys = apply_aliases(params)
    for key in banned:
        if key in params or key in keys:
            raise _CApiError(f"cannot change {key} during training")
    merged = Config({**cb.config.raw, **params})
    cb.b.reset_config(merged)
    cb.config = merged
    if not cb.trains():
        cb.device = None         # resolved again at the next predict
    cb.trees_changed()


@_capi
def LGBM_BoosterGetNumClasses(handle, out_len):
    out_len[0] = int(_from_handle(handle).b.num_class)


@_capi
def LGBM_BoosterUpdateOneIter(handle, is_finished):
    cb = _from_handle(handle)
    cb.trees_changed()
    stop = cb.b.train_one_iter()
    is_finished[0] = 1 if stop else 0


@_capi
def LGBM_BoosterUpdateOneIterCustom(handle, grad, hess, is_finished):
    cb = _from_handle(handle)
    n = cb.b.num_data * cb.b.num_class
    g = _np_from_ptr(grad, C_API_DTYPE_FLOAT32, n)
    h = _np_from_ptr(hess, C_API_DTYPE_FLOAT32, n)
    cb.trees_changed()
    stop = cb.b.train_one_iter(g, h)
    is_finished[0] = 1 if stop else 0


@_capi
def LGBM_BoosterRollbackOneIter(handle):
    cb = _from_handle(handle)
    cb.b.rollback_one_iter()
    cb.trees_changed()


@_capi
def LGBM_BoosterGetCurrentIteration(handle, out_iteration):
    out_iteration[0] = int(_from_handle(handle).b.iter_)


@_capi
def LGBM_BoosterGetEvalCounts(handle, out_len):
    out_len[0] = len(_from_handle(handle).eval_names())


@_capi
def LGBM_BoosterGetEvalNames(handle, out_len, out_strs):
    names = _from_handle(handle).eval_names()
    _write_strings(out_strs, names)
    out_len[0] = len(names)


@_capi
def LGBM_BoosterGetFeatureNames(handle, out_len, out_strs):
    names = _from_handle(handle).b.feature_names
    _write_strings(out_strs, names)
    out_len[0] = len(names)


@_capi
def LGBM_BoosterGetNumFeature(handle, out_len):
    out_len[0] = int(_from_handle(handle).b.max_feature_idx + 1)


@_capi
def LGBM_BoosterGetEval(handle, data_idx, out_len, out_results):
    vals = _from_handle(handle).eval_at(int(data_idx))
    for i, v in enumerate(vals):
        out_results[i] = v
    out_len[0] = len(vals)


@_capi
def LGBM_BoosterGetNumPredict(handle, data_idx, out_len):
    cb = _from_handle(handle)
    b = cb.b
    i = int(data_idx)
    dd = b.train_data if i == 0 else b.valid_data[i - 1]
    out_len[0] = int(dd.num_data * b.num_class)


@_capi
def LGBM_BoosterGetPredict(handle, data_idx, out_len, out_result):
    pred = np.ascontiguousarray(_from_handle(handle).predict_at(
        int(data_idx)), np.float64)
    ctypes.memmove(out_result, pred.ctypes.data, pred.size * 8)
    out_len[0] = int(pred.size)


@_capi
def LGBM_BoosterPredictForFile(handle, data_filename, data_has_header,
                               predict_type, num_iteration, result_filename):
    cb = _from_handle(handle)
    _, X, _ = parse_file(_str(data_filename),
                         has_header=bool(int(data_has_header)),
                         label_idx=cb.b.label_idx,
                         num_features=cb.b.max_feature_idx + 1)
    out = cb.predict_mat(X, int(predict_type), int(num_iteration))
    from ..utils.diskguard import artifact_write
    with artifact_write(_str(result_filename), "predict_output") as fh:
        if out.ndim == 1 or out.shape[1] == 1:
            for v in np.asarray(out).reshape(-1):
                fh.write(f"{v:g}\n")
        else:
            for row in out:
                fh.write("\t".join(f"{v:g}" for v in row) + "\n")


@_capi
def LGBM_BoosterCalcNumPredict(handle, num_row, predict_type, num_iteration,
                               out_len):
    cb = _from_handle(handle)
    out_len[0] = int(num_row) * cb.n_pred_per_row(int(predict_type),
                                                  int(num_iteration))


def _write_pred(out_len, out_result, out: np.ndarray) -> None:
    flat = np.ascontiguousarray(out, np.float64).reshape(-1)
    ctypes.memmove(out_result, flat.ctypes.data, flat.size * 8)
    out_len[0] = int(flat.size)


@_capi
def LGBM_BoosterPredictForCSR(handle, indptr, indptr_type, indices, data,
                              data_type, nindptr, nelem, num_col,
                              predict_type, num_iteration, out_len,
                              out_result):
    cb = _from_handle(handle)
    ncol = int(num_col) if int(num_col) > 0 else cb.b.max_feature_idx + 1
    X = _csr_to_dense(indptr, indptr_type, indices, data, data_type,
                      nindptr, nelem, ncol)
    _write_pred(out_len, out_result,
                cb.predict_mat(X, int(predict_type), int(num_iteration)))


@_capi
def LGBM_BoosterPredictForCSC(handle, col_ptr, col_ptr_type, indices, data,
                              data_type, ncol_ptr, nelem, num_row,
                              predict_type, num_iteration, out_len,
                              out_result):
    cb = _from_handle(handle)
    X = _csc_to_dense(col_ptr, col_ptr_type, indices, data, data_type,
                      ncol_ptr, nelem, num_row)
    _write_pred(out_len, out_result,
                cb.predict_mat(X, int(predict_type), int(num_iteration)))


@_capi
def LGBM_BoosterPredictForMat(handle, data, data_type, nrow, ncol,
                              is_row_major, predict_type, num_iteration,
                              out_len, out_result):
    cb = _from_handle(handle)
    X = _mat_to_dense(data, data_type, nrow, ncol, is_row_major)
    _write_pred(out_len, out_result,
                cb.predict_mat(X, int(predict_type), int(num_iteration)))


@_capi
def LGBM_BoosterSaveModel(handle, num_iteration, filename):
    from ..utils.diskguard import write_artifact_atomic
    text = _from_handle(handle).b.save_model_to_string(int(num_iteration))
    write_artifact_atomic(_str(filename), text.encode(), "model_file")


def _string_out(text: str, buffer_len, out_len, out_str) -> None:
    """The buffer_len/out_len re-allocation protocol (c_api.cpp:893-918):
    out_len = needed size incl. NUL; copy only when the buffer fits."""
    raw = text.encode("utf-8") + b"\x00"
    out_len[0] = len(raw)
    if int(buffer_len) >= len(raw):
        ctypes.memmove(out_str, raw, len(raw))


@_capi
def LGBM_BoosterSaveModelToString(handle, num_iteration, buffer_len, out_len,
                                  out_str):
    text = _from_handle(handle).b.save_model_to_string(int(num_iteration))
    _string_out(text, buffer_len, out_len, out_str)


@_capi
def LGBM_BoosterDumpModel(handle, num_iteration, buffer_len, out_len,
                          out_str):
    b = _from_handle(handle).b
    n_models = len(b.models)
    if int(num_iteration) > 0:
        n_models = min(n_models, int(num_iteration) * b.num_class)
    dump = {
        "name": "tree",
        "num_class": b.num_class,
        "label_index": b.label_idx,
        "max_feature_idx": b.max_feature_idx,
        "feature_names": list(b.feature_names),
        "tree_info": [b.models[i].to_json() for i in range(n_models)],
    }
    _string_out(json.dumps(dump), buffer_len, out_len, out_str)


@_capi
def LGBM_BoosterGetLeafValue(handle, tree_idx, leaf_idx, out_val):
    tree = _from_handle(handle).b.models[int(tree_idx)]
    out_val[0] = float(tree.leaf_value[int(leaf_idx)])


@_capi
def LGBM_BoosterSetLeafValue(handle, tree_idx, leaf_idx, val):
    cb = _from_handle(handle)
    tree = cb.b.models[int(tree_idx)]
    tree.leaf_value[int(leaf_idx)] = float(val)
    cb.trees_changed()


# ---------------------------------------------------------------------------

def bind_library(path: str) -> int:
    """Load the library at ``path`` and hand it one ``ctypes`` callback
    per entry point (``LGBM_GetLastError``'s slot stays empty: it never
    enters Python).  Returns the number of callbacks the library took;
    binding a path again takes nothing new."""
    path = str(path)
    with _lock:
        if path in _libs:
            return len(_callbacks[path])
        lib = ctypes.CDLL(path)
        lib.LGBM_TorchSetLastError.argtypes = [ctypes.c_char_p]
        lib.LGBM_TorchSetLastError.restype = None
        lib.LGBM_TorchBind.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                       ctypes.c_int]
        lib.LGBM_TorchBind.restype = ctypes.c_int
        table = (ctypes.c_void_p * len(API_NAMES))()
        cbs: Dict[str, object] = {}
        for i, name in enumerate(API_NAMES):
            if name == "LGBM_GetLastError":
                continue
            ret, args = SIGNATURES[name]
            proto = ctypes.CFUNCTYPE(ctypes_of(ret),
                                     *[ctypes_of(a) for a in args])
            cbs[name] = proto(globals()[name])
            table[i] = ctypes.cast(cbs[name], ctypes.c_void_p).value
        _callbacks[path] = cbs
        _libs[path] = lib
    taken = lib.LGBM_TorchBind(table, len(API_NAMES))
    if taken != len(cbs):
        raise LightGBMError(
            f"{path}: LGBM_TorchBind took {taken} of {len(cbs)} callbacks")
    return taken
