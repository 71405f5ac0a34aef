"""Binned training matrix and its metadata, on the host.

Port of the JAX package's io/dataset.py for the training slice:
``Metadata`` (labels, weights, query boundaries and query weights, init
scores, and the ``.weight`` / ``.query`` / ``.init`` side files beside a
data file), the FindBin stage
(``build_mappers_from_sample``) and ``BinnedDataset.from_matrix`` /
``create_valid`` / ``subset`` (a row subset on the same mappers: the
folds of ``cv``).  Rows are sampled for binning from
``data_random_seed`` with numpy exactly as the JAX package samples them,
trivial features are dropped, and the bins are stored dense and
feature-major, ``[F_used, N]`` uint8 (uint16 when some feature needs more
than 256 bins).  With ``keep_raw`` (``linear_tree``) the dataset also
keeps ``raw`` [F_used, N] f32, the used features' raw values (NaN kept),
feature-major like ``bins``; ``create_valid`` carries it over.

Exclusive feature bundling (EFB, ``io/bundling.py``): with
``enable_bundle`` the planner runs over the binning sample, and a
dataset with a ``bundle_plan`` stores ``bins`` as ``[C, N]`` columns,
mutually exclusive sparse features sharing one with offset-encoded bin
sub-ranges; valid sets and subsets ride the training plan.  The binary
dataset file (``save_binary`` / ``load_binary``) is the JAX package's
format: the token ``__lightgbm_tpu_dataset_v1__`` and a compressed npz
archive whose ``meta_json`` holds the mappers, the names and the bundle
plan, so either package loads a file the other wrote.

``from_matrix`` also builds the drift fingerprint (``obs/drift.py``
``DataFingerprint``) from the mappers and the full matrix, as the JAX
package does; binary files, valid sets and subsets leave it ``None``.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

import numpy as np

from ..obs.drift import DataFingerprint
from ..utils import log
from .binning import CATEGORICAL, NUMERICAL, BinMapper
from .bundling import BundlePlan, plan_bundles
from .column_roles import qid_to_query_sizes

_BINARY_TOKEN = b"__lightgbm_tpu_dataset_v1__"


class Metadata:
    """Labels, weights, query boundaries and their weights, init scores
    (reference dataset.h:35-247)."""

    def __init__(self, num_data: int = 0):
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None
        self.weights: Optional[np.ndarray] = None
        self.query_boundaries: Optional[np.ndarray] = None
        self.query_weights: Optional[np.ndarray] = None
        self.init_score: Optional[np.ndarray] = None

    def set_label(self, label) -> None:
        self.label = np.asarray(label, dtype=np.float32).ravel()

    def set_weights(self, weights) -> None:
        self.weights = (None if weights is None
                        else np.asarray(weights, dtype=np.float32).ravel())
        self._update_query_weights()

    def set_init_score(self, init_score) -> None:
        self.init_score = (None if init_score is None else
                           np.asarray(init_score, dtype=np.float64).ravel())

    def set_query(self, group) -> None:
        """``group``: the size of each query, in row order."""
        if group is None:
            self.query_boundaries = None
        else:
            sizes = np.asarray(group, dtype=np.int64).ravel()
            self.query_boundaries = np.concatenate(
                [[0], np.cumsum(sizes)]).astype(np.int64)
        self._update_query_weights()

    def set_query_id(self, qid) -> None:
        """A query id per row; each run of one id is a query."""
        self.set_query(qid_to_query_sizes(np.asarray(qid).ravel()))

    def _update_query_weights(self) -> None:
        """The mean row weight of each query (metadata.cpp), in f32."""
        if self.query_boundaries is None or self.weights is None:
            self.query_weights = None
            return
        qb = self.query_boundaries
        qw = np.zeros(len(qb) - 1, dtype=np.float32)
        for i in range(len(qb) - 1):
            a, b = qb[i], qb[i + 1]
            qw[i] = self.weights[a:b].sum() / max(1, b - a)
        self.query_weights = qw

    def load_side_files(self, data_path: str) -> None:
        """``<data>.weight``, ``<data>.query`` (query sizes) and
        ``<data>.init`` beside a data file, where they exist."""
        wpath = data_path + ".weight"
        if os.path.exists(wpath):
            self.set_weights(np.loadtxt(wpath, dtype=np.float64).ravel())
            log.info("Loading weights from %s", wpath)
        qpath = data_path + ".query"
        if os.path.exists(qpath):
            self.set_query(np.loadtxt(qpath, dtype=np.int64).ravel())
            log.info("Loading query boundaries from %s", qpath)
        ipath = data_path + ".init"
        if os.path.exists(ipath):
            self.set_init_score(np.loadtxt(ipath, dtype=np.float64).ravel())
            log.info("Loading initial scores from %s", ipath)

    def num_queries(self) -> int:
        return (0 if self.query_boundaries is None
                else len(self.query_boundaries) - 1)


def build_mappers_from_sample(sample: np.ndarray, num_data: int, *,
                              max_bin: int, min_data_in_bin: int,
                              min_data_in_leaf: int,
                              categorical_features=frozenset(),
                              ignore_features=frozenset(),
                              predefined_mappers=None,
                              feature_indices=None):
    """Per-feature BinMapper list (None for an ignored feature) from a
    row sample (the FindBin stage, reference dataset_loader.cpp:656-722).
    The trivial-feature filter count is scaled to the sample: 0.95 *
    min_data_in_leaf / num_data * sample_cnt.  ``feature_indices``
    restricts the work to those features (the feature-sharded
    distributed FindBin, ``parallel/ingest.py``); the others get None."""
    total_sample_cnt = sample.shape[0]
    filter_cnt = int(0.95 * min_data_in_leaf / max(1, num_data)
                     * total_sample_cnt)
    todo = range(sample.shape[1]) if feature_indices is None \
        else feature_indices
    out: List[Optional[BinMapper]] = [None] * sample.shape[1]
    for f in todo:
        if f in ignore_features:
            continue
        if predefined_mappers is not None \
                and predefined_mappers[f] is not None:
            out[f] = predefined_mappers[f]
            continue
        col = sample[:, f]
        out[f] = BinMapper().find_bin(
            col[col != 0.0], total_sample_cnt, max_bin, min_data_in_bin,
            filter_cnt,
            CATEGORICAL if f in categorical_features else NUMERICAL)
    return out


def _nan_counts(data: np.ndarray, rows: int = 1 << 16) -> np.ndarray:
    """NaNs per column of ``data`` [N, F], read in row blocks (one pass
    in memory order)."""
    out = np.zeros(data.shape[1], np.int64)
    for lo in range(0, data.shape[0], rows):
        out += np.isnan(data[lo:lo + rows]).sum(axis=0)
    return out


def _bins_dtype(mappers, plan=None) -> type:
    """uint8 unless some column needs more than 256 bin codes (a bundle's
    bins are capped at ``max_bin``, so bundling never widens the
    dtype)."""
    per_col = [m.num_bin for m in mappers] or [1]
    if plan is not None:
        per_col = [1 + sum(mappers[f].num_bin - 1 for f in members)
                   if len(members) > 1 else mappers[members[0]].num_bin
                   for members in plan.column_members]
    return np.uint8 if max(per_col or [1]) <= 256 else np.uint16


class BinnedDataset:
    """Column-binned training matrix.

    ``bins`` [C, N] uint8/uint16 column-major codes, one column per used
    feature, or per EFB bundle when ``bundle_plan`` is set; ``mappers``
    per used feature (original space); ``used_feature_map`` used -> real
    feature index; ``real_to_inner`` real -> used index or -1 (trivial);
    ``raw`` [F_used, N] f32 raw values or None (kept for linear
    trees)."""

    def __init__(self) -> None:
        self.bins: np.ndarray = np.zeros((0, 0), dtype=np.uint8)
        self.mappers: List[BinMapper] = []
        self.used_feature_map: List[int] = []
        self.real_to_inner: np.ndarray = np.zeros(0, dtype=np.int64)
        self.num_total_features = 0
        self.feature_names: List[str] = []
        self.metadata = Metadata()
        self.max_bin = 255
        # the label's column in the file the matrix came from
        self.label_idx = 0
        self.raw: Optional[np.ndarray] = None
        self.bundle_plan: Optional[BundlePlan] = None
        self.data_fingerprint = None

    @classmethod
    def from_matrix(cls, data: np.ndarray, label=None, *,
                    max_bin: int = 255, min_data_in_bin: int = 5,
                    min_data_in_leaf: int = 100,
                    bin_construct_sample_cnt: int = 200000,
                    categorical_features: Sequence[int] = (),
                    ignore_features: Sequence[int] = (),
                    feature_names: Optional[Sequence[str]] = None,
                    data_random_seed: int = 1,
                    label_idx: int = 0,
                    predefined_mappers=None,
                    enable_bundle: bool = False,
                    max_conflict_rate: float = 0.0,
                    is_enable_sparse: bool = True,
                    keep_raw: bool = False) -> "BinnedDataset":
        """Bin a raw [N, F] float matrix: sample rows -> per-feature
        FindBin -> extract features (dataset_loader.cpp:656-820).
        ``ignore_features`` (the ignored, weight and group columns) get
        no mapper and are not used; ``keep_raw`` also keeps the used
        features' raw values; ``enable_bundle`` plans EFB bundles over
        the binning sample (``io/bundling.py``); ``label_idx`` records
        the label's column in the source file."""
        data = np.ascontiguousarray(np.asarray(data, dtype=np.float64))
        if data.ndim != 2:
            raise ValueError("data must be 2-D [num_data, num_features]")
        num_data, num_features = data.shape
        self = cls()
        self.num_total_features = num_features
        self.max_bin = max_bin
        self.label_idx = label_idx
        self.feature_names = (list(feature_names) if feature_names
                              is not None else
                              [f"Column_{i}" for i in range(num_features)])
        rng = np.random.RandomState(data_random_seed)
        if num_data > bin_construct_sample_cnt:
            sample = data[np.sort(rng.choice(
                num_data, bin_construct_sample_cnt, replace=False))]
        else:
            sample = data
        per_real = build_mappers_from_sample(
            sample, num_data, max_bin=max_bin,
            min_data_in_bin=min_data_in_bin,
            min_data_in_leaf=min_data_in_leaf,
            categorical_features={int(c) for c in categorical_features},
            ignore_features={int(c) for c in ignore_features},
            predefined_mappers=predefined_mappers)
        self.real_to_inner = np.full(num_features, -1, dtype=np.int64)
        used = []
        for f, mapper in enumerate(per_real):
            if mapper is not None and not mapper.is_trivial:
                self.real_to_inner[f] = len(used)
                used.append(f)
        self.used_feature_map = used
        self.mappers = [per_real[f] for f in used]
        if not used:
            log.warning("All features are trivial; dataset has no usable "
                        "feature")
        # the plan is drawn over the sample FindBin saw
        self.bundle_plan = plan_bundles(
            sample, self.mappers, used, max_conflict_rate=max_conflict_rate,
            max_total_bin=max_bin, enable_bundle=enable_bundle,
            is_enable_sparse=is_enable_sparse)
        occupancy: List[np.ndarray] = []
        self.bins = self._bin_columns(data, occupancy)
        if keep_raw and used:
            self.raw = self._raw_columns(data)
        self.metadata = Metadata(num_data)
        self.metadata.set_label(label if label is not None
                                else np.zeros(num_data, np.float32))
        if used:
            self.data_fingerprint = DataFingerprint.from_training(
                self.mappers, used, self.feature_names, data,
                np.asarray(label, np.float64) if label is not None
                else None, occupancy=occupancy,
                nan_counts=_nan_counts(data))
        return self

    def _bin_columns(self, data: np.ndarray,
                     occupancy: Optional[list] = None) -> np.ndarray:
        """[C, n] column codes of the raw rows ``data``, in this dataset's
        layout (the training plan's columns for a valid set too).  With
        ``occupancy`` (a list), each used feature's bin counts over the
        rows are appended to it, in feature order (the fingerprint's)."""
        dtype = _bins_dtype(self.mappers, self.bundle_plan)
        ufm = self.used_feature_map
        counts = {}

        def feature_bins(inner):
            mapper = self.mappers[inner]
            b = mapper.value_to_bin(data[:, ufm[inner]])
            if occupancy is not None:
                counts[inner] = np.bincount(b, minlength=mapper.num_bin)
            return b
        if self.bundle_plan is not None:
            bins = self.bundle_plan.encode_columns(feature_bins,
                                                   data.shape[0], dtype)
        else:
            bins = np.zeros((len(ufm), data.shape[0]), dtype)
            for inner in range(len(ufm)):
                bins[inner] = feature_bins(inner).astype(dtype)
        if occupancy is not None:
            occupancy.extend(counts[inner] for inner in range(len(ufm)))
        return bins

    def _raw_columns(self, data: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(data[:, self.used_feature_map].T,
                                    dtype=np.float32)

    def create_valid(self, data: np.ndarray, label=None) -> "BinnedDataset":
        """Bin a validation matrix with this dataset's mappers
        (CreateValid, dataset.cpp:124-208)."""
        data = np.asarray(data, dtype=np.float64)
        valid = BinnedDataset()
        valid.num_total_features = self.num_total_features
        valid.max_bin = self.max_bin
        valid.feature_names = list(self.feature_names)
        valid.used_feature_map = list(self.used_feature_map)
        valid.real_to_inner = self.real_to_inner.copy()
        valid.mappers = self.mappers
        # valid rows ride the training bundles: their replay runs on the
        # same column layout
        valid.bundle_plan = self.bundle_plan
        valid.bins = self._bin_columns(data)
        if self.raw is not None:
            # linear-tree valid scoring reads the valid rows' raw values
            valid.raw = self._raw_columns(data)
        valid.metadata = Metadata(data.shape[0])
        valid.metadata.set_label(label if label is not None
                                 else np.zeros(data.shape[0], np.float32))
        return valid

    def subset(self, indices) -> "BinnedDataset":
        """The rows ``indices`` on the same mappers (CopySubset,
        dataset.cpp:210-230): bins and raw values gathered, label,
        weights and every class's init scores subset, query boundaries
        rebuilt from the runs of each query's rows (indices that leave a
        query's rows out of order are fatal, metadata.cpp)."""
        indices = np.asarray(indices, dtype=np.int64)
        sub = BinnedDataset()
        sub.num_total_features = self.num_total_features
        sub.max_bin = self.max_bin
        sub.feature_names = list(self.feature_names)
        sub.used_feature_map = list(self.used_feature_map)
        sub.real_to_inner = self.real_to_inner.copy()
        sub.mappers = self.mappers
        sub.bundle_plan = self.bundle_plan
        sub.bins = np.ascontiguousarray(self.bins[:, indices])
        if self.raw is not None:
            sub.raw = np.ascontiguousarray(self.raw[:, indices])
        sub.metadata = Metadata(len(indices))
        md, smd = self.metadata, sub.metadata
        if md.label is not None:
            smd.set_label(md.label[indices])
        if md.weights is not None:
            smd.set_weights(md.weights[indices])
        if md.init_score is not None and md.num_data:
            # class-major [num_class * num_data]
            per_class = md.init_score.reshape(-1, md.num_data)
            smd.set_init_score(per_class[:, indices].ravel())
        if md.query_boundaries is not None:
            qid = np.searchsorted(md.query_boundaries, indices,
                                  side="right") - 1
            if np.any(np.diff(qid) < 0):
                log.fatal("Data partition in subset is not aligned with "
                          "query boundaries")
            change = np.nonzero(np.diff(qid))[0] + 1
            smd.query_boundaries = np.concatenate(
                [[0], change, [len(indices)]]).astype(np.int64)
            smd._update_query_weights()
        return sub

    @property
    def num_data(self) -> int:
        return self.bins.shape[1]

    @property
    def num_features(self) -> int:
        """Used (non-trivial) original features: the split scan's
        space."""
        return len(self.used_feature_map)

    @property
    def num_columns(self) -> int:
        """Columns of ``bins`` (``num_features`` unless EFB bundled)."""
        return self.bins.shape[0]

    def num_bin_per_feature(self) -> np.ndarray:
        return np.asarray([m.num_bin for m in self.mappers], dtype=np.int32)

    def is_categorical_per_feature(self) -> np.ndarray:
        return np.asarray([m.bin_type == CATEGORICAL for m in self.mappers],
                          dtype=bool)

    def feature_infos(self) -> List[str]:
        """Per real feature info strings for the model file."""
        return ["none" if self.real_to_inner[f] < 0
                else self.mappers[self.real_to_inner[f]].feature_info()
                for f in range(self.num_total_features)]

    # -- the binary dataset file (the JAX package's format) -------------
    def save_binary(self, path: str) -> None:
        """The token, then an npz archive of the arrays with the mappers,
        names and bundle plan as a JSON blob (no pickle: loading a file
        runs no code).  Written to ``<path>.tmp`` and moved over ``path``
        (``utils/diskguard.artifact_write``): a failed save is a named
        ``SinkWriteError`` (sink ``binary_dataset``) and keeps the
        previous file."""
        meta_json = json.dumps({
            "mappers": [m.to_state() for m in self.mappers],
            "used_feature_map": self.used_feature_map,
            "num_total_features": self.num_total_features,
            "feature_names": self.feature_names,
            "max_bin": self.max_bin,
            "bundle_plan": (self.bundle_plan.to_state()
                            if self.bundle_plan is not None else None),
        })
        arrays = {
            "bins": self.bins,
            "real_to_inner": self.real_to_inner,
            "meta_json": np.frombuffer(meta_json.encode(), dtype=np.uint8),
        }
        if self.raw is not None:
            arrays["raw"] = self.raw
        for key in ("label", "weights", "query_boundaries", "init_score"):
            value = getattr(self.metadata, key)
            if value is not None:
                arrays[key] = value
        from ..utils.diskguard import artifact_write
        with artifact_write(path, "binary_dataset", mode="wb",
                            atomic=True) as fh:
            fh.write(_BINARY_TOKEN)
            np.savez_compressed(fh, **arrays)
        log.info("Saved binary dataset to %s", path)

    @classmethod
    def is_binary_file(cls, path: str) -> bool:
        try:
            with open(path, "rb") as fh:
                return fh.read(len(_BINARY_TOKEN)) == _BINARY_TOKEN
        except OSError:
            return False

    @classmethod
    def load_binary(cls, path: str) -> "BinnedDataset":
        with open(path, "rb") as fh:
            if fh.read(len(_BINARY_TOKEN)) != _BINARY_TOKEN:
                raise ValueError(
                    f"{path} is not a lightgbm_tpu binary dataset")
            with np.load(fh, allow_pickle=False) as npz:
                arrays = {k: npz[k] for k in npz.files}
        meta = json.loads(bytes(arrays["meta_json"]).decode())
        self = cls()
        self.bins = arrays["bins"]
        self.mappers = [BinMapper.from_state(s) for s in meta["mappers"]]
        self.used_feature_map = [int(f) for f in meta["used_feature_map"]]
        self.real_to_inner = np.asarray(arrays["real_to_inner"], np.int64)
        self.num_total_features = int(meta["num_total_features"])
        self.feature_names = list(meta["feature_names"])
        self.max_bin = int(meta["max_bin"])
        self.bundle_plan = BundlePlan.from_state(meta.get("bundle_plan"))
        self.raw = arrays.get("raw")
        md = self.metadata = Metadata(self.bins.shape[1])
        if "label" in arrays:
            md.set_label(arrays["label"])
        md.weights = arrays.get("weights")
        md.query_boundaries = arrays.get("query_boundaries")
        md.init_score = arrays.get("init_score")
        md._update_query_weights()
        return self
