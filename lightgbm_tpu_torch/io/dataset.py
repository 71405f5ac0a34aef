"""Binned training matrix and its metadata, on the host.

Port of the JAX package's io/dataset.py for the training slice:
``Metadata`` (labels, weights, query boundaries and query weights, init
scores, and the ``.weight`` / ``.query`` / ``.init`` side files beside a
data file), the FindBin stage
(``build_mappers_from_sample``) and ``BinnedDataset.from_matrix`` /
``create_valid``.  Rows are sampled for binning from
``data_random_seed`` with numpy exactly as the JAX package samples them,
trivial features are dropped, and the bins are stored dense and
feature-major, ``[F_used, N]`` uint8 (uint16 when some feature needs more
than 256 bins).  With ``keep_raw`` (``linear_tree``) the dataset also
keeps ``raw`` [F_used, N] f32, the used features' raw values (NaN kept),
feature-major like ``bins``; ``create_valid`` carries it over.

Exclusive feature bundling (EFB) is not ported: when the JAX planner
would bundle features, ``from_matrix`` raises instead of binning them
differently.  The drift fingerprint is not ported either.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from ..utils import log
from ..utils.log import LightGBMError
from .binning import CATEGORICAL, NUMERICAL, BinMapper
from .column_roles import qid_to_query_sizes

# EFB candidates must be at least this sparse (the JAX io/bundling.py
# MIN_BUNDLE_SPARSE_RATE)
MIN_BUNDLE_SPARSE_RATE = 0.8


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
                              predefined_mappers=None):
    """Per-feature BinMapper list (None for an ignored feature) from a
    row sample (the FindBin stage, reference dataset_loader.cpp:656-722).
    The trivial-feature filter count is scaled to the sample: 0.95 *
    min_data_in_leaf / num_data * sample_cnt."""
    total_sample_cnt = sample.shape[0]
    filter_cnt = int(0.95 * min_data_in_leaf / max(1, num_data)
                     * total_sample_cnt)
    out: List[Optional[BinMapper]] = []
    for f in range(sample.shape[1]):
        if f in ignore_features:
            out.append(None)
            continue
        if predefined_mappers is not None \
                and predefined_mappers[f] is not None:
            out.append(predefined_mappers[f])
            continue
        col = sample[:, f]
        out.append(BinMapper().find_bin(
            col[col != 0.0], total_sample_cnt, max_bin, min_data_in_bin,
            filter_cnt,
            CATEGORICAL if f in categorical_features else NUMERICAL))
    return out


def would_bundle(sample: np.ndarray, mappers, used: Sequence[int],
                 max_conflict_rate: float, max_total_bin: int) -> bool:
    """True when the JAX package's greedy EFB planner
    (io/bundling.py ``_plan_bundles_impl``) would put two or more
    features into one bundle on this sample."""
    cand = [f for f, m in enumerate(mappers)
            if not m.is_trivial and m.bin_type == NUMERICAL
            and m.default_bin == 0 and m.num_bin > 1
            and m.sparse_rate >= MIN_BUNDLE_SPARSE_RATE]
    if len(cand) < 2:
        return False
    cand.sort(key=lambda f: (-mappers[f].sparse_rate, f))
    budget = int(float(max_conflict_rate) * sample.shape[0])
    bundles = []              # [occupied rows, conflicts, bins used, size]
    for f in cand:
        nd = np.asarray(mappers[f].value_to_bin(sample[:, used[f]])) != 0
        nb = int(mappers[f].num_bin)
        for b in bundles:
            if b[2] + (nb - 1) > max_total_bin:
                continue
            c = int(np.count_nonzero(b[0] & nd))
            if b[1] + c > budget:
                continue
            return True       # a second member joins: a bundle forms
        bundles.append([nd.copy(), 0, nb, 1])
    return False


def _bins_dtype(mappers) -> type:
    """uint8 unless some feature needs more than 256 bin codes."""
    return np.uint8 if max([m.num_bin for m in mappers] or [1]) <= 256 \
        else np.uint16


class BinnedDataset:
    """Column-binned training matrix.

    ``bins`` [F_used, N] uint8/uint16 feature-major codes; ``mappers`` per
    used feature; ``used_feature_map`` used -> real feature index;
    ``real_to_inner`` real -> used index or -1 (trivial); ``raw``
    [F_used, N] f32 raw values or None (kept for linear trees)."""

    def __init__(self) -> None:
        self.bins: np.ndarray = np.zeros((0, 0), dtype=np.uint8)
        self.mappers: List[BinMapper] = []
        self.used_feature_map: List[int] = []
        self.real_to_inner: np.ndarray = np.zeros(0, dtype=np.int64)
        self.num_total_features = 0
        self.feature_names: List[str] = []
        self.metadata = Metadata()
        self.max_bin = 255
        self.raw: Optional[np.ndarray] = None

    @classmethod
    def from_matrix(cls, data: np.ndarray, label=None, *,
                    max_bin: int = 255, min_data_in_bin: int = 5,
                    min_data_in_leaf: int = 100,
                    bin_construct_sample_cnt: int = 200000,
                    categorical_features: Sequence[int] = (),
                    ignore_features: Sequence[int] = (),
                    feature_names: Optional[Sequence[str]] = None,
                    data_random_seed: int = 1,
                    predefined_mappers=None,
                    enable_bundle: bool = False,
                    max_conflict_rate: float = 0.0,
                    is_enable_sparse: bool = True,
                    keep_raw: bool = False) -> "BinnedDataset":
        """Bin a raw [N, F] float matrix: sample rows -> per-feature
        FindBin -> extract features (dataset_loader.cpp:656-820).
        ``ignore_features`` (the ignored, weight and group columns) get
        no mapper and are not used; ``keep_raw`` also keeps the used
        features' raw values."""
        data = np.ascontiguousarray(np.asarray(data, dtype=np.float64))
        if data.ndim != 2:
            raise ValueError("data must be 2-D [num_data, num_features]")
        num_data, num_features = data.shape
        self = cls()
        self.num_total_features = num_features
        self.max_bin = max_bin
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
        if enable_bundle and is_enable_sparse and would_bundle(
                sample, self.mappers, used, max_conflict_rate, max_bin):
            raise LightGBMError(
                "exclusive feature bundling (EFB) is not ported yet to the "
                "torch package: this matrix has sparse features the JAX "
                "package would bundle; pass enable_bundle=false")
        self.bins = self._bin_columns(data)
        if keep_raw and used:
            self.raw = self._raw_columns(data)
        self.metadata = Metadata(num_data)
        self.metadata.set_label(label if label is not None
                                else np.zeros(num_data, np.float32))
        return self

    def _bin_columns(self, data: np.ndarray) -> np.ndarray:
        dtype = _bins_dtype(self.mappers)
        bins = np.zeros((len(self.used_feature_map), data.shape[0]), dtype)
        for inner, f in enumerate(self.used_feature_map):
            bins[inner] = self.mappers[inner].value_to_bin(
                data[:, f]).astype(dtype)
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
        valid.bins = self._bin_columns(data)
        if self.raw is not None:
            # linear-tree valid scoring reads the valid rows' raw values
            valid.raw = self._raw_columns(data)
        valid.metadata = Metadata(data.shape[0])
        valid.metadata.set_label(label if label is not None
                                 else np.zeros(data.shape[0], np.float32))
        return valid

    @property
    def num_data(self) -> int:
        return self.bins.shape[1]

    @property
    def num_features(self) -> int:
        return len(self.used_feature_map)

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
