"""``Dataset`` and ``Booster``: the Python front door of the port.

Port of the JAX package's basic.py.  ``Dataset`` bins an in-memory
matrix (numpy, a scipy sparse matrix, a pandas frame whose ``category``
columns become categorical features, or lists) or a data file lazily
(``from_matrix``, or ``create_valid`` against a ``reference``), with its
metadata: weights, query sizes and initial scores from arguments, side
files or the file's own columns, or a row ``subset`` of another
Dataset on its mappers (the folds of ``cv``); with a predictor (an init
model, ``engine.train``) its init scores are the predictor's raw
predictions.  ``save_binary`` writes the binned dataset in the JAX
package's binary format, and ``Dataset(path)`` of such a file loads it.
``Booster`` either loads a model
(``model_file=`` / ``model_str=``) or trains one (``params=``,
``train_set=``; ``update()`` runs one boosting round, from a custom
``fobj`` too, ``add_valid()`` attaches a valid set, ``eval_*`` take a
custom ``feval``, ``reset_parameter`` / ``rollback_one_iter`` /
``merge`` change the model between rounds).  ``predict`` bins rows on
the host in f64 and walks them through the forest-walk kernel
(``serve/forest.py`` ``CompiledForest``), so on a card every prediction
runs the kernel; ``pred_leaf=True`` gives each row's leaf in every tree
by the f64 host walk, as the JAX package does; a file path predicts in
chunks (``predict_chunks``).  ``dump_model``, ``feature_importance``,
``attr`` / ``set_attr`` and pickling through the model text follow the
JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .config import Config
from .device import DeviceLike, resolve_device
from .io.column_roles import resolve_label_idx, resolve_roles
from .io.dataset import BinnedDataset
from .io.guard import IngestGuard, check_side_files_alignment
from .io.parser import parse_file, parse_file_chunks, read_header
from .io.streaming import (_probe_format, load_file_two_round,
                           read_header_names)
from .models import create_boosting
from .utils import log
from .utils.log import LightGBMError


def _to_dense(data) -> np.ndarray:
    """numpy, pandas, scipy sparse or lists -> a 2-D f64 matrix (a 1-D
    input is one row)."""
    if hasattr(data, "toarray"):          # scipy CSR/CSC
        data = data.toarray()
    if hasattr(data, "values") and hasattr(data, "dtypes"):  # pandas
        data = data.values
    arr = np.asarray(data, dtype=np.float64)
    if arr.ndim == 1:
        arr = arr.reshape(1, -1)
    return arr


def _data_from_pandas(data, feature_name, categorical_feature):
    """A pandas frame's column names as ``feature_name`` (when
    ``"auto"``) and its ``category`` columns as their codes and as the
    categorical features (when ``"auto"``); anything else is returned as
    it is (reference basic.py:224-267)."""
    if not (hasattr(data, "dtypes") and hasattr(data, "columns")):
        return data, feature_name, categorical_feature
    df = data.copy()
    if feature_name == "auto":
        feature_name = [str(c) for c in df.columns]
    cat_cols = [c for c in df.columns if str(df[c].dtype) == "category"]
    if categorical_feature == "auto":
        categorical_feature = [str(c) for c in cat_cols]
    for c in cat_cols:
        df[c] = df[c].cat.codes.astype(np.float64)
    return df.astype(np.float64).values, feature_name, categorical_feature


class Dataset:
    """A raw ``[N, F]`` matrix or a data file, binned at first use
    (``construct``).

    ``data`` is a matrix (numpy, scipy sparse, pandas or lists) or the
    path of a CSV, TSV or LibSVM file; a file's label is its
    ``label_column`` (default column 0), and ``<data>.weight``,
    ``.query`` and ``.init`` beside it are loaded, for a valid set too.
    The path of a binary dataset file (``save_binary``) loads the binned
    dataset it holds.  ``max_bin`` is the bin budget unless ``params``
    sets one; ``silent`` is accepted and ignored, as in the JAX package.
    ``params`` carries the binning keys (``max_bin``,
    ``min_data_in_bin``, ``min_data_in_leaf``,
    ``bin_construct_sample_cnt``, ``data_random_seed``,
    ``enable_bundle``, ``max_conflict_rate``, and ``linear_tree``, which
    keeps the raw values the linear fit reads), ``has_header`` and, for a
    file, the column roles (``weight_column``, ``group_column``,
    ``ignore_column``, ``categorical_column``; io/column_roles.py), whose
    weight and group columns override the side files.
    ``reference`` bins with another Dataset's mappers (a valid set).
    ``weight``, ``group`` (query sizes) and ``init_score`` (class-major;
    a keyword of the port's after the JAX package's parameters) set the
    metadata of a matrix; for a file, its side files override them, as
    in the JAX package.  ``categorical_feature`` lists column indices, or
    names of ``feature_name``.  ``free_raw_data`` drops ``data`` once
    binned; a constructed Dataset can then take no init model
    (``train(init_model=)``), as in the JAX package."""

    def __init__(self, data, label=None, max_bin: int = 255,
                 reference: "Dataset" = None, weight=None, group=None,
                 silent: bool = False, feature_name="auto",
                 categorical_feature="auto", params=None,
                 free_raw_data: bool = True, init_score=None):
        self.data = data
        self.label = label
        self.max_bin = max_bin
        self.reference = reference
        self.weight = weight
        self.group = group
        self.silent = silent
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params or {})
        self.free_raw_data = free_raw_data
        self.used_indices: Optional[np.ndarray] = None
        self._binned = None
        self._predictor = None

    def _update_params(self, params) -> "Dataset":
        if self._binned is None:
            self.params.update(params)
        return self

    def _set_predictor(self, predictor) -> "Dataset":
        """Continued training: the init scores become ``predictor``'s raw
        predictions at construction.  On a constructed Dataset the rows
        are binned again, which needs the raw data kept
        (``free_raw_data=False``), as in the JAX package."""
        if self._binned is not None and predictor is not None \
                and predictor is not self._predictor:
            if self.data is None or self.free_raw_data:
                raise LightGBMError(
                    "Cannot set predictor after construction (set "
                    "free_raw_data=False to allow continued training on "
                    "a constructed Dataset)")
            self._binned = None
        self._predictor = predictor
        return self

    def _file_layout(self, cfg: Config):
        """(label column index, column roles or None) of the file
        ``data``: the label against the full header, the other roles
        against the header without the label (dataset_loader.cpp
        SetHeader)."""
        full_names = read_header(self.data)[0] if cfg.has_header else None
        label_idx = resolve_label_idx(cfg.label_column, full_names)
        names = None
        if full_names is not None:
            names = full_names[:label_idx] + full_names[label_idx + 1:]
        elif self.feature_name not in ("auto", None):
            names = list(self.feature_name)
        roles = None
        if (cfg.weight_column or cfg.group_column or cfg.ignore_column
                or cfg.categorical_column):
            roles = resolve_roles(cfg.weight_column, cfg.group_column,
                                  cfg.ignore_column, cfg.categorical_column,
                                  feature_names=names)
        return label_idx, roles

    def _guard(self, cfg: Config) -> IngestGuard:
        return IngestGuard(self.data, policy=cfg.bad_data_policy,
                           max_bad_rows=cfg.max_bad_rows,
                           max_bad_row_fraction=cfg.max_bad_row_fraction)

    def _read_file(self, cfg: Config, label_idx: int, guard: IngestGuard):
        """(features, label) of the file ``data`` in one round, its bad
        lines through ``guard``, densified to the reference's width for a
        valid set; the header's names become ``feature_name`` unless it
        was given."""
        width = None
        if self.reference is not None:
            width = self.reference.construct()._binned.num_total_features
        label, X, header = parse_file(self.data, has_header=cfg.has_header,
                                      label_idx=label_idx,
                                      num_features=width, guard=guard)
        if not len(label):
            raise LightGBMError(f"{self.data}: no data rows")
        if header and self.feature_name == "auto":
            self.feature_name = header
        return X, label

    def _load_two_round(self, cfg: Config, label_idx: int, roles):
        """The binned dataset of the file ``data`` from the two-round
        loader (``io/streaming.py``).  Categorical names resolve before
        the load, against ``feature_name`` or the file's header."""
        names = (None if self.feature_name in ("auto", None)
                 else list(self.feature_name))
        if names is None and cfg.has_header:
            names = read_header_names(self.data, label_idx)
        cat = set(roles.categorical if roles is not None else ())
        for c in ([] if self.categorical_feature in ("auto", None)
                  else self.categorical_feature):
            if isinstance(c, str):
                if names is None or c not in names:
                    raise LightGBMError(
                        f"Unknown categorical feature name {c!r} (two-round "
                        f"loading resolves names from the file header)")
                cat.add(names.index(c))
            else:
                cat.add(int(c))
        ref = (self.reference.construct()._binned
               if self.reference is not None else None)
        binned = load_file_two_round(
            self.data, has_header=cfg.has_header, label_idx=label_idx,
            guard=self._guard(cfg), max_bin=cfg.max_bin,
            min_data_in_bin=cfg.min_data_in_bin,
            min_data_in_leaf=cfg.min_data_in_leaf,
            bin_construct_sample_cnt=cfg.bin_construct_sample_cnt,
            categorical_features=sorted(cat),
            ignore_features=roles.ignore if roles is not None else (),
            weight_idx=roles.weight_idx if roles is not None else -1,
            group_idx=roles.group_idx if roles is not None else -1,
            data_random_seed=cfg.data_random_seed, reference=ref,
            enable_bundle=cfg.enable_bundle,
            max_conflict_rate=cfg.max_conflict_rate,
            is_enable_sparse=cfg.is_enable_sparse)
        if self.feature_name not in ("auto", None) and \
                len(self.feature_name) == binned.num_total_features:
            binned.feature_names = list(self.feature_name)
        return binned

    def _streamed_init_scores(self, cfg: Config, label_idx: int
                              ) -> np.ndarray:
        """The predictor's raw scores of a two-round file, read again in
        chunks (never the whole float matrix) through a shadow guard:
        the two-round load classified and counted the bad rows, and this
        pass skips the same ones without counting them again or writing
        the sink, so the scores align with the binned rows."""
        width = (self._binned.num_total_features
                 if _probe_format(self.data, cfg.has_header) == "libsvm"
                 else None)
        # the policy without the budgets, which the load has passed
        shadow = IngestGuard(self.data, policy=cfg.bad_data_policy,
                             record=False)
        return np.concatenate([
            np.asarray(self._predictor.predict(X, raw_score=True))
            for _, X in parse_file_chunks(self.data, cfg.has_header,
                                          label_idx, num_features=width,
                                          guard=shadow)], axis=0)

    def _categorical_indices(self, extra=()) -> List[int]:
        cat = self.categorical_feature
        names = (None if self.feature_name in ("auto", None)
                 else list(self.feature_name))
        out = set(extra)
        for c in ([] if cat in ("auto", None) else cat):
            if isinstance(c, str):
                if names is None or c not in names:
                    raise LightGBMError(
                        f"Unknown categorical feature name {c!r}")
                out.add(names.index(c))
            else:
                out.add(int(c))
        return sorted(out)

    def construct(self) -> "Dataset":
        if self._binned is not None:
            return self
        if self.used_indices is not None:
            # a subset of a constructed reference (reference subset(),
            # basic.py:820-837): its metadata comes with the rows
            self._binned = self.reference.construct()._binned.subset(
                self.used_indices)
            return self
        # the argument's max_bin unless params set one (JAX basic.py)
        cfg = Config({"max_bin": self.max_bin, **self.params,
                      "task": "train"})
        roles = None
        label = self.label
        guard = None
        streamed = False
        data = None
        if isinstance(self.data, str) and \
                BinnedDataset.is_binary_file(self.data):
            return self._load_binary()
        if isinstance(self.data, str):
            label_idx, roles = self._file_layout(cfg)
            if cfg.use_two_round_loading:
                self._binned = self._load_two_round(cfg, label_idx, roles)
                streamed = True
            else:
                guard = self._guard(cfg)
                data, file_label = self._read_file(cfg, label_idx, guard)
                if label is None:
                    label = file_label
        else:
            if _has_roles(cfg):
                log.warn_once(
                    "roles_on_matrix",
                    "column roles (label/weight/group/ignore/categorical "
                    "_column) apply to data files; ignored for an "
                    "in-memory matrix")
            data, self.feature_name, self.categorical_feature = \
                _data_from_pandas(self.data, self.feature_name,
                                  self.categorical_feature)
            data = _to_dense(data)
        if not streamed and self.reference is not None:
            self._binned = self.reference.construct()._binned.create_valid(
                data, label)
        elif not streamed:
            names = (None if self.feature_name in ("auto", None)
                     else list(self.feature_name))
            self._binned = BinnedDataset.from_matrix(
                data, label, max_bin=cfg.max_bin,
                min_data_in_bin=cfg.min_data_in_bin,
                min_data_in_leaf=cfg.min_data_in_leaf,
                bin_construct_sample_cnt=cfg.bin_construct_sample_cnt,
                categorical_features=self._categorical_indices(
                    roles.categorical if roles is not None else ()),
                ignore_features=roles.ignore if roles is not None else (),
                feature_names=names,
                data_random_seed=cfg.data_random_seed,
                enable_bundle=cfg.enable_bundle,
                max_conflict_rate=cfg.max_conflict_rate,
                is_enable_sparse=cfg.is_enable_sparse,
                keep_raw=cfg.linear_tree)
        md = self._binned.metadata
        # the JAX package's order: the arguments, then the side files
        # over them, then the file's weight and group columns over both
        # where no argument was given (Metadata::Init,
        # dataset_loader.cpp:101-131).  The two-round loader has read
        # the side files and the columns already, so there the
        # arguments come last.
        if streamed and label is not None:
            md.set_label(label)
        if self.weight is not None:
            md.set_weights(self.weight)
        if self.group is not None:
            md.set_query(self.group)
        if self.init_score is not None:
            md.set_init_score(self.init_score)
        if guard is not None:
            # quarantined rows leave positional side files unalignable:
            # a named refusal, not a silent shift
            check_side_files_alignment(self.data, guard.bad_total)
        if isinstance(self.data, str) and not streamed:
            md.load_side_files(self.data)
        if roles is not None and not streamed:
            for what, idx in (("weight_column", roles.weight_idx),
                              ("group_column", roles.group_idx)):
                if idx >= data.shape[1]:
                    log.fatal("%s index %d out of range (file has %d "
                              "feature columns)", what, idx, data.shape[1])
            if roles.weight_idx >= 0 and self.weight is None:
                md.set_weights(data[:, roles.weight_idx])
            if roles.group_idx >= 0 and self.group is None:
                md.set_query_id(data[:, roles.group_idx])
        if self._predictor is not None:
            # continued training (dataset_loader.cpp:10): the init model's
            # raw predictions, class-major for multiclass
            raw = (self._streamed_init_scores(cfg, label_idx) if streamed
                   else np.asarray(self._predictor.predict(data,
                                                           raw_score=True)))
            md.set_init_score(raw.reshape(-1, order="F"))
        if self.free_raw_data:
            self.data = None
        return self

    def _load_binary(self) -> "Dataset":
        """The binned dataset of a binary file (``save_binary``), with the
        label, weights, groups and init scores given as arguments over
        those the file holds."""
        if self._predictor is not None:
            raise LightGBMError(
                "Cannot set an init model on a binary dataset file: its "
                "raw rows are not kept")
        self._binned = BinnedDataset.load_binary(self.data)
        md = self._binned.metadata
        for value, setter in ((self.label, md.set_label),
                              (self.weight, md.set_weights),
                              (self.group, md.set_query),
                              (self.init_score, md.set_init_score)):
            if value is not None:
                setter(value)
        return self

    def subset(self, used_indices, params=None) -> "Dataset":
        """The rows ``used_indices`` of this Dataset on its mappers, with
        ``params`` (default this Dataset's own)."""
        sub = Dataset(None, reference=self, feature_name=self.feature_name,
                      categorical_feature=self.categorical_feature,
                      params=params or self.params)
        sub.used_indices = np.asarray(used_indices)
        return sub

    def create_valid(self, data, label=None, weight=None, group=None,
                     silent: bool = False, params=None,
                     init_score=None) -> "Dataset":
        """A valid Dataset binned with this one's mappers (and bundle
        plan)."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, silent=silent, params=params,
                       init_score=init_score)

    # -- fields: the label set before or after construction; all read
    # after it (a custom fobj or feval reads them)
    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._binned is not None and label is not None:
            self._binned.metadata.set_label(label)
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self._binned is not None and weight is not None:
            self._binned.metadata.set_weights(weight)
        return self

    def set_group(self, group) -> "Dataset":
        """Query sizes, in row order."""
        self.group = group
        if self._binned is not None and group is not None:
            self._binned.metadata.set_query(group)
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        if self._binned is not None and init_score is not None:
            self._binned.metadata.set_init_score(init_score)
        return self

    def set_reference(self, reference) -> "Dataset":
        if self._binned is not None:
            raise LightGBMError("Cannot set reference after construction")
        self.reference = reference
        return self

    def set_feature_name(self, feature_name) -> "Dataset":
        self.feature_name = feature_name
        if self._binned is not None and feature_name not in (None, "auto"):
            self._binned.feature_names = list(feature_name)
        return self

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        """As in the JAX package, ``train``'s argument replaces the
        Dataset's own, its default ``"auto"`` too."""
        if self._binned is not None and \
                categorical_feature != self.categorical_feature:
            raise LightGBMError(
                "Cannot set categorical feature after construction")
        self.categorical_feature = categorical_feature
        return self

    def get_label(self):
        return self.construct()._binned.metadata.label

    def get_weight(self):
        return self.construct()._binned.metadata.weights

    def get_group(self):
        qb = self.construct()._binned.metadata.query_boundaries
        return None if qb is None else np.diff(qb)

    def get_init_score(self):
        return self.construct()._binned.metadata.init_score

    def num_data(self) -> int:
        return self.construct()._binned.num_data

    def num_feature(self) -> int:
        return self.construct()._binned.num_total_features

    def save_binary(self, filename: str) -> "Dataset":
        """Write the binned dataset to ``filename`` in the JAX package's
        binary format (``io/dataset.py`` ``save_binary``)."""
        self.construct()._binned.save_binary(filename)
        return self


def _has_roles(cfg: Config) -> bool:
    return any(str(cfg[k]).strip() for k in (
        "label_column", "weight_column", "group_column", "ignore_column",
        "categorical_column"))


class Booster:
    """A model on ``device`` (default ``cuda``; pass ``"cpu"`` for the
    plain PyTorch versions on the host): loaded with
    ``Booster(model_file=...)`` / ``Booster(model_str=...)``, or trained
    with ``Booster(params=..., train_set=Dataset(...))`` and
    ``update()``."""

    def __init__(self, model_file: Optional[str] = None,
                 model_str: Optional[str] = None, params=None,
                 device: DeviceLike = None,
                 train_set: Optional[Dataset] = None, silent: bool = False):
        given = sum(x is not None for x in (model_file, model_str,
                                            train_set))
        if given != 1:
            raise TypeError("pass exactly one of model_file, model_str or "
                            "train_set")
        self.device = resolve_device(device)
        self._forest = None          # (num_iteration, CompiledForest)
        self.best_iteration = -1
        self._attr: Dict[str, str] = {}
        self._train_data_name = "training"
        self._train_set = train_set
        self._valid_sets: List[Dataset] = []
        self._name_valid_sets: List[str] = []
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("Training data should be Dataset instance, "
                                f"met {type(train_set).__name__}")
            params = dict(params or {})
            train_set._update_params(params).construct()
            self.config = Config({**train_set.params, **params,
                                  "task": "train"})
            self._booster = create_boosting(self.config, train_set._binned,
                                            device=self.device)
            return
        self.config = Config({**dict(params or {}), "task": "predict"})
        if model_file is not None:
            with open(model_file) as fh:
                model_str = fh.read()
        self._booster = create_boosting(self.config, model_str=model_str)

    # -- training --------------------------------------------------------
    def set_train_data_name(self, name: str) -> "Booster":
        self._train_data_name = name
        return self

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        if self._train_set is None:
            raise LightGBMError("add_valid needs a Booster built from a "
                                "train_set")
        if not isinstance(data, Dataset):
            raise TypeError("Validation data should be Dataset instance, "
                            f"met {type(data).__name__}")
        data.construct()
        self._booster.add_valid_dataset(data._binned)
        self._valid_sets.append(data)
        self._name_valid_sets.append(name)
        return self

    def update(self, train_set: Optional[Dataset] = None,
               fobj=None) -> bool:
        """One boosting round; True when no leaf could split (training
        should stop).  ``fobj(preds, train_set) -> (grad, hess)`` is a
        custom objective: ``preds`` are the raw training scores and the
        gradients come back class-major, ``num_class * num_data`` values
        each (train with ``objective=none``).  ``train_set`` may only be
        the Booster's own, as in the JAX package."""
        if self._train_set is None:
            raise LightGBMError("update needs a Booster built from a "
                                "train_set")
        if train_set is not None and train_set is not self._train_set:
            raise LightGBMError("Replacing train_set is not supported; "
                                "create a new Booster")
        self._forest = None
        if fobj is None:
            return self._booster.train_one_iter()
        grad, hess = fobj(self._inner_predict(0), self._train_set)
        grad = np.asarray(grad, np.float32)
        hess = np.asarray(hess, np.float32)
        n = self._booster.num_data * self._booster.num_class
        if grad.size != n or hess.size != n:
            raise ValueError(
                f"Lengths of gradient({grad.size}) and hessian({hess.size}) "
                f"don't match training data ({n})")
        return self._booster.train_one_iter(grad, hess)

    def reset_parameter(self, params) -> "Booster":
        """New parameters between rounds (``GBDT.reset_config``): a
        learning rate, or grower settings, which rebuild the grower."""
        self.config = Config({**self.config.raw, **params})
        self._booster.reset_config(self.config)
        self._forest = None
        return self

    def rollback_one_iter(self) -> "Booster":
        """Undo the last round (into an init model's rounds too)."""
        self._booster.rollback_one_iter()
        self._forest = None
        return self

    def merge(self, other: "Booster",
              shrinkage_decay: Optional[float] = None) -> "Booster":
        """Append ``other``'s trees with their outputs scaled by
        ``shrinkage_decay`` (default: the ``shrinkage_decay`` parameter,
        1.0), so the merged model predicts ``self + decay * other`` in raw
        scores; refuses models of other class counts, feature widths or
        objectives.  ``other`` is not touched.  Returns self."""
        if not isinstance(other, Booster):
            raise TypeError(
                f"Booster.merge expects a Booster, got {type(other).__name__}")
        if shrinkage_decay is None:
            shrinkage_decay = self.config.shrinkage_decay
        self._booster.merge_from(other._booster,
                                 shrinkage_decay=float(shrinkage_decay))
        self._forest = None
        return self

    def _to_predictor(self) -> "Booster":
        return self

    def current_iteration(self) -> int:
        return self._booster.iter_

    def _inner_predict(self, data_idx: int) -> np.ndarray:
        """Raw scores of the training set (0) or valid set i (i + 1),
        flattened class-major."""
        b = self._booster
        dd = b.train_data if data_idx == 0 else b.valid_data[data_idx - 1]
        return dd.host_score().reshape(-1)

    def _eval_at(self, data_idx: int, name: str, feval=None) -> List[tuple]:
        key = "training" if data_idx == 0 else f"valid_{data_idx}"
        out = [(name,) + r for r in self._booster.eval_set(key)]
        if feval is not None:
            ds = (self._train_set if data_idx == 0
                  else self._valid_sets[data_idx - 1])
            ret = feval(self._inner_predict(data_idx), ds)
            if isinstance(ret, list):
                out += [(name,) + tuple(r) for r in ret]
            elif ret is not None:
                out.append((name,) + tuple(ret))
        return out

    def eval(self, data: Dataset, name: str, feval=None) -> List[tuple]:
        """The metrics of ``data``, the training set or a valid set,
        under ``name``."""
        for i, vs in enumerate(self._valid_sets):
            if vs is data:
                return self._eval_at(i + 1, name, feval)
        if data is self._train_set:
            return self.eval_train(feval)
        raise LightGBMError("Data should be either train or a valid set")

    def eval_train(self, feval=None) -> List[tuple]:
        """[(data name, metric name, value, bigger is better)] on the
        training set; ``feval(preds, dataset)`` adds a custom metric's
        (name, value, bigger is better), or a list of them."""
        return self._eval_at(0, self._train_data_name, feval)

    def eval_valid(self, feval=None) -> List[tuple]:
        return [r for i, name in enumerate(self._name_valid_sets)
                for r in self._eval_at(i + 1, name, feval)]

    def num_trees(self) -> int:
        return self._booster.num_trees()

    def model_to_string(self, num_iteration: int = -1) -> str:
        return self._booster.save_model_to_string(num_iteration)

    def save_model(self, filename: str, num_iteration: int = -1) -> "Booster":
        """Write the model text atomically (``utils/diskguard.py``): a
        failed save is a named ``SinkWriteError`` (sink ``model_file``)
        and keeps the previous file."""
        from .utils.diskguard import write_artifact_atomic
        write_artifact_atomic(filename,
                              self.model_to_string(num_iteration).encode(),
                              "model_file")
        return self

    def save_snapshot(self, directory: str, evals_result=None,
                      keep: int = 0, rounds_done=None) -> Optional[str]:
        """Write a checksummed training snapshot into ``directory``
        (atomic tmp + ``os.replace``; ``snapshot.py``) and return its
        path; under several ranks only rank 0 writes (None elsewhere).
        ``engine.train`` does this every ``snapshot_freq`` rounds; this
        is the hook for a loop of ``update()`` calls.  ``rounds_done``
        defaults to the rounds this booster trained; a resume through
        ``engine.train`` reads it as the loop's rounds already run."""
        from .snapshot import save_snapshot
        gb = self._booster
        if rounds_done is None:
            rounds_done = gb.iter_ - gb.num_init_iteration
        return save_snapshot(directory, self, int(rounds_done),
                             evals_result=evals_result, keep=keep)

    def restore_snapshot(self, directory_or_state) -> int:
        """Restore this new booster (same params and data) from the
        newest valid snapshot of a directory, or from a state dict;
        returns the rounds done."""
        from .snapshot import load_latest_snapshot, restore_booster_state
        state = directory_or_state
        if isinstance(state, str):
            found = load_latest_snapshot(state)
            if found is None:
                raise LightGBMError(
                    f"no valid snapshot found in {directory_or_state!r}")
            _, state = found
        return restore_booster_state(self, state)

    def compile(self, num_iteration: int = -1, buckets=None,
                warmup: bool = False):
        """Freeze the model into a ``CompiledForest`` on this booster's
        device (the artifact ``predict`` and the server use).
        ``warmup=True`` builds the walk kernel and launches it once a
        bucket, so no later predict pays the build or a first launch."""
        from .serve.forest import CompiledForest
        cf = CompiledForest.from_booster(
            self, device=self.device, num_iteration=num_iteration,
            buckets=buckets or list(self.config.predict_buckets) or None)
        if warmup:
            cf.warmup()
        self._forest = (int(num_iteration), cf)
        return cf

    def _compiled(self, num_iteration: int):
        """The forest ``predict`` walks: its buckets' transfers are the
        training side's ``predict`` account."""
        if self._forest is None or self._forest[0] != int(num_iteration):
            self.compile(num_iteration)
            self._forest[1]._xfer_phase = "predict"
        return self._forest[1]

    #: data rows a chunk of a predicted file
    _PREDICT_CHUNK_ROWS = 1 << 16

    def predict(self, data, num_iteration: int = -1,
                raw_score: bool = False, pred_leaf: bool = False,
                data_has_header: bool = False,
                is_reshape: bool = True) -> np.ndarray:
        """``[N]`` for one class, ``[N, K]`` for multiclass (``[N * K]``,
        class-major, with ``is_reshape=False``): host f64 binning, the
        binned forest-walk kernel, then the objective's transform in f64
        unless ``raw_score``.  ``pred_leaf``: ``[N, num_trees]`` int32,
        each row's leaf in each tree, by the f64 host walk (the JAX
        package's ``predict_leaf_index``).  ``data`` is a matrix (numpy,
        scipy sparse, pandas or lists) or the path of a data file
        (``data_has_header``), predicted chunk by chunk
        (:meth:`predict_chunks`)."""
        b = self._booster
        if isinstance(data, str):
            parts = list(self.predict_chunks(
                data, num_iteration=num_iteration, raw_score=raw_score,
                pred_leaf=pred_leaf, data_has_header=data_has_header))
            if not parts:
                # an empty file keeps the shape contract
                parts.append(self._predict_array(
                    np.zeros((0, b.max_feature_idx + 1)), num_iteration,
                    raw_score, pred_leaf))
            out = np.concatenate(parts, axis=0 if pred_leaf else -1)
        else:
            data, _, _ = _data_from_pandas(data, "auto", "auto")
            out = self._predict_array(_to_dense(data), num_iteration,
                                      raw_score, pred_leaf)
        if pred_leaf:
            return out
        if out.shape[0] == 1:
            return out[0]
        return out.T if is_reshape else out.reshape(-1)

    def predict_chunks(self, data_path: str, num_iteration: int = -1,
                       raw_score: bool = False, pred_leaf: bool = False,
                       data_has_header: bool = False):
        """Yield the predictions of a data file chunk by chunk, one array
        per ``_PREDICT_CHUNK_ROWS`` parsed rows: ``[num_class, n]`` (or
        ``[n, num_trees]`` for ``pred_leaf``), so a caller can stream
        the results.  The label column is the model's; each chunk is
        densified to the model's width."""
        b = self._booster
        for _, X in parse_file_chunks(
                data_path, has_header=data_has_header,
                label_idx=b.label_idx, num_features=b.max_feature_idx + 1,
                chunk_rows=self._PREDICT_CHUNK_ROWS):
            if X.size == 0:
                continue
            yield self._predict_array(X, num_iteration, raw_score,
                                      pred_leaf)

    def _predict_array(self, X: np.ndarray, num_iteration: int,
                       raw_score: bool, pred_leaf: bool) -> np.ndarray:
        """``[num_class, n]`` predictions of the rows ``X`` (``[n,
        num_trees]`` leaf indices for ``pred_leaf``)."""
        b = self._booster
        if pred_leaf:
            return b.predict_leaf_index(X, num_iteration)
        if b.num_trees() == 0 or X.shape[0] == 0:
            raw = np.zeros((b.num_class, X.shape[0]), np.float64)
        else:
            raw = self._compiled(num_iteration).raw_scores(X)
        return raw if raw_score else np.asarray(
            b.objective.convert_output(raw))

    # -- telemetry (obs/) ------------------------------------------------
    def set_event_recorder(self, recorder) -> "Booster":
        """Attach an ``obs.EventRecorder`` for the per-iteration JSONL
        event stream (``train``'s ``events_file`` does this); the caller
        owns the recorder and closes it.  ``None`` detaches."""
        self._booster.set_event_recorder(recorder)
        return self

    def telemetry(self) -> Dict[str, Any]:
        """The process registry's snapshot (``counters``, ``gauges``,
        ``histograms`` and ``phase_seconds``, the TIMETAG totals when
        TIMETAG is on) and this booster's collective account (``comm``:
        cumulative bytes and calls, the per-tree traffic of a
        distributed learner)."""
        from . import obs
        snap = obs.snapshot()
        b = self._booster
        snap["comm"] = {
            "bytes_cum": int(getattr(b, "_cum_comm_bytes", 0)),
            "calls_cum": int(getattr(b, "_cum_comm_calls", 0)),
            "per_tree": getattr(b, "_comm_traffic", None),
        }
        return snap

    # -- introspection ---------------------------------------------------
    def dump_model(self, num_iteration: int = -1) -> dict:
        """The model as a JSON-style dict (reference dump_model,
        basic.py:1522; trees by ``Tree.to_json``)."""
        b = self._booster
        n_models = len(b.models)
        if num_iteration > 0:
            n_models = min(n_models, num_iteration * b.num_class)
        return {
            "name": "tree",
            "num_class": b.num_class,
            "label_index": b.label_idx,
            "max_feature_idx": b.max_feature_idx,
            "feature_names": list(b.feature_names),
            "tree_info": [b.models[i].to_json() for i in range(n_models)],
        }

    def feature_name(self) -> List[str]:
        return list(self._booster.feature_names)

    def feature_importance(self, importance_type: str = "split"
                           ) -> np.ndarray:
        """Per feature, the number of splits on it (``split``, int64) or
        the sum of their gains (``gain``, f64), over every tree."""
        return self._booster.feature_importance(importance_type)

    def attr(self, key: str) -> Optional[str]:
        return self._attr.get(key)

    def set_attr(self, **kwargs) -> "Booster":
        """Set string attributes; a value of None deletes the key."""
        for k, v in kwargs.items():
            if v is None:
                self._attr.pop(k, None)
            else:
                self._attr[k] = str(v)
        return self

    # -- pickling through the model text (basic.py:1243-1262) ------------
    def __getstate__(self):
        state = self.__dict__.copy()
        for key in ("_booster", "_train_set", "_valid_sets", "_forest",
                    "config"):
            state.pop(key, None)
        state["device"] = str(self.device)
        state["_model_str"] = self.model_to_string()
        return state

    def __setstate__(self, state):
        """A predict-only Booster on the pickled Booster's device; its
        ``CompiledForest`` is rebuilt at the first prediction."""
        state = dict(state)
        model_str = state.pop("_model_str")
        self.__dict__.update(state)
        self.device = resolve_device(state["device"])
        self._forest = None
        self._train_set = None
        self._valid_sets = []
        self.config = Config({"task": "predict"})
        self._booster = create_boosting(self.config, model_str=model_str)

    def __copy__(self):
        return self.__deepcopy__(None)

    def __deepcopy__(self, _):
        new = Booster.__new__(Booster)
        new.__setstate__(self.__getstate__())
        return new
