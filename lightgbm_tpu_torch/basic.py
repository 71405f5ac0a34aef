"""``Dataset`` and ``Booster``: the Python front door of the port.

Port of the JAX package's basic.py for the slices ported so far.
``Dataset`` bins an in-memory matrix or a data file lazily
(``from_matrix``, or ``create_valid`` against a ``reference``), with its
metadata: weights, query sizes and initial scores from arguments, side
files or the file's own columns, or a row ``subset`` of another
Dataset on its mappers (the folds of ``cv``); with a predictor (an init
model, ``engine.train``) its init scores are the predictor's raw
predictions.  ``Booster`` either loads a model
(``model_file=`` / ``model_str=``) or trains one (``params=``,
``train_set=``; ``update()`` runs one boosting round, from a custom
``fobj`` too, ``add_valid()`` attaches a valid set, ``eval_*`` take a
custom ``feval``, ``reset_parameter`` / ``rollback_one_iter`` /
``merge`` change the model between rounds).  ``predict`` bins rows on
the host in f64 and walks them through the forest-walk kernel
(``serve/forest.py`` ``CompiledForest``), so on a card every prediction
runs the kernel; ``pred_leaf=True`` gives each row's leaf in every tree
by the f64 host walk, as the JAX package does.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from .config import Config
from .device import DeviceLike, resolve_device
from .io.column_roles import resolve_label_idx, resolve_roles
from .io.dataset import BinnedDataset
from .io.parser import parse_file, read_header
from .models import create_boosting
from .utils import log
from .utils.log import LightGBMError


class Dataset:
    """A raw ``[N, F]`` matrix or a data file, binned at first use
    (``construct``).

    ``data`` is a matrix or the path of a CSV, TSV or LibSVM file; a
    file's label is its ``label_column`` (default column 0), and
    ``<data>.weight``, ``.query`` and ``.init`` beside it are loaded, for
    a valid set too.  ``params`` carries the binning keys (``max_bin``,
    ``min_data_in_bin``, ``min_data_in_leaf``,
    ``bin_construct_sample_cnt``, ``data_random_seed``,
    ``enable_bundle``, ``max_conflict_rate``, and ``linear_tree``, which
    keeps the raw values the linear fit reads), ``has_header`` and, for a
    file, the column roles (``weight_column``, ``group_column``,
    ``ignore_column``, ``categorical_column``; io/column_roles.py), whose
    weight and group columns override the side files.
    ``reference`` bins with another Dataset's mappers (a valid set).
    ``weight``, ``group`` (query sizes) and ``init_score`` (class-major)
    set the metadata of a matrix; for a file, its side files override
    them, as in the JAX package.  ``categorical_feature`` lists column
    indices, or names of ``feature_name``.  ``free_raw_data`` drops
    ``data`` once binned; a constructed Dataset can then take no init
    model (``train(init_model=)``), as in the JAX package."""

    def __init__(self, data, label=None, reference: "Dataset" = None,
                 weight=None, group=None, init_score=None,
                 feature_name="auto", categorical_feature="auto",
                 params=None, free_raw_data: bool = True):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
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

    def _read_file(self, cfg: Config):
        """(features, label, column roles or None) of the file ``data``,
        densified to the reference's width for a valid set; the header's
        names become ``feature_name`` unless it was given."""
        path = self.data
        full_names = read_header(path)[0] if cfg.has_header else None
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
        width = None
        if self.reference is not None:
            width = self.reference.construct()._binned.num_total_features
        label, X, header = parse_file(path, has_header=cfg.has_header,
                                      label_idx=label_idx,
                                      num_features=width)
        if not len(label):
            raise LightGBMError(f"{path}: no data rows")
        if header and self.feature_name == "auto":
            self.feature_name = header
        return X, label, roles

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
        cfg = Config({**self.params, "task": "train"})
        roles = None
        label = self.label
        if isinstance(self.data, str):
            data, file_label, roles = self._read_file(cfg)
            if label is None:
                label = file_label
        else:
            if _has_roles(cfg):
                log.warn_once(
                    "roles_on_matrix",
                    "column roles (label/weight/group/ignore/categorical "
                    "_column) apply to data files; ignored for an "
                    "in-memory matrix")
            data = np.asarray(self.data, dtype=np.float64)
        if self.reference is not None:
            self._binned = self.reference.construct()._binned.create_valid(
                data, label)
        else:
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
        # dataset_loader.cpp:101-131)
        if self.weight is not None:
            md.set_weights(self.weight)
        if self.group is not None:
            md.set_query(self.group)
        if self.init_score is not None:
            md.set_init_score(self.init_score)
        if isinstance(self.data, str):
            md.load_side_files(self.data)
        if roles is not None:
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
            raw = np.asarray(self._predictor.predict(data, raw_score=True))
            md.set_init_score(raw.reshape(-1, order="F"))
        if self.free_raw_data:
            self.data = None
        return self

    def subset(self, used_indices) -> "Dataset":
        """The rows ``used_indices`` of this Dataset on its mappers."""
        sub = Dataset(None, reference=self, feature_name=self.feature_name,
                      categorical_feature=self.categorical_feature,
                      params=self.params)
        sub.used_indices = np.asarray(used_indices)
        return sub

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        """A valid Dataset binned with this one's mappers."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score, params=params)

    # -- fields: the label set before or after construction; all read
    # after it (a custom fobj or feval reads them)
    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._binned is not None and label is not None:
            self._binned.metadata.set_label(label)
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        if self._binned is not None and init_score is not None:
            self._binned.metadata.set_init_score(init_score)
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
                 train_set: Optional[Dataset] = None):
        given = sum(x is not None for x in (model_file, model_str,
                                            train_set))
        if given != 1:
            raise TypeError("pass exactly one of model_file, model_str or "
                            "train_set")
        self.device = resolve_device(device)
        self._forest = None          # (num_iteration, CompiledForest)
        self.best_iteration = -1
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
                                            self.device)
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

    def update(self, fobj=None) -> bool:
        """One boosting round; True when no leaf could split (training
        should stop).  ``fobj(preds, train_set) -> (grad, hess)`` is a
        custom objective: ``preds`` are the raw training scores and the
        gradients come back class-major, ``num_class * num_data`` values
        each (train with ``objective=none``)."""
        if self._train_set is None:
            raise LightGBMError("update needs a Booster built from a "
                                "train_set")
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
        """Write the model text atomically (tmp file + replace), so a
        failed save keeps the previous file."""
        tmp = f"{filename}.tmp{os.getpid()}"
        with open(tmp, "w") as fh:
            fh.write(self.model_to_string(num_iteration))
        os.replace(tmp, filename)
        return self

    def compile(self, num_iteration: int = -1, buckets=None):
        """Freeze the model into a ``CompiledForest`` on this booster's
        device (the artifact ``predict`` and the server use)."""
        from .serve.forest import CompiledForest
        cf = CompiledForest.from_booster(
            self, device=self.device, num_iteration=num_iteration,
            buckets=buckets or list(self.config.predict_buckets) or None)
        self._forest = (int(num_iteration), cf)
        return cf

    def _compiled(self, num_iteration: int):
        if self._forest is None or self._forest[0] != int(num_iteration):
            self.compile(num_iteration)
        return self._forest[1]

    def predict(self, data, num_iteration: int = -1,
                raw_score: bool = False, pred_leaf: bool = False) -> np.ndarray:
        """``[N]`` for one class, ``[N, K]`` for multiclass: host f64
        binning, the binned forest-walk kernel, then the objective's
        transform in f64 unless ``raw_score``.  ``pred_leaf``: ``[N,
        num_trees]`` int32, each row's leaf in each tree, by the f64 host
        walk (the JAX package's ``predict_leaf_index``)."""
        X = np.asarray(data, np.float64)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        b = self._booster
        if pred_leaf:
            return b.predict_leaf_index(X, num_iteration)
        if b.num_trees() == 0:
            raw = np.zeros((b.num_class, X.shape[0]), np.float64)
        else:
            raw = self._compiled(num_iteration).raw_scores(X)
        out = raw if raw_score else np.asarray(
            b.objective.convert_output(raw))
        return out[0] if out.shape[0] == 1 else out.T
