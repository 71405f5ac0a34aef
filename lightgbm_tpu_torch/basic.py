"""``Dataset`` and ``Booster``: the Python front door of the port.

Port of the JAX package's basic.py for the slices ported so far.
``Dataset`` bins an in-memory matrix lazily (``from_matrix``, or
``create_valid`` against a ``reference``).  ``Booster`` either loads a
model (``model_file=`` / ``model_str=``) or trains one
(``params=``, ``train_set=``; ``update()`` runs one boosting round,
``add_valid()`` attaches a valid set).  ``predict`` bins rows on the host
in f64 and walks them through the forest-walk kernel
(``serve/forest.py`` ``CompiledForest``), so on a card every prediction
runs the kernel.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from .config import Config
from .device import DeviceLike, resolve_device
from .io.dataset import BinnedDataset
from .models.gbdt import GBDT
from .utils.log import LightGBMError


class Dataset:
    """A raw ``[N, F]`` matrix and its label, binned at first use
    (``construct``).  ``reference`` bins with another Dataset's mappers
    (a valid set); ``params`` carries the binning keys (``max_bin``,
    ``min_data_in_bin``, ``min_data_in_leaf``,
    ``bin_construct_sample_cnt``, ``data_random_seed``,
    ``enable_bundle``, ``max_conflict_rate``, and ``linear_tree``, which
    keeps the raw values the linear fit reads); ``categorical_feature``
    lists column indices."""

    def __init__(self, data, label=None, reference: "Dataset" = None,
                 params=None, categorical_feature="auto"):
        self.data = data
        self.label = label
        self.reference = reference
        self.params = dict(params or {})
        self.categorical_feature = categorical_feature
        self._binned = None

    def _update_params(self, params) -> "Dataset":
        if self._binned is None:
            self.params.update(params)
        return self

    def construct(self) -> "Dataset":
        if self._binned is not None:
            return self
        data = np.asarray(self.data, dtype=np.float64)
        if self.reference is not None:
            self._binned = self.reference.construct()._binned.create_valid(
                data, self.label)
            return self
        cfg = Config({**self.params, "task": "train"})
        cat = self.categorical_feature
        self._binned = BinnedDataset.from_matrix(
            data, self.label, max_bin=cfg.max_bin,
            min_data_in_bin=cfg.min_data_in_bin,
            min_data_in_leaf=cfg.min_data_in_leaf,
            bin_construct_sample_cnt=cfg.bin_construct_sample_cnt,
            categorical_features=([] if cat in ("auto", None)
                                  else [int(c) for c in cat]),
            data_random_seed=cfg.data_random_seed,
            enable_bundle=cfg.enable_bundle,
            max_conflict_rate=cfg.max_conflict_rate,
            is_enable_sparse=cfg.is_enable_sparse,
            keep_raw=cfg.linear_tree)
        return self

    def create_valid(self, data, label=None) -> "Dataset":
        """A valid Dataset binned with this one's mappers."""
        return Dataset(data, label=label, reference=self)


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
        self._train_set = train_set
        self._name_valid_sets: List[str] = []
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("Training data should be Dataset instance, "
                                f"met {type(train_set).__name__}")
            params = dict(params or {})
            train_set._update_params(params).construct()
            self.config = Config({**train_set.params, **params,
                                  "task": "train"})
            self._booster = GBDT(self.config, train_set._binned,
                                 self.device)
            return
        self.config = Config({**dict(params or {}), "task": "predict"})
        if model_file is not None:
            with open(model_file) as fh:
                model_str = fh.read()
        self._booster = GBDT.from_string(model_str)

    # -- training --------------------------------------------------------
    def add_valid(self, data: Dataset, name: str) -> "Booster":
        if self._train_set is None:
            raise LightGBMError("add_valid needs a Booster built from a "
                                "train_set")
        if not isinstance(data, Dataset):
            raise TypeError("Validation data should be Dataset instance, "
                            f"met {type(data).__name__}")
        data.construct()
        self._booster.add_valid_dataset(data._binned)
        self._name_valid_sets.append(name)
        return self

    def update(self) -> bool:
        """One boosting round; True when no leaf could split (training
        should stop)."""
        if self._train_set is None:
            raise LightGBMError("update needs a Booster built from a "
                                "train_set")
        self._forest = None
        return self._booster.train_one_iter()

    def current_iteration(self) -> int:
        return self._booster.iter_

    def eval_train(self) -> List[tuple]:
        """[(data name, metric name, value, bigger is better)] on the
        training set."""
        return [("training",) + r for r in self._booster.eval_set("training")]

    def eval_valid(self) -> List[tuple]:
        return [(name,) + r for i, name in enumerate(self._name_valid_sets)
                for r in self._booster.eval_set(f"valid_{i + 1}")]

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
                raw_score: bool = False) -> np.ndarray:
        """``[N]`` for one class, ``[N, K]`` for multiclass: host f64
        binning, the binned forest-walk kernel, then the objective's
        transform in f64 unless ``raw_score``."""
        X = np.asarray(data, np.float64)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        b = self._booster
        if b.num_trees() == 0:
            raw = np.zeros((b.num_class, X.shape[0]), np.float64)
        else:
            raw = self._compiled(num_iteration).raw_scores(X)
        out = raw if raw_score else np.asarray(
            b.objective.convert_output(raw))
        return out[0] if out.shape[0] == 1 else out.T
