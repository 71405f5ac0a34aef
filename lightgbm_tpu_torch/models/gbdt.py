"""``GBDT``: the boosted forest, its model text, and serial training.

Port of the JAX package's models/gbdt.py.  The model-file half
(``save_model_to_string``, ``load_model_from_string``,
``_PredictionObjective``; reference gbdt.cpp:625-815) validates every
header field, tree section and the footer with the JAX loader's checks
and error texts; text after the ``feature importances`` block (the drift
fingerprint section) is kept verbatim and written back on save.

The training half is the serial binary slice: the device state of
``_DeviceData`` (feature-major and row-major bins, the [1, N] f32
score), one boosting round as plain torch calls (gradients -> the
grower that ``serial_grow`` selects -> ``score[cls] += delta``, the JAX
``_build_shared_train_step``), valid-set scoring through
``ops/predict.py``, the saturation pop of the JAX ``_flush_pending``
(gbdt.cpp:362-378) and the metrics.  Rounds run synchronously, with no
pipelining; the score buffers are updated in place.

``linear_tree=true`` (models/linear.py, docs/LINEAR_TREES.md) fits an
affine model in every leaf after any grower: the fit's intercepts
replace the grown leaf values, its delta replaces the grower's, valid
sets add the affine part, and the saved trees carry their
``leaf_coeff``/``leaf_feat`` sections.  It needs the raw feature values
(``Dataset`` keeps them when ``linear_tree`` is set).

Growers (``_serial_grow_kind``): ``ordered`` (default) is
``grow_tree_ordered``; ``cached``, ``fused`` and ``nocache`` are
``grow_tree`` with the matching ``SerialComm``.  ``nocache`` is the
``hist_cache`` step of ``memory_policy=degrade``, taken when
``histogram_pool_size`` bounds the per-leaf histogram cache below its
size (``_check_memory_budget``).  The JAX package's admission gate
against the device's memory (``MemoryBudgetExceeded``) and its
``score_donation`` and ``row_pad`` steps are not ported.
"""

from __future__ import annotations

import io
import re
from typing import Dict, List, Optional

import numpy as np
import torch

from ..metric import create_metric
from ..objective import create_objective
from ..ops.grow import (GrowParams, SerialComm, _read, grow_tree,
                        pack_tree_arrays, unpack_tree_arrays)
from ..ops.ordered_grow import grow_tree_ordered
from ..ops.predict import predict_binned_tree
from ..utils import log, resource
from ..utils.log import LightGBMError
from .linear import (LeafModels, LinearParams, affine_epilogue,
                     attach_linear, fit_leaf_models)
from .tree import Tree


def estimate_train_memory(num_data: int, num_features: int, num_leaves: int,
                          max_bin: int, num_models: int,
                          bin_itemsize: int = 1, *,
                          leaf_cache: bool = True) -> Dict[str, int]:
    """Rough device footprint (bytes) of training, by component: the
    column- and row-major bin copies, the score, gradient, hessian and
    delta buffers, and the [L, F, 9, B] int32 per-leaf histogram cache
    (zero without ``leaf_cache``: the fused grower and the
    ``hist_cache`` degrade step).  The JAX version's terms for packed
    word lanes, score donation and linear fits are not ported."""
    n, f = num_data, num_features
    bins = 2 * n * f * bin_itemsize
    scores = num_models * n * 4 * 4
    cache = num_leaves * f * 9 * max_bin * 4 if leaf_cache else 0
    return {"bins_device": bins, "scores_and_gradients": scores,
            "histogram_cache": cache, "total": bins + scores + cache}


class _PredictionObjective:
    """Stand-in objective for loaded models (transform only)."""

    def __init__(self, name, sigmoid, num_class):
        self.name = name or "none"
        self.sigmoid = sigmoid
        self.num_class = num_class

    def convert_output(self, score):
        """[K, n] raw scores -> softmax over classes, sigmoid, or identity
        (gbdt.cpp:799-815), in host f64."""
        if self.num_class > 1:
            e = np.exp(score - score.max(axis=0, keepdims=True))
            return e / e.sum(axis=0, keepdims=True)
        if self.sigmoid > 0:
            return 1.0 / (1.0 + np.exp(-self.sigmoid * score))
        return score


def _to_device(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A host tensor on ``dev``, without waiting for the device."""
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


class _DeviceData:
    """A binned dataset on the training device plus its score buffer
    (ScoreUpdater, score_updater.hpp:23-99): ``bins`` [F, N] and, for the
    training set, ``bins_rm`` [N, F] in the dataset's uint8/uint16,
    ``score`` [num_models, N] f32 and, for linear trees, ``raw`` [F, N]
    f32 with NaN read as 0.0."""

    def __init__(self, dataset, num_models: int, device: torch.device,
                 with_row_major: bool = False, with_raw: bool = False):
        self.dataset = dataset
        self.num_data = dataset.num_data
        self.bins = torch.from_numpy(np.ascontiguousarray(
            dataset.bins)).to(device)
        self.bins_rm = (torch.from_numpy(np.ascontiguousarray(
            dataset.bins.T)).to(device) if with_row_major else None)
        init = np.zeros((num_models, self.num_data), np.float32)
        if dataset.metadata.init_score is not None:
            init += np.asarray(dataset.metadata.init_score,
                               np.float32).reshape(num_models, -1)
        self.score = torch.from_numpy(init).to(device)
        self.raw = None
        if with_raw:
            self.raw = torch.from_numpy(np.where(
                np.isnan(dataset.raw), np.float32(0.0),
                dataset.raw).astype(np.float32)).to(device)

    def host_score(self) -> np.ndarray:
        """[num_models, num_data] f64 host copy of the score buffer."""
        return self.score.cpu().numpy().astype(np.float64)


class GBDT:
    """A boosted forest: class-major ``models`` plus the header.

    ``GBDT()`` holds a loaded forest (``from_string``);
    ``GBDT(config, train_set, device)`` sets up serial training on
    ``device`` from a ``BinnedDataset``."""

    def __init__(self, config=None, train_set=None,
                 device: Optional[torch.device] = None):
        self.submodel_name = "gbdt"
        self.num_class = 1
        self.label_idx = 0
        self.max_feature_idx = 0
        self.sigmoid = -1.0
        self.feature_names: List[str] = []
        self.feature_infos_: List[str] = []
        self.objective_name = ""
        self.objective = None
        self.models: List[Tree] = []
        self._footer_tail = ""
        self.iter_ = 0
        if train_set is not None:
            self._setup(config, train_set, device)

    # ------------------------------------------------------------------
    # training

    def _setup(self, config, train_set, device: torch.device) -> None:
        config.check_trainable()
        self.config = config
        self.device = device
        self.train_set = train_set
        self.objective = create_objective(config)
        self.objective.init(train_set.metadata, train_set.num_data)
        self.num_class = self.objective.num_tree_per_iteration
        self.num_data = train_set.num_data
        self.max_feature_idx = train_set.num_total_features - 1
        self.feature_names = list(train_set.feature_names)
        self.feature_infos_ = train_set.feature_infos()
        self.sigmoid = config.sigmoid
        self.grow_params = GrowParams(
            num_leaves=config.num_leaves, max_bin=config.max_bin,
            min_data_in_leaf=config.min_data_in_leaf,
            min_sum_hessian_in_leaf=config.min_sum_hessian_in_leaf,
            lambda_l1=config.lambda_l1, lambda_l2=config.lambda_l2,
            min_gain_to_split=config.min_gain_to_split,
            max_depth=config.max_depth)
        self.shrinkage_rate = config.learning_rate
        self._degrade_steps: tuple = ()
        self._degrade_leaf_cache_off = False
        self._check_memory_budget(config, train_set)
        self._linear = self._setup_linear(config, train_set)
        self._grow = self._make_grow_fn()
        self.num_bin = torch.from_numpy(
            train_set.num_bin_per_feature()).to(device)
        self.is_cat = torch.from_numpy(
            train_set.is_categorical_per_feature()).to(device)
        self._is_cat_host = torch.from_numpy(
            train_set.is_categorical_per_feature())
        self.train_data = _DeviceData(train_set, self.num_class, device,
                                      with_row_major=True,
                                      with_raw=self._linear is not None)
        self.valid_data: List[_DeviceData] = []
        self.valid_metrics: List[list] = []
        self.train_metrics = self._make_metrics(train_set)
        self._grad_arrays = self.objective.gradient_arrays(device)
        self._row_weight = torch.ones(self.num_data, dtype=torch.float32,
                                      device=device)
        self._feat_mask = torch.ones(train_set.num_features,
                                     dtype=torch.bool, device=device)
        # TreeArrays (host) of every tree grown, a popped saturated one
        # included, and beside each its LeafModels (None for constant
        # leaves): valid sets added later replay them
        self.tree_arrays: list = []
        self.tree_linear: list = []
        self.linear_fallbacks = 0

    def _setup_linear(self, cfg, train_set) -> Optional[LinearParams]:
        """The linear-leaf settings, or None when ``linear_tree`` is off
        or inert (``linear_max_leaf_features=0``: constant leaves, with a
        warning).  Refuses a dataset without raw values."""
        if not cfg.linear_tree:
            return None
        k = int(cfg.linear_max_leaf_features)
        if k <= 0:
            log.warn_once(
                "linear_tree_k0",
                "linear_tree=true with linear_max_leaf_features=0: leaves "
                "stay constant (the linear subsystem is inert and output "
                "is identical to linear_tree=false)")
            return None
        if train_set.raw is None:
            raise LightGBMError(
                "linear_tree requires the raw feature values, but this "
                "dataset carries none.  Rebuild the Dataset from an "
                "in-memory matrix with linear_tree=true in its params")
        return LinearParams(k, float(cfg.linear_lambda),
                            float(cfg.lambda_l2))

    def _serial_grow_kind(self) -> str:
        """``fused`` / ``nocache`` / ``ordered`` / ``cached`` (the JAX
        version without its EFB and screening branch: neither is
        ported)."""
        if self.config.serial_grow == "fused":
            return "fused"
        # the hist_cache degrade step dropped the per-leaf histogram
        # cache: the full-pass learner scans the same histograms
        if self._degrade_leaf_cache_off:
            return "nocache"
        return self.config.serial_grow

    def _check_memory_budget(self, cfg, train_set) -> None:
        """The histogram-pool half of the JAX admission gate:
        ``histogram_pool_size`` (MB) against the per-leaf histogram
        cache.  Under ``memory_policy=degrade`` a cache over the pool
        takes the ``hist_cache`` step (no cache: the full-pass grower);
        under ``fail_fast`` it warns that the pool does not bound
        memory."""
        policy = resource.check_memory_policy(cfg.memory_policy)
        est = estimate_train_memory(
            train_set.num_data, train_set.num_features, cfg.num_leaves,
            cfg.max_bin, self.num_class,
            bin_itemsize=train_set.bins.dtype.itemsize,
            leaf_cache=cfg.serial_grow != "fused")
        pool_mb = float(cfg.histogram_pool_size)
        if pool_mb <= 0 or est["histogram_cache"] <= pool_mb * (1 << 20):
            return
        if policy == "degrade":
            self._apply_degrade(
                "hist_cache", est["histogram_cache"],
                f"histogram_pool_size={pool_mb:g}MB bounds the per-leaf "
                f"histogram cache "
                f"({est['histogram_cache'] / (1 << 20):.0f}MB resident): "
                f"dropping the cache — children recompute instead of "
                f"sibling-subtraction")
            return
        log.warn_once(
            "histogram_pool_size",
            "histogram_pool_size=%.0fMB requested but the device design "
            "keeps the whole per-leaf histogram cache resident (%.0fMB for "
            "num_leaves=%d x %d columns x 9 x %d bins); under "
            "memory_policy=fail_fast the parameter does NOT bound memory — "
            "lower num_leaves/max_bin, or set memory_policy=degrade to make "
            "the bound real", pool_mb, est["histogram_cache"] / (1 << 20),
            cfg.num_leaves, train_set.num_features, cfg.max_bin)

    def _apply_degrade(self, step: str, saved_bytes: int,
                       detail: str) -> None:
        if step == "hist_cache":
            self._degrade_leaf_cache_off = True
        self._degrade_steps = self._degrade_steps + (step,)
        resource.note_degrade(step, saved_bytes, detail)

    def _make_grow_fn(self):
        """The grower of this booster's kind, as ``fn(grad, hess) ->
        (TreeArrays, leaf_id, delta)`` over the training data.  Unlike
        the JAX package, whose leaf-ordered grower packs uint8 bins into
        words and falls back to the cached learner for more than 256
        bins, the port's ordered grower takes uint16 bins too, and its
        trees equal the cached grower's; so ``ordered`` stays
        ``ordered``."""
        kind = self.grow_kind = self._serial_grow_kind()
        params = self.grow_params

        def grow(grad, hess):
            td = self.train_data
            args = (self.num_bin, self.is_cat, self._feat_mask, grad, hess,
                    self._row_weight, self.shrinkage_rate, params)
            if kind == "ordered":
                return grow_tree_ordered(td.bins_rm, *args)
            # fused: each split's pass is K3 (per-feature candidates);
            # nocache: K2 histograms and the split scan; cached: K1 over
            # the smaller child and the exact sibling subtraction
            comm = {"fused": SerialComm(leaf_cache=False, fused_gain=True),
                    "nocache": SerialComm(leaf_cache=False),
                    "cached": SerialComm()}[kind]
            return grow_tree(td.bins, *args, comm=comm, bins_rm=td.bins_rm)
        return grow

    def _make_metrics(self, dataset) -> list:
        out = []
        for name in self.config.metric:
            m = create_metric(name, self.config)
            if m is not None:
                m.init(dataset.metadata, dataset.num_data)
                out.append(m)
        return out

    def add_valid_dataset(self, valid_set) -> None:
        """GBDT::AddValidDataset (gbdt.cpp:169-199): the valid set must
        share the training mappers (``create_valid``)."""
        if valid_set.mappers is not self.train_set.mappers and \
                [m.to_state() for m in valid_set.mappers] != \
                [m.to_state() for m in self.train_set.mappers]:
            log.fatal("Cannot add validation data, since it has different "
                      "bin mappers with training data")
        if self._linear is not None and valid_set.raw is None:
            log.fatal("linear_tree validation scoring needs the valid "
                      "set's raw feature values (the per-leaf affine "
                      "epilogue reads them); create the valid set with "
                      "reference=train from an in-memory matrix")
        dd = _DeviceData(valid_set, self.num_class, self.device,
                         with_raw=self._linear is not None)
        # tree i belongs to class i % num_class (the JAX add_valid_dataset)
        for i, (ta, lin) in enumerate(zip(self.tree_arrays,
                                          self.tree_linear)):
            dd.score[i % self.num_class] += self._tree_delta(dd, ta, lin)
        self.valid_data.append(dd)
        self.valid_metrics.append(self._make_metrics(valid_set))

    def _tree_delta(self, dd: _DeviceData, ta,
                    lin: Optional[LeafModels] = None) -> torch.Tensor:
        """One tree's f32 leaf values on every row of ``dd``, through the
        plain binned walk, plus the affine part of linear leaves (the JAX
        ``_device_tree_delta``)."""
        L = self.grow_params.num_leaves
        ints, flts = pack_tree_arrays(ta)
        t = unpack_tree_arrays(_to_device(ints, self.device),
                               _to_device(flts, self.device), L)
        delta, leaf = predict_binned_tree(
            t.split_feature, t.split_bin,
            self.is_cat[t.split_feature.clamp(min=0).long()],
            t.left_child, t.right_child, t.leaf_value, dd.bins, L)
        if lin is not None:
            delta = delta + affine_epilogue(leaf, lin.coeff, lin.feat,
                                            dd.raw)
        return delta

    def _fit_linear(self, ta, leaf_id, grad, hess):
        """The per-leaf affine fit of one grown tree: (TreeArrays with the
        fitted intercepts, its LeafModels, the host (coeff, feat) tables,
        the train-score delta).  One host read brings the intercepts,
        slopes and fallback count back for the model text."""
        td = self.train_data
        const, coeff, feat, delta, fb = fit_leaf_models(
            ta, td.bins, self._is_cat_host, td.raw, grad, hess,
            self._row_weight, self.shrinkage_rate, self._linear,
            leaf=leaf_id)
        L, K = coeff.shape
        # feature indices and the count are small integers, exact in f32
        host = _read(torch.cat([
            const, coeff.reshape(-1), feat.reshape(-1).to(torch.float32),
            fb.to(torch.float32).reshape(1)]))
        fallbacks = int(host[-1])
        self.linear_fallbacks += fallbacks
        log.inc("linear_fallback_total", fallbacks)
        ta = ta._replace(leaf_value=torch.from_numpy(host[:L].copy()))
        coeff_host = host[L:L + L * K].reshape(L, K)
        feat_host = host[L + L * K:L + 2 * L * K].astype(np.int32)
        return (ta, LeafModels(coeff, feat),
                (coeff_host, feat_host.reshape(L, K)), delta)

    def train_one_iter(self) -> bool:
        """One boosting round (gbdt.cpp:295-382).  Returns True when no
        class's tree could split (saturation): the round's trees are
        popped, as the reference pops them, and training should stop."""
        score = self.train_data.score
        grad, hess = self.objective.gradients_with(self._grad_arrays, score)
        trees = []
        for cls in range(self.num_class):
            ta, leaf_id, delta = self._grow(grad[cls], hess[cls])
            lin = host_lin = None
            if self._linear is not None:
                # the grower's leaf of every row is the leaf a re-walk of
                # the grown structure over the bins finds (tested)
                ta, lin, host_lin, delta = self._fit_linear(
                    ta, leaf_id, grad[cls], hess[cls])
            score[cls] += delta
            for dd in self.valid_data:
                dd.score[cls] += self._tree_delta(dd, ta, lin)
            self.tree_arrays.append(ta)
            self.tree_linear.append(lin)
            tree = Tree.from_arrays(ta, self.train_set.mappers,
                                    self.train_set.used_feature_map,
                                    self.shrinkage_rate)
            if host_lin is not None:
                attach_linear(tree, *host_lin,
                              self.train_set.used_feature_map)
            trees.append(tree)
        if all(t.num_leaves <= 1 for t in trees):
            log.warning("Stopped training because there are no more "
                        "leaves that meet the split requirements.")
            return True
        self.models.extend(trees)
        self.iter_ += 1
        return False

    def _metric_sets(self):
        return [("training", self.train_data, self.train_metrics)] + [
            (f"valid_{i + 1}", dd, ms) for i, (dd, ms) in
            enumerate(zip(self.valid_data, self.valid_metrics))]

    def eval_set(self, key: str) -> List[tuple]:
        """[(metric name, value, bigger is better)] on the set named
        ``key`` (``training`` or ``valid_<i>``), from an f64 host copy of
        its scores."""
        for k, dd, metrics in self._metric_sets():
            if k == key:
                score = dd.host_score()
                return [(name, v, m.factor_to_bigger_better > 0)
                        for m in metrics
                        for name, v in zip(m.names, m.eval(score))]
        raise KeyError(key)

    def eval_metrics(self) -> Dict[str, Dict[str, float]]:
        """Every metric of the training set and each valid set."""
        return {k: {name: v for name, v, _ in self.eval_set(k)}
                for k, _, metrics in self._metric_sets() if metrics}

    @classmethod
    def from_string(cls, text: str) -> "GBDT":
        self = cls()
        self.load_model_from_string(text)
        return self

    def num_trees(self) -> int:
        return len(self.models)

    def predict_raw(self, X: np.ndarray, num_iteration: int = -1) -> np.ndarray:
        """[K, n] raw scores from the f64 host walk of every tree."""
        X = np.asarray(X, np.float64)
        n_models = len(self.models)
        if num_iteration > 0:
            n_models = min(n_models, num_iteration * self.num_class)
        out = np.zeros((self.num_class, X.shape[0]), np.float64)
        for i in range(n_models):
            out[i % self.num_class] += self.models[i].predict(X)
        return out

    # ------------------------------------------------------------------
    def feature_importance(self):
        """Split-count importance (gbdt.cpp:765-789)."""
        counts = np.zeros(self.max_feature_idx + 1, np.int64)
        for tree in self.models:
            for f in tree.split_feature[:tree.num_leaves - 1]:
                counts[f] += 1
        names = self.feature_names
        pairs = [(names[f] if f < len(names) else f"Column_{f}",
                  int(counts[f]))
                 for f in range(len(counts)) if counts[f] > 0]
        pairs.sort(key=lambda kv: -kv[1])
        return pairs

    def save_model_to_string(self, num_iteration: int = -1) -> str:
        buf = io.StringIO()
        buf.write(self.submodel_name + "\n")
        buf.write(f"num_class={self.num_class}\n")
        buf.write(f"label_index={self.label_idx}\n")
        buf.write(f"max_feature_idx={self.max_feature_idx}\n")
        if self.objective is not None:
            buf.write(f"objective={self.objective.name}\n")
        buf.write(f"sigmoid={self.sigmoid:g}\n")
        buf.write("feature_names=" + " ".join(self.feature_names) + "\n")
        buf.write("feature_infos=" + " ".join(self.feature_infos_) + "\n")
        buf.write("\n")
        n_models = len(self.models)
        if num_iteration > 0:
            n_models = min(n_models, num_iteration * self.num_class)
        for i in range(n_models):
            buf.write(f"Tree={i}\n")
            buf.write(self.models[i].to_string())
            buf.write("\n")
        buf.write("\nfeature importances:\n")
        for name, cnt in self.feature_importance():
            buf.write(f"{name}={cnt}\n")
        if self._footer_tail.strip():
            buf.write(self._footer_tail)
        return buf.getvalue()

    def load_model_from_string(self, text: str) -> None:
        """gbdt.cpp:679-760, with the JAX loader's corruption checks:
        any damage raises ``LightGBMError`` naming the section, the tree
        index and the file line."""
        lines = text.splitlines()
        kv: Dict[str, str] = {}
        for ln in lines:
            if ln.startswith("Tree="):
                break
            if "=" in ln:
                k, v = ln.split("=", 1)
                kv[k.strip()] = v.strip()
        if "num_class" not in kv:
            log.fatal("Model file doesn't specify the number of classes")

        def _header_int(key, default):
            raw = kv.get(key, default)
            try:
                return int(raw)
            except ValueError:
                log.fatal("Model file header: %s=%r is not an integer "
                          "— corrupt model file?", key, raw)

        def _header_float(key, default):
            raw = kv.get(key, default)
            try:
                return float(raw)
            except ValueError:
                log.fatal("Model file header: %s=%r is not a number "
                          "— corrupt model file?", key, raw)

        first = text.strip().splitlines()[0].strip() if text.strip() else ""
        if first in ("gbdt", "dart", "goss", "tree"):
            self.submodel_name = "gbdt" if first == "tree" else first
        self.num_class = _header_int("num_class", "1")
        if self.num_class < 1:
            log.fatal("Model file header: num_class=%d must be >= 1",
                      self.num_class)
        self.label_idx = _header_int("label_index", 0)
        self.max_feature_idx = _header_int("max_feature_idx", 0)
        self.sigmoid = _header_float("sigmoid", -1.0)
        self.feature_names = kv.get("feature_names", "").split()
        self.feature_infos_ = kv.get("feature_infos", "").split()
        self.objective_name = kv.get("objective", "")
        # the footer doubles as the truncation sentinel: a file chopped
        # anywhere before it is detectably incomplete
        footer_pos = text.find("\nfeature importances")
        if footer_pos < 0:
            log.fatal("Model file ends without the 'feature importances' "
                      "footer — truncated mid-write? (re-save the model "
                      "or restore from a good copy)")
        tree_marks = [m for m in re.finditer(r"(?m)^Tree=(.*)$", text)
                      if m.start() < footer_pos]
        self.models = []
        for i, m in enumerate(tree_marks):
            idx_s = m.group(1).strip()
            line_no = text.count("\n", 0, m.start()) + 1
            if idx_s != str(i):
                log.fatal("Model file: expected Tree=%d, found Tree=%s "
                          "(line %d) — trees missing or reordered; "
                          "corrupt model file?", i, idx_s, line_no)
            start = m.end()
            end = tree_marks[i + 1].start() if i + 1 < len(tree_marks) \
                else footer_pos
            try:
                self.models.append(Tree.from_string(text[start:end]))
            except LightGBMError as exc:
                log.fatal("Model file: Tree=%s (line %d): %s",
                          idx_s, line_no, exc)
        if self.models and len(self.models) % self.num_class != 0:
            log.fatal("Model file: %d tree(s) is not a multiple of "
                      "num_class=%d — trees missing; truncated model "
                      "file?", len(self.models), self.num_class)
        self.objective = _PredictionObjective(
            self.objective_name, self.sigmoid, self.num_class)
        # the importance lines end at the first blank line; what follows
        # (a drift fingerprint section) rides along unparsed
        footer = text[footer_pos + 1:].split("\n")
        i = 1
        while i < len(footer) and footer[i].strip() and "=" in footer[i]:
            i += 1
        self._footer_tail = "\n".join(footer[i:])
        # only the fingerprint section's framing is checked: a header
        # without its terminator is a file truncated mid-write
        head = re.search(r"(?m)^data_fingerprint\s*$", self._footer_tail)
        if head is not None and re.search(
                r"(?m)^end data_fingerprint\s*$",
                self._footer_tail[head.end():]) is None:
            log.fatal("Model file data_fingerprint section: no 'end "
                      "data_fingerprint' terminator — truncated mid-write? "
                      "(re-save the model or restore from a good copy)")
