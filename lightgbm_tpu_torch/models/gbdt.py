"""``GBDT``: the boosted forest, its model text, and serial training.

Port of the JAX package's models/gbdt.py.  The model-file half
(``save_model_to_string``, ``load_model_from_string``,
``_PredictionObjective``; reference gbdt.cpp:625-815) validates every
header field, tree section and the footer with the JAX loader's checks
and error texts.  After the ``feature importances`` block comes the
optional drift fingerprint section (``obs/drift.py``): a trained booster
carries its training set's fingerprint and writes it there, its
``score_hist`` filled from the training scores at the first save; a
loaded model parses it back (absent: ``None``).

The training half is serial GBDT for every objective: the device state
of ``_DeviceData`` (feature-major and row-major bins, the
[num_class, N] f32 score), one boosting round as plain torch calls
(the objective's gradients, or a custom objective's from
``train_one_iter(grad, hess)`` -> for each class, the grower that
``serial_grow`` selects -> ``score[cls] += delta``, the JAX
``_build_shared_train_step``), valid-set scoring through
``ops/predict.py``, the saturation pop of the JAX ``_flush_pending``
(gbdt.cpp:362-378) and the metrics.  Tree i belongs to class
i % num_class.  Rounds run synchronously, with no pipelining; the score
buffers are updated in place.

Sampling draws what the JAX package draws, from the same seeds: the bag
mask (``bagging_fraction`` every ``bagging_freq`` rounds) on the device
from the threefry stream of ``bagging_seed`` (``utils/random.py``,
``device_bag_mask``, as many words as the JAX package's padded rows),
the feature masks (``feature_fraction``) from
``np.random.RandomState(feature_fraction_seed)`` on the host, in the
order the JAX round would take (``_masks_before_gradients``); GOSS
(models/goss.py) and DART (models/dart.py) are subclasses.
``nan_policy`` checks each round's gradients and scores and rolls a
non-finite round back (``_contain_poisoned_iter``).

Continued training puts the init model's trees first in ``models``
(``num_init_iteration`` rounds of them) and the training scores start
from its predictions (the dataset's init scores); every valid set
replays every tree of ``models``, loaded ones through ``Tree.ensure_inner``
against the training mappers.  ``rollback_one_iter`` replays the last
round's trees negated, also into the loaded ones; ``reset_config``
takes new parameters between rounds; ``merge_from`` appends another
model's trees scaled; ``predict_leaf_index`` is the host walk.

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
size (``_check_memory_budget``).  EFB bundled datasets and gain
screening need the per-split column decode, which the leaf-ordered
grower's layout does not carry: ``ordered`` falls back to ``cached``
there, with the JAX package's warning.  The JAX package's admission
gate against the device's memory (``MemoryBudgetExceeded``) and its
``score_donation`` and ``row_pad`` steps are not ported.

EFB (``io/bundling.py``, ``ops/bundle.py``): a dataset with a bundle
plan trains over its ``[C, N]`` columns with the plan's decode tables
(``_setup_bundle``); trees stay in original feature space, and every
replay (valid sets, DART's drops, rollbacks, loaded trees) decodes the
columns.  Gain screening (``feature_screen_ratio > 0``,
models/screening.py): each round picks its histogram view
(``_select_view``); a screened round masks the inactive features and
grows over a compacted view of the active columns.  The trees of a
round are folded into the screener's average when the JAX package
would: a round late for ``gbdt`` and GOSS (the JAX booster materialises
a round's trees during the next one, or when ``models`` is read), in the
round itself for DART (``_screen_observes_late``).
"""

from __future__ import annotations

import io
import re
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..io.bundling import BundlePlan
from ..metric import create_metric
from ..obs.drift import DataFingerprint
from ..objective import create_objective
from ..ops.bundle import BundleDecode
from ..ops.grow import GrowParams, SerialComm, _read, grow_tree
from ..ops.ordered_grow import grow_tree_ordered
from ..ops.predict import predict_binned_tree
from ..utils import log, resource
from ..utils import random as jrandom
from ..utils.log import LightGBMError
from .linear import (LinearParams, affine_epilogue, attach_linear,
                     fit_leaf_models)
from .screening import GainScreener
from .tree import Tree


class _HistView(NamedTuple):
    """One round's histogram side: the column matrix (EFB bundled or
    not, the screening's compacted view or the whole), its row-major
    copy and its decode tables (None: plain per-feature columns)."""
    bins: torch.Tensor
    bins_rm: Optional[torch.Tensor]
    bundle: Optional[BundleDecode]


def _take(t: torch.Tensor, dim: int, idx: torch.Tensor) -> torch.Tensor:
    """``t.index_select(dim, idx)`` for uint8 and uint16 tensors (the
    latter through an int16 view)."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16).index_select(dim, idx).view(torch.uint16)
    return t.index_select(dim, idx)


def estimate_train_memory(num_data: int, num_columns: int, num_leaves: int,
                          max_bin: int, num_models: int,
                          bin_itemsize: int = 1, *,
                          leaf_cache: bool = True,
                          linear_k: int = 0) -> Dict[str, int]:
    """Rough device footprint (bytes) of training, by component: the
    column- and row-major bin copies (``num_columns`` of them, the EFB
    columns of a bundled dataset), the score, gradient, hessian and
    delta buffers, the [L, C, 9, B] int32 per-leaf histogram cache
    (zero without ``leaf_cache``: the fused grower and the
    ``hist_cache`` degrade step) and, with ``linear_k`` affine slots a
    leaf (``linear_tree``), the linear fit's: the [F, N] f32 raw copy,
    two [N, K+1] f32 per-row gathers and three [L, K+1, K+1] f32 normal
    equation copies (the JAX ``linear_fit`` term).  The JAX version's
    terms for packed word lanes and score donation are not ported."""
    n, f = num_data, num_columns
    bins = 2 * n * f * bin_itemsize
    scores = num_models * n * 4 * 4
    cache = num_leaves * f * 9 * max_bin * 4 if leaf_cache else 0
    linear = 0
    if linear_k > 0:
        m = linear_k + 1
        linear = n * f * 4 + 2 * n * m * 4 + 3 * num_leaves * m * m * 4
    return {"bins_device": bins, "scores_and_gradients": scores,
            "histogram_cache": cache, "linear_fit": linear,
            "total": bins + scores + cache + linear}


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


def _all_finite(*tensors) -> bool:
    """Every element of every tensor is finite (one host read)."""
    ok = torch.ones((), dtype=torch.bool, device=tensors[0].device)
    for t in tensors:
        ok = ok & torch.isfinite(t).all()
    return bool(ok)


def device_bag_mask(key, n: int, bag_cnt: int, n_real: int,
                    device) -> torch.Tensor:
    """[n_real] f32 0/1 mask of exactly ``bag_cnt`` rows drawn without
    replacement (reference bag_data_cnt_; the JAX ``_device_bag_mask``).

    The JAX package draws ``n`` 32-bit words for its ``n`` padded rows,
    pad words forced to the largest, and keeps the rows whose (word,
    index) pair sorts among the first ``bag_cnt``: the pair is unique,
    so exactly ``bag_cnt`` rows are kept.  Every real pair sorts before
    every pad pair, so the port draws the same ``n`` words, keeps the
    first ``n_real`` and ranks those alone."""
    if bag_cnt <= 0:
        return torch.zeros(n_real, dtype=torch.float32, device=device)
    r = jrandom.bits(key, n, device)[:n_real]
    r_sorted, i_sorted = torch.sort(r, stable=True)
    thr_r = r_sorted[bag_cnt - 1]
    thr_i = i_sorted[bag_cnt - 1]
    iota = torch.arange(n_real, dtype=torch.int64, device=device)
    keep = (r < thr_r) | ((r == thr_r) & (iota <= thr_i))
    return keep.to(torch.float32)


class GBDT:
    """A boosted forest: class-major ``models`` plus the header.

    ``GBDT()`` holds a loaded forest (``from_string``);
    ``GBDT(config, train_set, device)`` sets up serial training on
    ``device`` from a ``BinnedDataset``."""

    submodel_name = "gbdt"
    #: the JAX booster materialises a round's trees during the next round
    #: (after that round has chosen its screening view) or when ``models``
    #: is read; DART's materialises them in the round itself.  The
    #: screener sees the trees when the JAX package's would.
    _screen_observes_late = True
    _screen_pending = None
    _screener = None
    #: the JAX package's fused round (an objective's gradients, and a
    #: booster whose per-round hooks are the base's) draws the bag mask
    #: and every class's feature mask before it grows; its per-stage
    #: round (a custom objective's gradients, GOSS) computes the
    #: gradients first and draws one feature mask per class in the class
    #: loop.  The port has one round that keeps whichever order the JAX
    #: package would take.
    _masks_before_gradients = True

    def __init__(self, config=None, train_set=None,
                 device: Optional[torch.device] = None):
        self.num_class = 1
        self.label_idx = 0
        self.max_feature_idx = 0
        self.sigmoid = -1.0
        self.feature_names: List[str] = []
        self.feature_infos_: List[str] = []
        self.objective_name = ""
        self.objective = None
        self._models: List[Tree] = []
        self.data_fingerprint = None
        self.iter_ = 0
        # rounds carried in from an init model (continued training) or
        # loaded from a model file
        self.num_init_iteration = 0
        if train_set is not None:
            self._setup(config, train_set, device)

    # ------------------------------------------------------------------
    # training

    def _setup(self, config, train_set, device: torch.device) -> None:
        config.check_trainable()
        self.config = config
        self.device = device
        self.train_set = train_set
        # the training data's fingerprint: a continued run carries the
        # fresh data's, not the init model's
        self.data_fingerprint = getattr(train_set, "data_fingerprint", None)
        self.objective = create_objective(config)
        self.objective.init(train_set.metadata, train_set.num_data)
        self.num_class = self.objective.num_tree_per_iteration
        self.num_data = train_set.num_data
        self.max_feature_idx = train_set.num_total_features - 1
        self.feature_names = list(train_set.feature_names)
        self.feature_infos_ = train_set.feature_infos()
        # the model text's sigmoid transform belongs to binary only
        self.sigmoid = (config.sigmoid if config.objective == "binary"
                        else -1.0)
        self.grow_params = self._make_grow_params(config)
        self.shrinkage_rate = config.learning_rate
        self._degrade_steps: tuple = ()
        self._degrade_leaf_cache_off = False
        self.num_features = train_set.num_features
        self.num_columns = train_set.num_columns
        self._check_memory_budget(config, train_set)
        self._linear = self._setup_linear(config, train_set)
        self._setup_bundle(train_set)
        self._setup_screening(config)
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
        td = self.train_data
        self._full_view = self._view = _HistView(td.bins, td.bins_rm,
                                                 self._bundle)
        self._ones_weight = torch.ones(self.num_data, dtype=torch.float32,
                                       device=device)
        # the bagging mask of the last draw (JAX _row_weight), and the
        # row weight and feature mask the grower takes this round
        self._row_weight = self._ones_weight
        self._round_weight = self._ones_weight
        self._full_feat_mask = torch.ones(self.num_features,
                                          dtype=torch.bool, device=device)
        self._feat_mask = self._full_feat_mask
        # the JAX package's draws cover its padded rows (row_buckets)
        self._padded_rows = (jrandom.bucket_rows(self.num_data)
                             if config.row_buckets else self.num_data)
        self._bag_cnt = self.num_data
        self._bag_key = jrandom.prng_key(config.bagging_seed)
        self._feature_rng = np.random.RandomState(
            config.feature_fraction_seed)
        self._nan_policy = config.nan_policy
        self._nan_skips = 0
        # TreeArrays (host) of each tree this booster grew: the last
        # len(tree_arrays) trees of ``models`` (a rollback pops them; a
        # merge, which appends other trees, drops them)
        self.tree_arrays: list = []
        self.linear_fallbacks = 0

    @staticmethod
    def _make_grow_params(config) -> GrowParams:
        # bagging and GOSS leave zero-weight rows every round: the
        # ordered grower compacts them out of its layout (GOSS only when
        # it can sample; its warmup rounds pay the sort on an all-ones
        # mask, as in the JAX package)
        goss_samples = (config.boosting_type == "goss"
                        and config.top_rate + config.other_rate < 1.0)
        subsampled = goss_samples or (config.bagging_freq > 0
                                      and config.bagging_fraction < 1.0)
        return GrowParams(
            num_leaves=config.num_leaves, max_bin=config.max_bin,
            min_data_in_leaf=config.min_data_in_leaf,
            min_sum_hessian_in_leaf=config.min_sum_hessian_in_leaf,
            lambda_l1=config.lambda_l1, lambda_l2=config.lambda_l2,
            min_gain_to_split=config.min_gain_to_split,
            max_depth=config.max_depth, compact_inactive=subsampled)

    def reset_config(self, config) -> None:
        """Booster::ResetConfig (c_api.cpp:96-134) between rounds: the
        new learning rate, the grower rebuilt only when its parameters
        really change (so a per-round learning-rate schedule rebuilds
        nothing), the screener when a ``feature_screen_*`` key changes,
        and the metrics anew.  The sampling keys are read from
        the config each round, so a new bagging or feature fraction
        takes effect at once, from the generators as they stand (the
        JAX package resets neither).  A setting ``check_trainable``
        refuses is refused here too.  A loaded model only keeps the
        config."""
        if getattr(self, "train_set", None) is None:
            self.config = config
            return
        config.check_trainable()
        self._observe_pending()
        old, self.config = self.config, config
        self.shrinkage_rate = config.learning_rate
        params = self._make_grow_params(config)
        # the screener is rebuilt only on a real change of its keys, so a
        # per-round learning-rate schedule keeps its average
        screen = ("feature_screen_ratio", "feature_screen_refresh",
                  "feature_screen_warmup", "feature_screen_decay")
        rescreen = any(old[k] != config[k] for k in screen)
        if rescreen:
            self._setup_screening(config)
            self._view = self._full_view
        if params != self.grow_params or rescreen:
            self.grow_params = params
            self._grow = self._make_grow_fn()
        self.train_metrics = self._make_metrics(self.train_set)
        self.valid_metrics = [self._make_metrics(dd.dataset)
                              for dd in self.valid_data]

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
        """``fused`` / ``nocache`` / ``ordered`` / ``cached``."""
        cfg = self.config
        if cfg.serial_grow == "fused":
            return "fused"
        # the hist_cache degrade step dropped the per-leaf histogram
        # cache: the full-pass learner scans the same histograms
        if self._degrade_leaf_cache_off:
            return "nocache"
        # EFB columns and the screening's compacted views need the
        # per-split column decode, which the leaf-ordered grower's layout
        # does not carry: the cached learner (same trees) instead
        if self._bundle is not None or self._screener is not None:
            if cfg.serial_grow == "ordered":
                log.warn_once(
                    "serial_grow_decode",
                    "serial_grow=ordered: using the cached serial "
                    "learner instead (EFB bundling / feature screening "
                    "need the column-decode path)")
            return "cached"
        return cfg.serial_grow

    def _setup_bundle(self, train_set) -> None:
        """The decode tables of an EFB bundled dataset on the training
        device (None for the plain layout) and each feature's column."""
        plan = train_set.bundle_plan
        self._bundle = None
        self._feature_col = np.arange(self.num_features, dtype=np.int64)
        if plan is None:
            return
        self._bundle = BundleDecode.from_plan(
            plan, train_set.mappers, self.config.max_bin, self.device)
        self._feature_col = self._bundle.col.cpu().numpy()
        log.info("EFB active: %d feature(s) in %d column(s) "
                 "(%d bundle(s))", self.num_features, self.num_columns,
                 len(plan.bundles))

    def _setup_screening(self, cfg) -> None:
        """The gain screener (models/screening.py) when
        ``feature_screen_ratio > 0``, and a fresh schedule."""
        self._screener = None
        self._screen_mask = None
        self._screen_pending = None
        self._screen_period = -1
        self._active_view = None
        #: (round, active columns) each time the active set is drawn
        self.screen_periods: list = []
        if cfg.feature_screen_ratio <= 0.0:
            return
        self._screener = GainScreener(
            self.num_features, self.num_columns, self._feature_col,
            ratio=cfg.feature_screen_ratio,
            refresh=cfg.feature_screen_refresh,
            warmup=cfg.feature_screen_warmup,
            decay=cfg.feature_screen_decay)

    def _select_view(self) -> _HistView:
        """This round's histogram view and screening mask: warmup and
        refresh rounds take the whole view, unmasked; a screened round the
        compacted view of the period's active columns (drawn once a
        period) under their mask."""
        scr = self._screener
        if scr is None:
            return self._full_view
        it = self.iter_ - self.num_init_iteration
        if scr.round_mode(it) != "screened":
            self._screen_mask = None
            return self._full_view
        period = scr.period(it)
        if period != self._screen_period:
            self._screen_period = period
            cols = scr.active_columns()
            self.screen_periods.append((it, cols))
            self._screen_mask = _to_device(
                torch.from_numpy(scr.screen_mask(cols)), self.device)
            self._active_view = self._build_active_view(cols)
        return (self._active_view if self._active_view is not None
                else self._full_view)

    def _build_active_view(self, cols: np.ndarray) -> Optional[_HistView]:
        """The active columns gathered into a ``[len(cols), N]`` view
        (and its row-major copy), whose decode tables send each feature
        to its column's position; a dropped feature points at position 0
        and is masked out of the scan.  The JAX package pads the view to
        its compile-cache bucket of ``len(cols)`` columns and keeps the
        whole view (mask-only screening) when that bucket is not below
        the column count; the port needs no compile cache and gathers
        exactly the active columns, under the same rule, since the
        compacted view expands its histograms (pad columns are zeros no
        feature reads, so the trees are the JAX package's)."""
        if jrandom.bucket_rows(len(cols)) >= self.num_columns:
            return None
        idx = torch.from_numpy(np.asarray(cols, np.int64)).to(self.device)
        td = self.train_data
        pos = np.zeros(self.num_features, np.int64)
        pos_of = {int(c): i for i, c in enumerate(cols)}
        for f in range(self.num_features):
            pos[f] = pos_of.get(int(self._feature_col[f]), 0)
        # the EFB tables, or an all-singleton plan's when unbundled
        base = self._bundle
        if base is None:
            base = BundleDecode.from_plan(
                BundlePlan.identity(self.num_features),
                self.train_set.mappers, self.config.max_bin, self.device)
        bundle = base._replace(col=torch.from_numpy(pos).to(self.device))
        return _HistView(_take(td.bins, 0, idx), _take(td.bins_rm, 1, idx),
                         bundle)

    def _observe_pending(self) -> None:
        """Fold the last round's trees into the screener, if it has not
        seen them yet."""
        if self._screen_pending is not None:
            trees, self._screen_pending = self._screen_pending, None
            self._screener.observe_trees(trees)

    @property
    def models(self) -> List[Tree]:
        """The forest, class-major; reading it is where the JAX booster
        materialises a pending round (``_observe_pending``)."""
        self._observe_pending()
        return self._models

    @models.setter
    def models(self, value: List[Tree]) -> None:
        self._observe_pending()
        self._models = value

    def _check_memory_budget(self, cfg, train_set) -> None:
        """The histogram-pool half of the JAX admission gate:
        ``histogram_pool_size`` (MB) against the per-leaf histogram
        cache.  Under ``memory_policy=degrade`` a cache over the pool
        takes the ``hist_cache`` step (no cache: the full-pass grower);
        under ``fail_fast`` it warns that the pool does not bound
        memory."""
        policy = resource.check_memory_policy(cfg.memory_policy)
        est = estimate_train_memory(
            train_set.num_data, train_set.num_columns, cfg.num_leaves,
            cfg.max_bin, self.num_class,
            bin_itemsize=train_set.bins.dtype.itemsize,
            leaf_cache=cfg.serial_grow != "fused",
            linear_k=(int(cfg.linear_max_leaf_features)
                      if cfg.linear_tree else 0))
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
            cfg.num_leaves, train_set.num_columns, cfg.max_bin)

    def _apply_degrade(self, step: str, saved_bytes: int,
                       detail: str) -> None:
        if step == "hist_cache":
            self._degrade_leaf_cache_off = True
        self._degrade_steps = self._degrade_steps + (step,)
        resource.note_degrade(step, saved_bytes, detail)

    def _make_grow_fn(self):
        """The grower of this booster's kind, as ``fn(grad, hess) ->
        (TreeArrays, leaf_id, delta)`` over the round's histogram view
        (``_view``) of the training data.  Unlike
        the JAX package, whose leaf-ordered grower packs uint8 bins into
        words and falls back to the cached learner for more than 256
        bins, the port's ordered grower takes uint16 bins too, and its
        trees equal the cached grower's; so ``ordered`` stays
        ``ordered``."""
        kind = self.grow_kind = self._serial_grow_kind()
        params = self.grow_params

        def grow(grad, hess):
            view = self._view
            args = (self.num_bin, self.is_cat, self._feat_mask, grad, hess,
                    self._round_weight, self.shrinkage_rate, params)
            if kind == "ordered":
                return grow_tree_ordered(view.bins_rm, *args)
            # fused: each split's pass is K3 (per-feature candidates);
            # nocache: K2 histograms and the split scan; cached: K1 over
            # the smaller child and the exact sibling subtraction
            comm = {"fused": SerialComm(leaf_cache=False, fused_gain=True),
                    "nocache": SerialComm(leaf_cache=False),
                    "cached": SerialComm()}[kind]
            return grow_tree(view.bins, *args, comm=comm,
                             bins_rm=view.bins_rm, bundle=view.bundle)
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
        share the training mappers and bundle plan (``create_valid``)."""
        pa, pb = self.train_set.bundle_plan, valid_set.bundle_plan
        if (valid_set.mappers is not self.train_set.mappers and
                [m.to_state() for m in valid_set.mappers] !=
                [m.to_state() for m in self.train_set.mappers]) or \
                (pa is None) != (pb is None) or \
                (pa is not None and pa.signature() != pb.signature()):
            log.fatal("Cannot add validation data, since it has different "
                      "bin mappers with training data")
        if self._linear is not None and valid_set.raw is None:
            log.fatal("linear_tree validation scoring needs the valid "
                      "set's raw feature values (the per-leaf affine "
                      "epilogue reads them); create the valid set with "
                      "reference=train from an in-memory matrix")
        dd = _DeviceData(valid_set, self.num_class, self.device,
                         with_raw=self._linear is not None)
        # every tree of ``models``, loaded ones too; tree i belongs to
        # class i % num_class (the JAX add_valid_dataset)
        for i, tree in enumerate(self.models):
            self._add_host_tree_to(dd, tree, i % self.num_class)
        self.valid_data.append(dd)
        self.valid_metrics.append(self._make_metrics(valid_set))

    def _add_host_tree_to(self, dd: _DeviceData, tree: Tree,
                          cls: int) -> None:
        """Add a host ``Tree`` (grown, loaded or negated) to class ``cls``
        of ``dd``'s scores: its bin-space splits against the training
        mappers (``ensure_inner``), the plain binned walk, then the
        affine part of linear leaves (the JAX ``_add_host_tree_to``).
        A grown tree adds its leaf values and slopes, f32 values held in
        f64, so exactly what its fit added to the training scores.  A
        tree that splits on a feature trivial in the training data, or
        whose affine part reads one, or a linear tree on a set without
        raw values, is fatal."""
        if tree.num_leaves <= 1:
            dd.score[cls] += float(tree.leaf_value[0]) \
                if tree.num_leaves else 0.0
            return
        ts = self.train_set
        if not tree.ensure_inner(ts.real_to_inner, ts.mappers):
            log.fatal("Cannot replay a loaded tree on this dataset: it "
                      "splits on a feature the dataset binned as trivial")
        dev = self.device
        sf = torch.from_numpy(tree.split_feature_inner.astype(np.int64))
        dt = torch.from_numpy(tree.decision_type == 1)
        delta, leaf = predict_binned_tree(
            _to_device(sf, dev),
            _to_device(torch.from_numpy(tree.threshold_in_bin), dev),
            _to_device(dt, dev),
            _to_device(torch.from_numpy(tree.left_child), dev),
            _to_device(torch.from_numpy(tree.right_child), dev),
            _to_device(torch.from_numpy(
                tree.leaf_value.astype(np.float32)), dev),
            dd.bins, int(tree.num_leaves), bundle=self._bundle)
        if tree.has_linear():
            if dd.raw is None:
                log.fatal("Cannot replay a linear tree on this dataset: "
                          "no raw feature values are resident (build the "
                          "booster with linear_tree=true so the raw "
                          "values are kept)")
            r2i = np.asarray(ts.real_to_inner, np.int64)
            lf = np.asarray(tree.leaf_feat, np.int64)
            inner = np.where(lf >= 0, r2i[np.maximum(lf, 0)], -1)
            bad = (lf >= 0) & (inner < 0) & (tree.leaf_coeff != 0.0)
            if np.any(bad):
                log.fatal("Cannot replay a linear tree on this dataset: a "
                          "leaf's affine model reads feature(s) %s, which "
                          "the dataset binned as trivial",
                          sorted(set(lf[bad].tolist())))
            delta = delta + affine_epilogue(
                leaf, _to_device(torch.from_numpy(
                    tree.leaf_coeff.astype(np.float32)), dev),
                _to_device(torch.from_numpy(inner.astype(np.int32)), dev),
                dd.raw)
        dd.score[cls] += delta

    def _fit_linear(self, ta, leaf_id, grad, hess):
        """The per-leaf affine fit of one grown tree: (TreeArrays with the
        fitted intercepts, the host (coeff, feat) tables, the train-score
        delta).  One host read brings the intercepts, slopes and fallback
        count back for the model text."""
        td, view = self.train_data, self._view
        const, coeff, feat, delta, fb = fit_leaf_models(
            ta, view.bins, self._is_cat_host, td.raw, grad, hess,
            self._round_weight, self.shrinkage_rate, self._linear,
            leaf=leaf_id, bundle=view.bundle)
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
        return ta, (coeff_host, feat_host.reshape(L, K)), delta

    # -- row and feature sampling --------------------------------------
    def _bagging_mask(self, iter_: int) -> torch.Tensor:
        """Bagging (gbdt.cpp:201-280): ``bagging_fraction * N`` rows
        without replacement, drawn anew every ``bagging_freq`` rounds on
        the device (the JAX ``_bagging_mask``); the mask of the last
        draw in between."""
        cfg = self.config
        if cfg.bagging_freq <= 0 or cfg.bagging_fraction >= 1.0:
            self._bag_cnt = self.num_data
            return self._ones_weight
        if iter_ % cfg.bagging_freq == 0:
            bag_cnt = int(cfg.bagging_fraction * self.num_data)
            self._bag_key, sub = jrandom.split(self._bag_key)
            self._row_weight = device_bag_mask(
                sub, self._padded_rows, bag_cnt, self.num_data, self.device)
            self._bag_cnt = bag_cnt
        return self._row_weight

    def _feature_mask(self) -> torch.Tensor:
        """``feature_fraction`` of the used features for one tree
        (serial_tree_learner.cpp:226+), from the host generator of
        ``feature_fraction_seed`` as the JAX package draws it, within the
        screening mask of a screened round."""
        frac = self.config.feature_fraction
        screen = self._screen_mask
        if frac >= 1.0:
            return (self._full_feat_mask if screen is None
                    else self._full_feat_mask & screen)
        used = max(1, int(self.num_features * frac))
        idx = self._feature_rng.choice(self.num_features, used,
                                       replace=False)
        mask = np.zeros(self.num_features, bool)
        mask[idx] = True
        out = _to_device(torch.from_numpy(mask), self.device)
        return out if screen is None else out & screen

    def _gradients(self):
        return self.objective.gradients_with(self._grad_arrays,
                                             self.train_data.score)

    def _transform_gradients(self, grad, hess):
        """Hook for boosters that sample or scale the gradients of either
        source (GOSS); the identity here."""
        return grad, hess

    def train_one_iter(self, grad=None, hess=None) -> bool:
        """One boosting round (gbdt.cpp:295-382), from the objective's
        gradients or, for a custom objective, from ``grad`` and ``hess``
        (class-major, ``num_class * num_data`` values each, moved to the
        device once).  The bag mask and the feature masks are drawn in
        the JAX package's order (``_masks_before_gradients``).  Returns
        True when no class's tree could split (saturation): the round's
        trees are popped, as the reference pops them, and training
        should stop.

        ``nan_policy`` other than ``none`` checks the gradients before
        growing and the training scores after: a non-finite round is
        rolled back (``_contain_poisoned_iter``)."""
        it = self.iter_
        # the screening view and mask, before any mask draw reads them
        self._view = self._select_view()
        guard = self._nan_policy != "none"
        if guard:
            score0 = self.train_data.score.clone()
            vscores0 = [dd.score.clone() for dd in self.valid_data]
        poisoned = None
        feat_masks = None
        if grad is None and hess is None and self._masks_before_gradients:
            row_weight = self._bagging_mask(it)
            feat_masks = [self._feature_mask()
                          for _ in range(self.num_class)]
            grad, hess = self._gradients()
        else:
            if grad is None or hess is None:
                grad, hess = self._gradients()
            else:
                grad, hess = (_to_device(torch.from_numpy(
                    np.ascontiguousarray(a, np.float32).reshape(
                        self.num_class, -1)), self.device)
                    for a in (grad, hess))
            grad, hess = self._transform_gradients(grad, hess)
        if guard and not _all_finite(grad, hess):
            # caught before growing: the round grows nothing
            poisoned = "gradients/hessians"
        if feat_masks is None:
            row_weight = self._bagging_mask(it)
        self._round_weight = row_weight
        trees = []
        for cls in range(self.num_class) if poisoned is None else ():
            self._feat_mask = (feat_masks[cls] if feat_masks is not None
                               else self._feature_mask())
            ta, leaf_id, delta = self._grow(grad[cls], hess[cls])
            host_lin = None
            if self._linear is not None:
                # the grower's leaf of every row is the leaf a re-walk of
                # the grown structure over the bins finds (tested)
                ta, host_lin, delta = self._fit_linear(
                    ta, leaf_id, grad[cls], hess[cls])
            self.train_data.score[cls] += delta
            tree = Tree.from_arrays(ta, self.train_set.mappers,
                                    self.train_set.used_feature_map,
                                    self.shrinkage_rate)
            if host_lin is not None:
                attach_linear(tree, *host_lin,
                              self.train_set.used_feature_map)
            for dd in self.valid_data:
                self._add_host_tree_to(dd, tree, cls)
            self.tree_arrays.append(ta)
            trees.append(tree)
        if guard and poisoned is None \
                and not _all_finite(self.train_data.score):
            # finite gradients can still give a non-finite tree
            poisoned = "scores"
        if poisoned is not None:
            if trees:
                del self.tree_arrays[-len(trees):]
            return self._contain_poisoned_iter(it, poisoned, score0,
                                               vscores0)
        if self._screener is not None:
            # the realised gains feed the screener's average (a saturated
            # round's one-leaf trees add nothing but the decay)
            self._observe_pending()
            self._screen_pending = trees
            if not self._screen_observes_late:
                self._observe_pending()
        if all(t.num_leaves <= 1 for t in trees):
            log.warning("Stopped training because there are no more "
                        "leaves that meet the split requirements.")
            del self.tree_arrays[-self.num_class:]
            return True
        self._models.extend(trees)
        self.iter_ += 1
        return False

    def _contain_poisoned_iter(self, it: int, what: str, score0,
                               vscores0) -> bool:
        """NaN/Inf containment (``nan_policy``; the JAX
        ``_contain_poisoned_iter``): the scores go back to their values
        before round ``it``, then ``fail_fast`` raises and ``skip_tree``
        drops the round (nothing was committed to ``models``); the next
        call retries the same round index."""
        self.train_data.score = score0
        for dd, s0 in zip(self.valid_data, vscores0):
            dd.score = s0
        obj = getattr(self.objective, "name", "?")
        if self._nan_policy == "fail_fast":
            log.fatal(
                "non-finite %s at boosting iteration %d (objective=%s).  "
                "The model up to iteration %d is intact; inspect the "
                "objective/labels (or a custom fobj), or set "
                "nan_policy=skip_tree to drop poisoned iterations and "
                "continue.", what, it, obj, it)
        self._nan_skips += 1
        log.warning("nan_policy=skip_tree: dropping boosting iteration %d "
                    "(non-finite %s, objective=%s); %d iteration(s) "
                    "dropped so far", it, what, obj, self._nan_skips)
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

    def rollback_one_iter(self) -> None:
        """GBDT::RollbackOneIter (gbdt.cpp:384-402): pop the last round's
        ``num_class`` trees and add each one negated to the training and
        valid scores (a one-leaf tree adds nothing, as in the JAX
        package).  It may go back into an init model's trees."""
        if self.iter_ <= 0:
            return
        for cls in reversed(range(self.num_class)):
            tree = self.models.pop()
            if self.tree_arrays:
                self.tree_arrays.pop()
            if tree.num_leaves > 1:
                neg = tree.scaled_copy(-1.0)
                for dd in [self.train_data] + self.valid_data:
                    self._add_host_tree_to(dd, neg, cls)
        self.iter_ -= 1

    def _merge_identity(self):
        """(num_class, feature width, objective name) of a merge check;
        the name is '' when unknown (a bare loaded model) or ``none``,
        and then that check abstains."""
        name = getattr(self.objective, "name", "") or self.objective_name
        return self.num_class, self.max_feature_idx, \
            "" if name == "none" else name

    def merge_from(self, other: "GBDT",
                   shrinkage_decay: float = 1.0) -> None:
        """Append ``other``'s trees with their outputs scaled by
        ``shrinkage_decay`` (Boosting::MergeFrom with decay); refuses
        two models of different class counts, feature widths or
        objectives.  ``other`` is not touched."""
        d = float(shrinkage_decay)
        if not (0.0 < d <= 1.0) or d != d:
            raise LightGBMError(
                f"Cannot merge: shrinkage_decay must be in (0, 1], "
                f"got {shrinkage_decay!r}")
        nc_a, fw_a, obj_a = self._merge_identity()
        nc_b, fw_b, obj_b = other._merge_identity()
        if nc_a != nc_b:
            raise LightGBMError(
                f"Cannot merge: num_class mismatch "
                f"(base={nc_a}, other={nc_b})")
        if fw_a != fw_b:
            raise LightGBMError(
                f"Cannot merge: feature width mismatch "
                f"(base max_feature_idx={fw_a}, other={fw_b})")
        if obj_a and obj_b and obj_a != obj_b:
            raise LightGBMError(
                f"Cannot merge: objective mismatch "
                f"(base={obj_a!r}, other={obj_b!r})")
        self.models = list(self.models) + [t.scaled_copy(d)
                                           for t in other.models]
        self.iter_ = len(self.models) // max(self.num_class, 1)
        # the grown trees are no longer the last of ``models``
        self.tree_arrays = []

    def predict_leaf_index(self, X: np.ndarray,
                           num_iteration: int = -1) -> np.ndarray:
        """[n, num_trees] int32 leaf of every row in every tree, by the
        f64 host walk (GBDT::PredictLeafIndex)."""
        X = np.asarray(X, np.float64)
        n_models = len(self.models)
        if num_iteration > 0:
            n_models = min(n_models, num_iteration * self.num_class)
        if n_models == 0:
            return np.zeros((X.shape[0], 0), np.int32)
        return np.stack([self.models[i].predict_leaf_index(X)
                         for i in range(n_models)], axis=1)

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
    def feature_importance(self, importance_type: str = "split"
                           ) -> np.ndarray:
        """Per feature, the number of splits on it (``split``, int64) or
        the sum of their gains (``gain``, f64), over every tree
        (gbdt.cpp:765-789)."""
        counts = np.zeros(self.max_feature_idx + 1, np.float64)
        for tree in self.models:
            for i in range(tree.num_leaves - 1):
                f = tree.split_feature[i]
                if importance_type == "split":
                    counts[f] += 1
                elif importance_type == "gain":
                    counts[f] += tree.split_gain[i]
        if importance_type == "split":
            return counts.astype(np.int64)
        return counts

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
        counts = self.feature_importance()
        names = self.feature_names
        pairs = [(names[f] if f < len(names) else f"Column_{f}",
                  int(counts[f]))
                 for f in range(len(counts)) if counts[f] > 0]
        pairs.sort(key=lambda kv: -kv[1])
        for name, cnt in pairs:
            buf.write(f"{name}={cnt}\n")
        fp = self.data_fingerprint
        if fp is not None:
            if fp.score_hist is None and getattr(self, "train_data",
                                                 None) is not None:
                # raw training scores, filled at the first save
                fp.set_score_hist(self.train_data.host_score())
            buf.write("\n" + fp.to_text())
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
        self.num_init_iteration = len(self.models) // self.num_class
        self.iter_ = self.num_init_iteration
        self.objective = _PredictionObjective(
            self.objective_name, self.sigmoid, self.num_class)
        # the optional drift fingerprint after the footer: absent ->
        # None, truncated or garbled -> a named LightGBMError
        self.data_fingerprint = DataFingerprint.parse(text[footer_pos:])
