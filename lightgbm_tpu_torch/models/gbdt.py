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
there, with the JAX package's warning.

The admission gate (``_check_memory_budget``, the JAX package's): before
training allocates, the per-component estimate
(:func:`estimate_train_memory`) meets the card's budget
(:func:`_device_memory_limit`); ``memory_policy=fail_fast`` refuses an
estimate over it with a ``MemoryBudgetExceeded`` and its table,
``degrade`` walks the ladder (``score_donation``, ``hist_cache``,
``row_pad``; ``utils/resource.py``) first.  A valid set is re-checked when
it is attached, and ``reset_training_data`` runs the gate again.  Each
unit of a round runs under ``resource.oom_guard``: a CUDA allocation
failure becomes a ``DeviceOOM`` naming the unit (``bag_mask``,
``train_gradients``, ``train_step``, ``linear_fit``, ``valid_replay``,
``score_update``), and the round commits nothing before its last unit,
so the booster trains on after one.

Distributed learners (``tree_learner`` = ``data``, ``feature`` or
``voting`` over a ``torch.distributed`` group of more than one rank,
``parallel/``): ``_make_grow_fn`` grows each class's tree with
``parallel.make_parallel_grow`` over the group; every rank holds the
whole training set and the same scores, grows the same tree and keeps
the same model.  With a world of one the booster warns and trains
serial, as the JAX package does on one device.

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

Crash safety (``snapshot.py``): ``snapshot_state`` captures what a
resume needs under the JAX package's field names (the trees, the score
buffers read to the host, every RNG stream mid-sequence, the bag mask,
the screener) and ``restore_state`` writes it back into a booster of
the same config and data, refusing a config mismatch.  Under a
distributed learner each round's grow runs in the collective watchdog's
``Comm::grow`` phase (``parallel/watchdog.py``), and every
``distributed_consistency_check`` rounds the ranks compare digests of
their replicated state (``_maybe_check_consistency``), then stop or
take rank 0's state (``desync_policy``).
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import io
import os
import pickle
import re
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .. import obs
from ..device import resolve_device
from ..io.bundling import BundlePlan
from ..metric import create_metric
from ..obs.drift import DataFingerprint
from ..obs.trace import device_range
from ..objective import create_objective
from ..ops.bundle import BundleDecode
from ..ops.grow import GrowParams, SerialComm, _read, grow_tree
from ..ops.ordered_grow import grow_tree_ordered
from ..ops.predict import predict_binned_tree
from ..utils import log, resource, timetag
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
                          fused_scratch: bool = False,
                          leaf_cache: bool = True,
                          linear_k: int = 0,
                          grower: str = "cached",
                          scratch_blocks: int = 0,
                          bag_rows: int = 0) -> Dict[str, int]:
    """Rough device footprint (bytes) of training, by component, under
    the JAX package's names:

    * ``bins_device``: the column- and row-major bin copies (the EFB
      columns of a bundled dataset);
    * ``scores_and_gradients``: score, gradient, hessian and delta
      buffers of every class;
    * ``score_double_buffer``: zero, since the port adds each tree into
      the score buffer in place (the JAX term with ``donate_score``);
    * ``histogram_cache``: the ``[L, C, 9, B]`` int32 per-leaf cache of
      the cached and ordered growers (zero without ``leaf_cache``: the
      fused grower and the ``hist_cache`` step);
    * ``vmem_scratch``: the JAX fused kernel's two ``[F, B, 3]`` f32
      tiles (``fused_scratch``), plus, for ``scratch_blocks`` > 0 (the
      SMs of the card), K2's and K3's f64 partials, at most one
      ``[2, C, B, 3]`` f64 set a block;
    * ``linear_fit``: the JAX term (the raw ``[F, N]`` f32 copy, two
      ``[N, K+1]`` gathers, three ``[L, K+1, K+1]`` normal equations);
    * ``packed_payload``: the port's own: the ``[N, 9]`` int8 digits of
      the cached and ordered growers, and for ``grower="ordered"`` its
      row-major working copy of the bins and its int64 row order.  The
      JAX term's packed word lanes have no buffer in the port (its
      ordered grower partitions rows, not words; ``pack_u8_words``
      serves the probe P2 only);
    * ``working``: the port's own transients, summed although they
      are not all live at once: the objective's gradient temporaries
      (``24 N``: a few ``[N]`` f32 vectors); for the cached and ordered
      growers the digit split of ``quantize_digits`` (``96 N``: its
      ``[3, N]`` f32 and int32 steps and the ``[3, 3, N]`` int32 stack);
      the ordered partition's gathered segment and index vectors at the
      root (``N * (C + 54)`` bytes at uint8), or the fixed-trip growers'
      per-step row vectors (``32 N``) and the cached grower's compacted
      half; and, under bagging (``bag_rows`` > 0, the padded draw
      count), the draw's words, sorted words and indices.

    ``num_data`` is the unpadded row count: the port allocates no pad
    rows (the JAX package's pad reaches only the bag draw here)."""
    n, f = num_data, num_columns
    bins = 2 * n * f * bin_itemsize
    scores = num_models * n * 4 * 4
    cache = num_leaves * f * 9 * max_bin * 4 if leaf_cache else 0
    vmem = (2 * f * max_bin * 3 * 4) if fused_scratch else 0
    if scratch_blocks > 0:
        vmem += scratch_blocks * 2 * f * max_bin * 3 * 8 \
            + 2 * f * max_bin * 3 * 4
    linear = 0
    if linear_k > 0:
        m = linear_k + 1
        linear = n * f * 4 + 2 * n * m * 4 + 3 * num_leaves * m * m * 4
    payload = n * 9 if leaf_cache else 0
    working = 24 * n + (96 * n if leaf_cache else 0)
    if grower == "ordered":
        payload += n * (f * bin_itemsize + 8)
        working += n * (f * bin_itemsize + 54)
    else:
        working += 32 * n
        if leaf_cache:
            working += (n // 2) * (f * bin_itemsize + 9 + 8)
    if bag_rows > 0:
        working += bag_rows * 16
    return {"bins_device": bins, "packed_payload": payload,
            "scores_and_gradients": scores,
            "score_double_buffer": 0, "histogram_cache": cache,
            "vmem_scratch": vmem, "linear_fit": linear, "working": working,
            "total": (bins + payload + scores + cache + vmem + linear
                      + working)}


def estimate_valid_memory(num_data: int, num_features: int,
                          num_models: int,
                          bin_itemsize: int = 1) -> Dict[str, int]:
    """Device footprint (bytes) of attaching a validation set: its
    ``[C, N]`` bins, its ``[num_class, N]`` f32 scores, and one class's
    delta during a replay (the JAX package's terms)."""
    n = num_data
    bins = n * num_features * bin_itemsize
    scores = num_models * n * 4
    working = n * 4
    return {"bins_device": bins, "scores": scores, "working": working,
            "total": bins + scores + working}


def _device_memory_limit(device: Optional[torch.device] = None
                         ) -> Optional[int]:
    """The device budget in bytes, or None when unknown (the CPU).

    ``LGBT_DEVICE_MEMORY_BYTES`` overrides it (the JAX package reads the
    same variable, so one test sets both).  On a card it is the free
    memory ``torch.cuda.mem_get_info`` reports plus the bytes this
    process's caching allocator holds reserved (free to it, not to the
    card): not the card's total, since other processes, such as a second
    rank on the same card, hold the rest."""
    env = os.environ.get("LGBT_DEVICE_MEMORY_BYTES")
    if env:
        try:
            return int(env)
        except ValueError:
            log.warning("LGBT_DEVICE_MEMORY_BYTES=%r is not an integer; "
                        "ignoring", env)
    if device is None or torch.device(device).type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(device)
    return int(free) + int(torch.cuda.memory_reserved(device))


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


def _check_bin_width(config, train_set) -> None:
    """Refuse a booster whose ``max_bin`` is below its dataset's: the
    histograms are ``config.max_bin`` wide, so a wider dataset's bin
    codes would fall outside them (the JAX package drops those bins
    silently; on the card K1 would write past its histogram)."""
    if int(train_set.max_bin) > int(config.max_bin):
        raise LightGBMError(
            f"the dataset was binned with max_bin={int(train_set.max_bin)}"
            f", above the booster's max_bin={int(config.max_bin)}: its "
            f"histograms hold {int(config.max_bin)} bins a feature; build "
            f"the dataset with the booster's max_bin")


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
        up = [t for t in (self.bins, self.bins_rm, self.score, self.raw)
              if t is not None]
        obs.devprof.transfer("h2d", "dataset",
                             sum(int(t.nbytes) for t in up), len(up))

    def host_score(self) -> np.ndarray:
        """[num_models, num_data] f64 host copy of the score buffer."""
        return self.score.cpu().numpy().astype(np.float64)


def _tree_bytes(tree: Tree) -> bytes:
    """A tree's content as bytes, its fields in name order (the desync
    digest: a pickle of equal trees can differ in its memo references)."""
    parts = []
    for name, v in sorted(vars(tree).items()):
        if name == "_inner_mappers":
            continue
        parts.append(name.encode())
        parts.append(np.ascontiguousarray(v).tobytes()
                     if isinstance(v, np.ndarray) else repr(v).encode())
    return b"".join(parts)


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
    ``GBDT(config, train_set, device, objective)`` sets up serial
    training on ``device`` (default the card) from a ``BinnedDataset``,
    with ``objective`` (default the config's); ``train`` is the model
    layer's own loop over ``train_one_iter``."""

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
    # the torch.profiler window (obs/trace.py), set by _setup
    _trace = None
    #: the per-iteration event stream (``obs.EventRecorder``;
    #: ``set_event_recorder``), None when off
    _telemetry = None

    def __init__(self, config=None, train_set=None,
                 device: Optional[torch.device] = None, objective=None):
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
            self._setup(config, train_set, resolve_device(device), objective)

    # ------------------------------------------------------------------
    # training

    def _setup(self, config, train_set, device: torch.device,
               objective=None) -> None:
        config.check_trainable()
        _check_bin_width(config, train_set)
        self.config = config
        self.device = device
        self.train_set = train_set
        # the training data's fingerprint: a continued run carries the
        # fresh data's, not the init model's
        self.data_fingerprint = getattr(train_set, "data_fingerprint", None)
        self.objective = objective or create_objective(config)
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
        self._linear = self._setup_linear(config, train_set)
        self._setup_bundle(train_set)
        self._setup_screening(config)
        # the JAX package's draws cover its padded rows (row_buckets)
        self._padded_rows = (jrandom.bucket_rows(self.num_data)
                             if config.row_buckets else self.num_data)
        # the admission gate, before any training buffer is allocated
        self._check_memory_budget(config, train_set)
        # the collectives' account over the booster's life (snapshots
        # carry it)
        self._cum_comm_calls = self._cum_comm_bytes = 0
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
        self._bag_cnt = self.num_data
        self._bag_key = jrandom.prng_key(config.bagging_seed)
        self._feature_rng = np.random.RandomState(
            config.feature_fraction_seed)
        self._nan_policy = config.nan_policy
        self._nan_skips = 0
        # the JAX GBDT's best-iteration bookkeeping, carried by snapshots
        self.best_iteration = -1
        self.best_score: Dict = {}
        self.best_msg: Dict = {}
        # the desync detector (a world of one never calls it)
        self._consistency_every = int(config.distributed_consistency_check)
        self._desync_policy = config.desync_policy
        # TreeArrays (host) of each tree this booster grew: the last
        # len(tree_arrays) trees of ``models`` (a rollback pops them; a
        # merge, which appends other trees, drops them)
        self.tree_arrays: list = []
        self.linear_fallbacks = 0
        # the torch.profiler window (trace_dir / LIGHTGBM_TPU_TRACE_DIR)
        self._trace = obs.TraceCapture.from_config(config, device)

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
        _check_bin_width(config, self.train_set)
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
        if params != self.grow_params or rescreen \
                or old.tree_learner != config.tree_learner:
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
        mode = scr.round_mode(it)
        if mode != "screened":
            if mode == "refresh":
                obs.inc("screen_refresh_total")
                scr.refresh_total += 1
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

    def _estimate_now(self, cfg, train_set,
                      padded_rows: Optional[int] = None) -> Dict[str, int]:
        """:func:`estimate_train_memory` of this booster as it stands:
        its grower, its degrade steps, its card."""
        kind = self._serial_grow_kind()
        full_pass = kind in ("fused", "nocache") or self._parallel_world() > 1
        sms = 0
        if full_pass and self.device.type == "cuda":
            sms = torch.cuda.get_device_properties(
                self.device).multi_processor_count
        sampled = (cfg.boosting_type == "goss"
                   or (cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0))
        padded = self._padded_rows if padded_rows is None else padded_rows
        return estimate_train_memory(
            self.num_data, train_set.num_columns, cfg.num_leaves, cfg.max_bin,
            self.num_class, bin_itemsize=train_set.bins.dtype.itemsize,
            fused_scratch=kind == "fused",
            leaf_cache=kind in ("cached", "ordered") and not full_pass,
            linear_k=(self._linear.max_features
                      if self._linear is not None else 0),
            grower=kind, scratch_blocks=sms,
            bag_rows=padded if sampled else 0)

    def _check_memory_budget(self, cfg, train_set) -> None:
        """The admission gate (the JAX ``_check_memory_budget``): the
        estimate against the card's budget, under ``memory_policy``.

        ``histogram_pool_size`` (MB) below the per-leaf cache takes the
        ``hist_cache`` step under ``degrade`` and warns under
        ``fail_fast``.  Then, with a budget (:func:`_device_memory_limit`),
        ``degrade`` walks the ladder (:meth:`_walk_degrade_ladder`) while
        the estimate is over it, and an estimate still over it is refused
        with ``MemoryBudgetExceeded`` and its table, before any training
        buffer is allocated.  The ``hbm_*`` gauges and the OOM
        diagnosis's table are published either way."""
        policy = resource.check_memory_policy(cfg.memory_policy)
        est = self._estimate_now(cfg, train_set)
        pool_mb = float(cfg.histogram_pool_size)
        if pool_mb > 0 and est["histogram_cache"] > pool_mb * (1 << 20):
            if policy == "degrade":
                self._apply_degrade(
                    "hist_cache", est["histogram_cache"],
                    f"histogram_pool_size={pool_mb:g}MB bounds the "
                    f"per-leaf histogram cache "
                    f"({est['histogram_cache'] / (1 << 20):.0f}MB "
                    f"resident): dropping the cache — children recompute "
                    f"instead of sibling-subtraction")
                est = self._estimate_now(cfg, train_set)
            else:
                log.warn_once(
                    "histogram_pool_size",
                    "histogram_pool_size=%.0fMB requested but the device "
                    "design keeps the whole per-leaf histogram cache "
                    "resident (%.0fMB for num_leaves=%d x %d columns x 9 x "
                    "%d bins); under memory_policy=fail_fast the parameter "
                    "does NOT bound memory — lower num_leaves/max_bin, or "
                    "set memory_policy=degrade to make the bound real",
                    pool_mb, est["histogram_cache"] / (1 << 20),
                    cfg.num_leaves, train_set.num_columns, cfg.max_bin)
        limit = _device_memory_limit(self.device)
        obs.set_gauge("hbm_budget_bytes", int(limit) if limit else -1)
        if limit and est["total"] > limit and policy == "degrade":
            est = self._walk_degrade_ladder(cfg, train_set, est, limit)
        obs.set_gauge("hbm_train_estimate_bytes", int(est["total"]))
        obs.set_gauge("hbm_histogram_cache_bytes",
                      int(est["histogram_cache"]))
        resource.set_budget_table(
            est, f"train rows={self.num_data} "
                 f"cols={train_set.num_columns} "
                 f"leaves={cfg.num_leaves} bins={cfg.max_bin}")
        if limit and est["total"] > limit:
            raise resource.refuse(est, limit, "training",
                                  self._degrade_steps)
        # the running account add_valid_dataset re-checks against
        self._train_mem_est = int(est["total"])
        self._valid_mem_bytes = 0

    def _apply_degrade(self, step: str, saved_bytes: int,
                       detail: str) -> None:
        if step == "hist_cache":
            self._degrade_leaf_cache_off = True
        elif step == "row_pad":
            self._padded_rows = self.num_data
        self._degrade_steps = self._degrade_steps + (step,)
        resource.note_degrade(step, saved_bytes, detail)

    def _walk_degrade_ladder(self, cfg, train_set, est: Dict[str, int],
                             limit: int) -> Dict[str, int]:
        """Apply the ladder's steps in order until the estimate fits or
        every available step is spent.  A step that is unavailable is
        skipped with a debug line: ``score_donation`` always (the port
        updates the scores in place, so there is no second buffer to
        drop), ``hist_cache`` for the fused grower or a zero cache,
        ``row_pad`` when the bag draw covers no pad rows."""
        for step in resource.DEGRADE_STEPS:
            if est["total"] <= limit:
                break
            if step == "score_donation":
                log.debug("degrade step score_donation unavailable (the "
                          "score update is already in place)")
                continue
            if step == "hist_cache":
                if self._degrade_leaf_cache_off \
                        or cfg.serial_grow == "fused" \
                        or est["histogram_cache"] <= 0:
                    log.debug("degrade step hist_cache unavailable "
                              "(fused grower or no cache)")
                    continue
                saved = est["histogram_cache"]
                detail = ("dropping the [L, F, 9, B] per-leaf histogram "
                          "cache — children recompute instead of "
                          "sibling-subtraction (slower, never wrong)")
            else:
                if self._padded_rows <= self.num_data:
                    log.debug("degrade step row_pad unavailable (no pad "
                              "rows)")
                    continue
                pad = self._padded_rows - self.num_data
                saved = est["total"] - self._estimate_probe_rows(
                    cfg, train_set)["total"]
                detail = (f"capping the row-bucket pad ({pad} pad rows "
                          f"released; the bag draw covers the rows alone)")
            self._apply_degrade(step, max(int(saved), 0), detail)
            est = self._estimate_now(cfg, train_set)
        return est

    def _estimate_probe_rows(self, cfg, train_set) -> Dict[str, int]:
        """The estimate as it would be with the pad capped (the
        ``row_pad`` step's saving), without applying it."""
        return self._estimate_now(cfg, train_set,
                                  padded_rows=self.num_data)

    def _parallel_world(self) -> int:
        """The ranks a distributed learner would span: the default
        group's world when ``tree_learner`` is not ``serial`` and a group
        is up, else 1."""
        if self.config.tree_learner == "serial":
            return 1
        from ..parallel.multihost import process_rank_world
        return process_rank_world()[1]

    def _make_grow_fn(self):
        """The grower of this booster's kind, as ``fn(grad, hess) ->
        (TreeArrays, leaf_id, delta)`` over the round's histogram view
        (``_view``) of the training data.

        A distributed ``tree_learner`` over a group of more than one rank
        (TreeLearner::CreateTreeLearner, tree_learner.cpp) grows with
        ``parallel.make_parallel_grow`` over the default group, with its
        static traffic account of a tree; with a world of one it warns
        and trains serial, as the JAX package does on one device.  Unlike
        the JAX package, whose leaf-ordered grower packs uint8 bins into
        words and falls back to the cached learner for more than 256
        bins, the port's ordered grower takes uint16 bins too, and its
        trees equal the cached grower's; so ``ordered`` stays
        ``ordered``."""
        cfg = self.config
        self._comm_traffic = None
        self._comm_traffic_totals = (0, 0)
        self._parallel_grow = None
        if cfg.tree_learner != "serial":
            world = self._parallel_world()
            if world > 1:
                return self._make_parallel_grow_fn(world)
            log.warning("tree_learner=%s requested but only %d device(s) "
                        "available; falling back to serial",
                        cfg.tree_learner, world)
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

    def _make_parallel_grow_fn(self, world: int):
        from ..parallel import make_parallel_grow
        from ..parallel.comm import observe_traffic, traffic_totals
        cfg = self.config
        log.info("Using %s-parallel tree learner over %d ranks",
                 cfg.tree_learner, world)
        self.grow_kind = f"parallel_{cfg.tree_learner}"
        fn = make_parallel_grow(None, cfg.tree_learner, self.grow_params,
                                top_k=cfg.top_k)
        # data-parallel reduces column histograms under EFB (the whole
        # histogram, all-reduced); voting and feature ship per-feature
        # payloads
        traffic_f = (self.num_columns if cfg.tree_learner == "data"
                     else self.num_features)
        self._comm_traffic = fn.traffic_per_tree(
            traffic_f, bundled=self._bundle is not None)
        self._comm_traffic_totals = traffic_totals(self._comm_traffic)
        self._parallel_grow = fn

        def grow(grad, hess):
            from ..parallel import watchdog
            view = self._view
            wd = watchdog.active_watchdog()
            t0 = time.perf_counter()
            # Comm::grow: the tree's collectives under the watchdog's
            # deadline and peer check; a raised collective error waits
            # for the heartbeats before it unwinds (a killed peer is a
            # named abort with exit code 75)
            try:
                with obs.span("Comm::grow"), (
                        wd.phase("Comm::grow") if wd is not None
                        else contextlib.nullcontext()):
                    out = fn(view.bins, self.num_bin, self.is_cat,
                             self._feat_mask, grad, hess,
                             self._round_weight, self.shrinkage_rate,
                             bundle=view.bundle)
            except watchdog.DistributedAborted:
                raise
            except Exception as e:
                if wd is not None:
                    wd.classify_collective_error(e, "Comm::grow")
                raise
            # the collectives block until every rank took part: a real
            # duration, the sample the auto deadline derives from
            dt = time.perf_counter() - t0
            obs.observe("comm_seconds", dt)
            if wd is not None:
                wd.note_comm_seconds(dt)
            observe_traffic(self._comm_traffic)
            calls, nbytes = self._comm_traffic_totals
            self._cum_comm_calls += calls
            self._cum_comm_bytes += nbytes
            return out
        return grow

    def reset_training_data(self, train_set) -> None:
        """GBDT::ResetTrainingData (gbdt.cpp:101-167; the JAX
        ``reset_training_data``): a new training set on the same mappers,
        the objective and training metrics re-initialised on it, the
        admission gate run again against it (the valid sets' account
        kept), and every tree of ``models`` replayed into a fresh score
        buffer."""
        old = self.train_set
        if [m.to_state() for m in old.mappers] != \
                [m.to_state() for m in train_set.mappers]:
            log.fatal("Cannot reset training data, since new training data "
                      "has different bin mappers")
        self._observe_pending()
        cfg, dev = self.config, self.device
        self.train_set = train_set
        fp = getattr(train_set, "data_fingerprint", None)
        if fp is not None:
            self.data_fingerprint = fp
        self.num_data = train_set.num_data
        self.objective.init(train_set.metadata, train_set.num_data)
        self.num_columns = train_set.num_columns
        self.num_bin = torch.from_numpy(
            train_set.num_bin_per_feature()).to(dev)
        self.is_cat = torch.from_numpy(
            train_set.is_categorical_per_feature()).to(dev)
        self._is_cat_host = torch.from_numpy(
            train_set.is_categorical_per_feature())
        self._setup_bundle(train_set)
        self._linear = self._setup_linear(cfg, train_set)
        self._padded_rows = (jrandom.bucket_rows(self.num_data)
                             if cfg.row_buckets else self.num_data)
        valid_bytes = self._valid_mem_bytes
        self._check_memory_budget(cfg, train_set)
        self._valid_mem_bytes = valid_bytes
        self.train_data = _DeviceData(train_set, self.num_class, dev,
                                      with_row_major=True,
                                      with_raw=self._linear is not None)
        self.train_metrics = self._make_metrics(train_set)
        self._grad_arrays = self.objective.gradient_arrays(dev)
        td = self.train_data
        self._full_view = self._view = _HistView(td.bins, td.bins_rm,
                                                 self._bundle)
        self._ones_weight = torch.ones(self.num_data, dtype=torch.float32,
                                       device=dev)
        self._row_weight = self._round_weight = self._ones_weight
        self._bag_cnt = self.num_data
        self._setup_screening(cfg)
        self._grow = self._make_grow_fn()
        self.tree_arrays = []
        for i, tree in enumerate(self.models):
            self._add_host_tree_to(td, tree, i % self.num_class)

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
        # the gate again, with this valid set counted: attached late, it
        # is the allocation the construction check could not see
        est = estimate_valid_memory(
            valid_set.num_data, valid_set.num_columns, self.num_class,
            bin_itemsize=valid_set.bins.dtype.itemsize)
        valid_bytes = self._valid_mem_bytes + int(est["total"])
        total = self._train_mem_est + valid_bytes
        obs.set_gauge("hbm_total_estimate_bytes", int(total))
        limit = _device_memory_limit(self.device)
        if limit and total > limit:
            log.fatal(
                "attaching this validation set (%d rows: bins=%.0fMB, "
                "scores=%.0fMB) brings the estimated device footprint to "
                "%.0fMB, over the budget %.0fMB (training state %.0fMB + "
                "valid sets %.0fMB).  Evaluate on fewer/smaller valid "
                "sets, or shrink the training state (num_leaves/max_bin).",
                valid_set.num_data, est["bins_device"] / (1 << 20),
                est["scores"] / (1 << 20), total / (1 << 20),
                limit / (1 << 20), self._train_mem_est / (1 << 20),
                valid_bytes / (1 << 20))
        self._valid_mem_bytes = valid_bytes
        if self._linear is not None and valid_set.raw is None:
            log.fatal("linear_tree validation scoring needs the valid "
                      "set's raw feature values (the per-leaf affine "
                      "epilogue reads them); create the valid set with "
                      "reference=train from an in-memory matrix")
        dd = _DeviceData(valid_set, self.num_class, self.device,
                         with_raw=self._linear is not None)
        # every tree of ``models``, loaded ones too; tree i belongs to
        # class i % num_class (the JAX add_valid_dataset)
        with resource.oom_guard("valid_replay",
                                lambda: resource.render_shapes(dd.bins,
                                                               dd.score),
                                self.device, profile="predict_forest"):
            for i, tree in enumerate(self.models):
                self._add_host_tree_to(dd, tree, i % self.num_class)
        self.valid_data.append(dd)
        self.valid_metrics.append(self._make_metrics(valid_set))

    def _add_host_tree_to(self, dd: _DeviceData, tree: Tree,
                          cls: int) -> None:
        """Add a host ``Tree`` (grown, loaded or negated) to class ``cls``
        of ``dd``'s scores (:meth:`_host_tree_delta`)."""
        dd.score[cls] += self._host_tree_delta(dd, tree)

    def _host_tree_delta(self, dd: _DeviceData, tree: Tree):
        """What a host ``Tree`` adds to each row of ``dd``: its bin-space
        splits against the training mappers (``ensure_inner``), the plain
        binned walk, then the affine part of linear leaves (the JAX
        ``_add_host_tree_to``); a float for a one-leaf tree.  A grown
        tree adds its leaf values and slopes, f32 values held in f64, so
        exactly what its fit added to the training scores.  A tree that
        splits on a feature trivial in the training data, or whose affine
        part reads one, or a linear tree on a set without raw values, is
        fatal."""
        if tree.num_leaves <= 1:
            return float(tree.leaf_value[0]) if tree.num_leaves else 0.0
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
        return delta

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
        rolled back (``_contain_poisoned_iter``).

        The desync check runs first, before this round's gradients read
        a state that may have diverged (``_maybe_check_consistency``).

        The round is one ``GBDT::iteration`` span: a wall-time histogram
        observe and, with the tracer armed, the root of the round's span
        tree; it never synchronizes the device.  A ``trace_dir`` window
        opens before a round's span and closes after it.  With
        ``devprof`` on, ``round_scope`` splits the round into host and
        device shares."""
        resynced = self._maybe_check_consistency()
        if resynced and grad is not None:
            log.warning(
                "desync resync at iteration %d arrived after this "
                "round's custom-objective gradients were computed from "
                "the pre-resync scores; the pod stays consistent but "
                "this one round ingests the stale gradients", self.iter_)
        # the trace window opens and closes outside the round's span, so
        # every round inside it is one whole GBDT::iteration range
        it = self.iter_
        if self._trace is not None:
            self._trace.iter_begin(it)
        try:
            with obs.devprof.round_scope(), obs.span("GBDT::iteration"):
                return self._train_one_iter_impl(grad, hess)
        finally:
            # a round that fails fast on NaN still closes its window
            if self._trace is not None:
                self._trace.iter_end(it, sync=self.train_data.score)

    def close_trace(self) -> None:
        """Stop a trace window the training loop ended inside."""
        if self._trace is not None:
            self._trace.close()

    def _train_one_iter_impl(self, grad, hess) -> bool:
        """Body of one boosting round (``train_one_iter``).

        The TIMETAG scopes are the JAX round's: a standard round (the
        JAX fused step) is ``GBDT::bagging``, one ``GBDT::tree`` over the
        gradients and every class's growth, and ``GBDT::valid_score`` a
        class; a custom objective or GOSS (the JAX per-stage path) is
        ``GBDT::boosting``, ``GBDT::bagging``, then a class's
        ``GBDT::tree``, ``Bin::linear_fit``, ``GBDT::train_score`` and
        ``GBDT::valid_score``; both end in one ``GBDT::host_tree``, the
        grown trees built on the host.  Off, each scope is one flag
        read.  Under a recording profiler every scope is also a range,
        and both shapes add the ranges TIMETAG's fused account lacks:
        ``GBDT::boosting`` around the fused gradients, ``GBDT::bagging``
        around the feature masks, ``GBDT::train_score`` around the fused
        score update.  Each unit of device work runs under its OOM
        guard, the devprof seam, on the training device."""
        it = self.iter_
        rec = self._telemetry
        t_iter0 = time.perf_counter() if rec is not None else 0.0
        tt0 = (timetag.get_timings()
               if rec is not None and timetag.ENABLED else None)
        dev = self.device
        # the screening view and mask, before any mask draw reads them
        self._view = self._select_view()
        guard = self._nan_policy != "none"
        if guard:
            score0 = self.train_data.score.clone()
            vscores0 = [dd.score.clone() for dd in self.valid_data]
        poisoned = None
        feat_masks = None
        td = self.train_data
        fused = (grad is None and hess is None
                 and self._masks_before_gradients)
        # the JAX fused step is one GBDT::tree over gradients and growth
        tree_scope = (timetag.scope("GBDT::tree") if fused
                      else contextlib.nullcontext())
        with tree_scope as tt_fused:
            if fused:
                with timetag.scope("GBDT::bagging"), resource.oom_guard(
                        "bag_mask", lambda: resource.render_shapes(
                            td.score[0]), dev):
                    row_weight = self._bagging_mask(it)
                with device_range("GBDT::bagging"):
                    feat_masks = [self._feature_mask()
                                  for _ in range(self.num_class)]
                with device_range("GBDT::boosting"), resource.oom_guard(
                        "train_gradients", lambda: resource.render_shapes(
                            td.score), dev):
                    grad, hess = self._gradients()
            else:
                with timetag.scope("GBDT::boosting") as tt:
                    if grad is None or hess is None:
                        with resource.oom_guard(
                                "train_gradients",
                                lambda: resource.render_shapes(td.score),
                                dev):
                            grad, hess = self._gradients()
                    else:
                        grad, hess = (_to_device(torch.from_numpy(
                            np.ascontiguousarray(a, np.float32).reshape(
                                self.num_class, -1)), dev)
                            for a in (grad, hess))
                    grad, hess = self._transform_gradients(grad, hess)
                    tt.sync((grad, hess))
            if guard and not _all_finite(grad, hess):
                # caught before growing: the round grows nothing
                poisoned = "gradients/hessians"
            if feat_masks is None:
                with timetag.scope("GBDT::bagging"), resource.oom_guard(
                        "bag_mask", lambda: resource.render_shapes(
                            td.score[0]), dev):
                    row_weight = self._bagging_mask(it)
            self._round_weight = row_weight
            # every class's tree and deltas first, the commits after: a
            # unit that dies in an allocation leaves the booster as it was
            grown = []
            for cls in range(self.num_class) if poisoned is None else ():
                if feat_masks is not None:
                    self._feat_mask = feat_masks[cls]
                else:
                    with device_range("GBDT::bagging"):
                        self._feat_mask = self._feature_mask()
                view = self._view
                with (contextlib.nullcontext() if fused
                      else timetag.scope("GBDT::tree")) as tt, \
                        resource.oom_guard(
                            "train_step", lambda: resource.render_shapes(
                                grad[cls], hess[cls], self._round_weight,
                                view.bins, view.bins_rm), dev):
                    ta, leaf_id, delta = self._grow(grad[cls], hess[cls])
                    if tt is not None:
                        tt.sync(delta)
                host_lin = None
                if self._linear is not None:
                    # the grower's leaf of every row is the leaf a re-walk
                    # of the grown structure over the bins finds (tested)
                    with (contextlib.nullcontext() if fused
                          else timetag.scope("Bin::linear_fit")) as tt, \
                            resource.oom_guard(
                                "linear_fit", lambda: resource.render_shapes(
                                    td.raw, grad[cls], leaf_id), dev):
                        ta, host_lin, delta = self._fit_linear(
                            ta, leaf_id, grad[cls], hess[cls])
                        if tt is not None:
                            tt.sync(delta)
                grown.append((cls, ta, host_lin, delta))
            if tt_fused is not None:
                tt_fused.sync([d for _, _, _, d in grown])
        with timetag.scope("GBDT::host_tree"):
            grown = [(cls, ta, self._host_tree(ta, host_lin), delta)
                     for cls, ta, host_lin, delta in grown]
        # a class's valid-set deltas under its GBDT::valid_score, as the
        # JAX round scores them (one scope a class, valid sets or not)
        replays = [[] for _ in self.valid_data]
        for _, _, tree, _ in grown:
            with timetag.scope("GBDT::valid_score") as tt:
                for dd, out in zip(self.valid_data, replays):
                    with resource.oom_guard(
                            "valid_replay", lambda: resource.render_shapes(
                                dd.bins, dd.score), dev,
                            profile="predict_forest"):
                        out.append(self._host_tree_delta(dd, tree))
                tt.sync([out[-1] for out in replays])
        with resource.oom_guard("score_update",
                                lambda: resource.render_shapes(td.score),
                                dev):
            for (cls, _, _, delta) in grown:
                with (device_range("GBDT::train_score") if fused
                      else timetag.scope("GBDT::train_score")) as tt:
                    td.score[cls] += delta
                    if not fused:
                        tt.sync(td.score)
            for dd, deltas in zip(self.valid_data, replays):
                for (cls, _, _, _), d in zip(grown, deltas):
                    dd.score[cls] += d
        trees = []
        for _, ta, tree, _ in grown:
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
        saturated = all(t.num_leaves <= 1 for t in trees)
        if rec is not None:
            # the shapes of trees already on the host: no device read
            shapes = [{"num_leaves": int(t.num_leaves),
                       "max_depth": int(t.max_depth())} for t in trees]
            if saturated:
                rec.note(it, saturated=True, trees=shapes)
            else:
                rec.note(it, trees=shapes)
        if saturated:
            log.warning("Stopped training because there are no more "
                        "leaves that meet the split requirements.")
            del self.tree_arrays[-self.num_class:]
        else:
            self._models.extend(trees)
            self.iter_ += 1
        self._note_iter_event(it, t_iter0, tt0)
        return saturated

    def _host_tree(self, ta, host_lin) -> Tree:
        """The host ``Tree`` of a grown tree's arrays (and linear
        leaves); the arrays' bytes are the round's ``host_tree``
        device-to-host account (the grower read them off the card)."""
        obs.devprof.transfer(
            "d2h", "host_tree",
            sum(int(v.nbytes) for v in ta if isinstance(v, torch.Tensor)))
        tree = Tree.from_arrays(ta, self.train_set.mappers,
                                self.train_set.used_feature_map,
                                self.shrinkage_rate)
        if host_lin is not None:
            attach_linear(tree, *host_lin, self.train_set.used_feature_map)
        return tree

    # -- telemetry (obs/) ----------------------------------------------
    def set_event_recorder(self, recorder) -> None:
        """Attach an ``obs.EventRecorder``: one JSONL record per boosting
        iteration (wall time, bag count, grown-tree shapes, cumulative
        collective account; eval values arrive through
        ``callback.log_telemetry``).  ``None`` detaches."""
        self._telemetry = recorder

    def _note_iter_event(self, it: int, t0: float, tt0=None) -> None:
        """Note the round's host-side fields of its event record.
        ``phases`` holds the round's TIMETAG deltas against ``tt0``, the
        accumulator at the round's start (None while TIMETAG is off: then
        ``{}``, as the JAX booster writes it)."""
        rec = self._telemetry
        if rec is None:
            return
        phases = {}
        if tt0 is not None:
            now = timetag.get_timings()
            phases = {k: round(v - tt0.get(k, 0.0), 6)
                      for k, v in now.items() if v > tt0.get(k, 0.0)}
        rec.note(it, wall_s=round(time.perf_counter() - t0, 6),
                 phases=phases, bag_cnt=int(self._bag_cnt),
                 comm_bytes_cum=int(self._cum_comm_bytes),
                 comm_calls_cum=int(self._cum_comm_calls))

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
        obs.inc("nan_iterations_dropped")
        rec = self._telemetry
        if rec is not None:
            rec.note(it, nan_poisoned=what, nan_policy=self._nan_policy)
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

    # -- distributed desync detection ----------------------------------
    def _maybe_check_consistency(self) -> bool:
        """Every ``distributed_consistency_check`` rounds of a group of
        more than one rank, check that every rank holds the same trees,
        scores and RNG streams.  One process, or K = 0: returns before
        any collective.  True when a resync restored state."""
        K = self._consistency_every
        if K <= 0:
            return False
        from ..parallel.multihost import process_rank_world
        rank, world = process_rank_world()
        if world <= 1:
            return False
        it = self.iter_ - self.num_init_iteration
        if it <= 0 or it % K != 0:
            return False
        # the same guard as Comm::grow: a rank dying in this gather is a
        # bounded, named abort
        from ..parallel.watchdog import active_watchdog
        wd = active_watchdog()
        with obs.span("Dist::consistency"):
            if wd is not None:
                with wd.guard("Dist::consistency"):
                    return self._check_distributed_consistency(rank, world)
            return self._check_distributed_consistency(rank, world)

    def _portable_trees(self) -> List[Tree]:
        """Shallow copies of ``models`` that name their bin mappers
        instead of holding them: ``"train"`` for this booster's training
        mappers, None for any other (a replay then bins the thresholds
        again).  A snapshot pickles these."""
        mappers = self.train_set.mappers
        out = []
        for t in self._models:
            c = copy.copy(t)
            c._inner_mappers = ("train" if t._inner_mappers is mappers
                                else None)
            out.append(c)
        return out

    def _consistency_digests(self) -> Dict[str, int]:
        """A uint64 digest (a sha256 prefix) of each field of the
        replicated training state, so a divergence names what diverged."""
        def d(blob: bytes) -> int:
            return int.from_bytes(hashlib.sha256(blob).digest()[:8],
                                  "little")

        return {
            "iter": d(np.int64([self.iter_, len(self._models)]).tobytes()),
            "trees": d(b"".join(_tree_bytes(t) for t in self._models)),
            "score": d(self.train_data.score.cpu().numpy().tobytes()),
            "rng": d(np.asarray(self._bag_key, np.uint32).tobytes()
                     + pickle.dumps(self._feature_rng.get_state())
                     + self._row_weight.cpu().numpy().tobytes()),
        }

    def _check_distributed_consistency(self, rank: int,
                                       world: int) -> bool:
        """Gather the digests, compare, and on a divergence apply
        ``desync_policy``: ``fail_fast`` raises naming the diverged
        rank(s) and field(s) (every rank runs the same gather, so every
        rank stops); ``resync`` broadcasts rank 0's ``snapshot_state``
        and restores it on the other ranks (True)."""
        from ..parallel import comm
        fields = self._consistency_digests()
        names = list(fields)
        mine = np.array([fields[n] for n in names], np.uint64)
        gathered = np.asarray(comm.allgather_host_array(mine))  # [world, F]
        if bool((gathered == gathered[0]).all()):
            return False
        obs.inc("desync_detected_total")
        diverged: Dict[str, List[int]] = {}
        for fi, name in enumerate(names):
            col = gathered[:, fi]
            vals, counts = np.unique(col, return_counts=True)
            top = int(counts.max())
            majority = {int(v) for v, c in zip(vals, counts)
                        if int(c) == top}
            # the majority wins; a tie (any pair of ranks) defers to
            # rank 0, the source a resync trusts
            ref = (int(col[0]) if int(col[0]) in majority
                   else next(iter(sorted(majority))))
            bad = [r for r in range(world) if int(col[r]) != ref]
            if bad:
                diverged[name] = bad
        detail = "; ".join(
            f"field {name!r} diverged on rank(s) {bad}"
            for name, bad in diverged.items())
        if self._desync_policy == "fail_fast":
            log.fatal(
                "distributed state desync detected at iteration %d "
                "(%d-process run): %s.  Every rank must hold identical "
                "replicated training state; set desync_policy=resync to "
                "broadcast rank 0's state instead of stopping, and see "
                "docs/FAULT_TOLERANCE.md §Distributed.",
                self.iter_, world, detail)
        if any(0 in bad for bad in diverged.values()):
            # the majority voted rank 0, the resync's source, the
            # diverged one: broadcasting it would spread the corruption
            log.fatal(
                "distributed state desync detected at iteration %d: %s — "
                "rank 0 is the resync source of truth but is itself the "
                "diverged rank; refusing to propagate its state "
                "(desync_policy=resync falls back to failing fast here).",
                self.iter_, detail)
        log.warning("distributed state desync detected at iteration %d: "
                    "%s — resyncing every rank from rank 0's state",
                    self.iter_, detail)
        payload = (pickle.dumps(self.snapshot_state(),
                                protocol=pickle.HIGHEST_PROTOCOL)
                   if rank == 0 else None)
        blob = comm.broadcast_host_bytes(payload, is_source=(rank == 0))
        if rank != 0:
            self.restore_state(pickle.loads(blob))
        obs.inc("desync_resyncs_total")
        return True

    # -- crash-safe snapshot / resume (snapshot.py) ----------------------
    def _snapshot_fingerprint(self) -> Dict:
        return {
            "objective": getattr(self.objective, "name", "?"),
            "num_class": int(self.num_class),
            "num_data": int(self.num_data),
            "num_features": int(self.num_features),
            "num_leaves": int(self.grow_params.num_leaves),
        }

    def snapshot_state(self) -> Dict:
        """The resumable training state on the host, under the JAX
        package's field names.  Restoring it onto a booster of the same
        config and data is bit-exact: the score buffers are saved as
        arrays (a replay of the trees would add in another order) and
        every RNG stream resumes mid-sequence.  The port adds its own
        fields: the screener's drawn view and its pending round, and the
        linear fallback count.  ``tree_arrays`` restarts empty (it holds
        the last trees this booster object grew)."""
        if not hasattr(self, "train_set"):
            log.fatal("snapshot_state requires a training booster "
                      "(loaded prediction-only models have no "
                      "resumable state)")
        scr = self._screener
        return {
            "submodel": self.submodel_name,
            "fingerprint": self._snapshot_fingerprint(),
            "models": self._portable_trees(),
            "iter_": int(self.iter_),
            "num_init_iteration": int(self.num_init_iteration),
            "best_iteration": int(self.best_iteration),
            "best_score": dict(self.best_score),
            "best_msg": dict(self.best_msg),
            "shrinkage_rate": float(self.shrinkage_rate),
            # rounds run synchronously: a saturated round reports itself
            # from its own call, so no stop signal is ever pending
            "no_more_splits": False,
            "train_score": self.train_data.score.cpu().numpy(),
            "valid_scores": [dd.score.cpu().numpy()
                             for dd in self.valid_data],
            "bag_key": np.asarray(self._bag_key, np.uint32),
            "row_weight": self._row_weight.cpu().numpy(),
            "bag_cnt": int(self._bag_cnt),
            "feature_rng": self._feature_rng.get_state(),
            "cum_comm": (int(self._cum_comm_calls),
                         int(self._cum_comm_bytes)),
            "nan_skips": int(self._nan_skips),
            "screen_state": scr.state() if scr is not None else None,
            "screen_view": ((self._screen_period, list(self.screen_periods),
                             self._screen_pending)
                            if scr is not None else None),
            "linear_fallbacks": int(self.linear_fallbacks),
        }

    def restore_state(self, state: Dict) -> None:
        """The inverse of ``snapshot_state`` on a new booster of the same
        params and data.  Valid sets attached before get their saved
        scores back by position; one the snapshot lacks replays the
        restored trees.  The score buffers are written in place."""
        if state.get("submodel") != self.submodel_name:
            log.fatal("snapshot was taken by a %r booster; this run is "
                      "configured as %r", state.get("submodel"),
                      self.submodel_name)
        fp = state.get("fingerprint", {})
        mine = self._snapshot_fingerprint()
        if fp and fp != mine:
            diff = {k: (fp.get(k), mine[k]) for k in mine
                    if fp.get(k) != mine[k]}
            log.fatal("snapshot/config mismatch, refusing to resume "
                      "(snapshot vs current): %s", diff)
        dev = self.device
        self._models = list(state["models"])
        for t in self._models:
            t._inner_mappers = (self.train_set.mappers
                                if isinstance(t._inner_mappers, str)
                                else None)
        self.iter_ = int(state["iter_"])
        self.num_init_iteration = int(state["num_init_iteration"])
        self.best_iteration = int(state["best_iteration"])
        self.best_score = dict(state["best_score"])
        self.best_msg = dict(state["best_msg"])
        self.shrinkage_rate = float(state["shrinkage_rate"])
        self.train_data.score.copy_(torch.from_numpy(
            np.asarray(state["train_score"], np.float32)))
        saved_valid = state.get("valid_scores", [])
        for vi, dd in enumerate(self.valid_data):
            saved = saved_valid[vi] if vi < len(saved_valid) else None
            if saved is not None and tuple(np.shape(saved)) \
                    == tuple(dd.score.shape):
                dd.score.copy_(torch.from_numpy(
                    np.asarray(saved, np.float32)))
            else:
                for i, tree in enumerate(self._models):
                    self._add_host_tree_to(dd, tree, i % self.num_class)
        self._bag_key = tuple(int(v) for v in state["bag_key"])
        rw = np.asarray(state["row_weight"], np.float32)[:self.num_data]
        self._row_weight = (self._ones_weight if bool(np.all(rw == 1.0))
                            else _to_device(torch.from_numpy(rw.copy()),
                                            dev))
        self._bag_cnt = int(state["bag_cnt"])
        self._feature_rng.set_state(state["feature_rng"])
        self._cum_comm_calls, self._cum_comm_bytes = \
            (int(v) for v in state["cum_comm"])
        self._nan_skips = int(state.get("nan_skips", 0))
        self.linear_fallbacks = int(state.get("linear_fallbacks", 0))
        scr = self._screener
        if scr is not None:
            scr.restore(state.get("screen_state"))
            period, periods, pending = state.get("screen_view") \
                or (-1, [], None)
            self._screen_period = int(period)
            self.screen_periods = list(periods)
            self._screen_pending = pending
            self._screen_mask = self._active_view = None
            if self._screen_period >= 0 and self.screen_periods:
                # the view drawn for the current period, as it was
                cols = self.screen_periods[-1][1]
                self._screen_mask = _to_device(
                    torch.from_numpy(scr.screen_mask(cols)), dev)
                self._active_view = self._build_active_view(cols)

    def _metric_sets(self):
        return [("training", self.train_data, self.train_metrics)] + [
            (f"valid_{i + 1}", dd, ms) for i, (dd, ms) in
            enumerate(zip(self.valid_data, self.valid_metrics))]

    def eval_set(self, key: str) -> List[tuple]:
        """[(metric name, value, bigger is better)] on the set named
        ``key`` (``training`` or ``valid_<i>``), from an f64 host copy of
        its scores; one ``GBDT::metric`` TIMETAG scope (the JAX
        ``Booster.__eval_at``'s)."""
        with timetag.scope("GBDT::metric"):
            return self._eval_set(key)

    def _eval_set(self, key: str) -> List[tuple]:
        for k, dd, metrics in self._metric_sets():
            if k == key:
                score = dd.host_score()
                return [(name, v, m.factor_to_bigger_better > 0)
                        for m in metrics
                        for name, v in zip(m.names, m.eval(score))]
        raise KeyError(key)

    def eval_metrics(self) -> Dict[str, Dict[str, float]]:
        """Every metric of the training set and each valid set, under one
        ``GBDT::metric`` TIMETAG scope (the JAX ``eval_metrics``'s)."""
        with timetag.scope("GBDT::metric"):
            return {k: {name: v for name, v, _ in self._eval_set(k)}
                    for k, _, metrics in self._metric_sets() if metrics}

    def eval_and_check_early_stopping(self) -> bool:
        """Metric evaluation and the early-stop bookkeeping on the first
        metric of each valid set (gbdt.cpp:404-509); logs
        ``Iteration:N, valid_1 auc : x`` lines every ``output_freq``
        rounds.  Returns True to stop training."""
        cfg = self.config
        out_lines = []
        if cfg.is_training_metric and self.train_metrics:
            with timetag.scope("GBDT::metric"):
                score = self.train_data.host_score()
                for m in self.train_metrics:
                    for name, v in zip(m.names, m.eval(score)):
                        out_lines.append(f"Iteration:{self.iter_}, "
                                         f"training {name} : {v:g}")
        stop = False
        for vi, (dd, metrics) in enumerate(zip(self.valid_data,
                                               self.valid_metrics)):
            score = dd.host_score()
            for mi, m in enumerate(metrics):
                values = m.eval(score)
                for name, v in zip(m.names, values):
                    out_lines.append(f"Iteration:{self.iter_}, "
                                     f"valid_{vi + 1} {name} : {v:g}")
                key = (vi, m.names[0])
                cur = m.factor_to_bigger_better * values[0]
                if key not in self.best_score or cur > self.best_score[key]:
                    self.best_score[key] = cur
                    if mi == 0:
                        self.best_iteration = self.iter_
                        self.best_msg[vi] = "\n".join(out_lines)
                elif cfg.early_stopping_round > 0 and mi == 0:
                    if (self.iter_ - self.best_iteration
                            >= cfg.early_stopping_round):
                        log.info("Early stopping at iteration %d, best "
                                 "iteration %d", self.iter_,
                                 self.best_iteration)
                        stop = True
        if out_lines and self.iter_ % max(cfg.output_freq, 1) == 0:
            for line in out_lines:
                log.info("%s", line)
        return stop

    def train(self, num_iterations: Optional[int] = None) -> None:
        """The model layer's own loop (Application::Train,
        application.cpp:224-240): ``train_one_iter`` rounds, the round
        ``engine.train`` runs, each followed by
        ``eval_and_check_early_stopping`` when there is a metric to read,
        until ``num_iterations`` (default ``num_iterations`` of the
        config), saturation or early stopping."""
        n = num_iterations or self.config.num_iterations
        try:
            for _ in range(n):
                stop = self.train_one_iter()
                if not stop and (self.valid_data
                                 or self.config.is_training_metric):
                    stop = self.eval_and_check_early_stopping() or stop
                if stop:
                    break
        finally:
            self.close_trace()

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

    def predict(self, X: np.ndarray, num_iteration: int = -1) -> np.ndarray:
        """[K, n] scores through the objective's transform (sigmoid,
        softmax or identity; gbdt.cpp:799-815), from the f64 host walk."""
        raw = self.predict_raw(X, num_iteration)
        if self.objective is None:
            return raw
        return np.asarray(self.objective.convert_output(raw))

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

    def save_model_to_file(self, path: str, num_iteration: int = -1) -> None:
        """The model text written atomically (``utils/diskguard.py``): a
        full disk is a named error and the previous file survives."""
        from ..utils.diskguard import write_artifact_atomic
        text = self.save_model_to_string(num_iteration)
        write_artifact_atomic(path, text.encode(), "model_file")

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
