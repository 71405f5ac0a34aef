#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training and probe paths on one
NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--timing-reps 20]

Every phase prints one JSON line (the probes phase first prints the
probes' own lines); any failure raises and exits non-zero.

1. ``build``: nvcc builds every kernel under ``lightgbm_tpu_torch/csrc/``
   for ``sm_90a`` (one nvcc per source, all started together); every
   instantiation of P2's kernel must show a 0-byte stack frame in the
   ``-Xptxas -v`` report.
2. ``kernels``: each kernel's wrapper on tensors on the card, held
   against its plain PyTorch version on the same inputs.  Forest walks
   (bit-equal, ``torch.equal``: both fold the same f32 per-tree values in
   one Kahan order): a small binary forest (3 categorical and 5 numeric
   features, 10% NaN, f32-colliding cut values, 31 leaves, 20 trees), a
   multiclass forest with a ragged number of trees per class, and the
   Higgs forest below at the bucket sizes its serving run uses; then
   every variant on the walk's edge cases (``walk_edges``: one tree, 37
   trees, which the plan's chunk does not divide, and a chain tree 254
   levels deep, each frozen with f32 and bf16, constant and linear
   leaves) at B = 1, one tile - 1, one tile + 1 and 4096 rows.  The leaf
   histogram K1 (exact int32 sums, so bit-equal, ``torch.equal``): uint8
   and uint16 bins, F in {5, 28, 30, 136}, windows of S in {0, 1, 4097,
   65536, 1000000} rows at a row offset,
   on the wrapper's choice of path and on each of its two paths forced;
   and at every window class of the train phase (2^10 to 2^20 rows) on
   both paths.
   The children histograms K2 and the fused split candidates K3 (f32
   atomics: the tolerances of ``ops/children_hist.py``): uint8 with 255
   bins and uint16 with 1000, F in {5, 28, 30}, N in the same sizes, a
   third of the rows in each child and a third elsewhere, plus the root
   forms at 1M rows and the 1M-row full pass with 2^14, 2^17, 2^19 and
   all rows in the two children; K3's features and
   thresholds equal except at reported near-ties.  Each call adds exactly
   one to its launch counter.
   The linear and bf16 variants of the walk (``linear_forest``): the
   Higgs forest below made piece-wise linear (its own random trees, one
   feature categorical; every leaf of ~90% of the trees gets 5 affine
   slots from its own path features, the categorical one included,
   N(0, 0.01) coefficients, ~10% of the slots -1 pads) with uint16 bins,
   the same at 250 cut values (uint8 bins), and a linear multiclass
   forest with a ragged tail, all on rows with 5% NaN; the linear walks
   bit-equal to their plain versions (both sum the slots in ascending
   order with one rounding per product and per add).  The bf16 variants,
   on the Higgs forests with leaf values scaled by 1e-2
   (``serve_quantize_leaves`` keeps bf16 for them), bit-equal to the
   plain walk on the dequantized table.
   The probe kernels (``compare_probes``): the roll chain P1 bit-equal
   to its plain version on the probe's seeded [12, 2048] input, two
   more seeds and four blocks of adversarial keys (all equal, only
   INT_MIN and INT_MAX, sorted either way), and after the probe's
   50-call ``^ 1`` chain; the device-windowed digit histogram P2 on the
   probe's 2^20 rows bit-equal to its plain version and to K1 on the
   same window, for both digit layouts (packed words, [N, 9] matrix), on
   the probe's window (5, N/2), an empty one, one row, one ending at N,
   one whose offset is not a multiple of any TPU nb and one clamped past
   N (bin 255 present); a profiled P2 call records its one kernel and no
   other device work (no memset, no fill; a profile that records nothing
   fails); then the probe's 10-call loop for each of its five runs, each
   offset computed on the card from the last output, under
   ``torch.cuda.set_sync_debug_mode("error")``, against a plain replay.
3. ``serve``: the serving path at full width.  A Higgs-sized forest
   (binary, 28 features, 500 trees, 255 leaves, 255 cut values per
   feature: LightGBM's published Higgs experiment settings) is written
   from ``--seed`` in the LightGBM text format, loaded by
   ``serve_from_config`` on port 0, and asked by four client threads for
   1, 64 and 4096 rows each, then one client for five 1-row requests
   in a row.  Every response is held against the plain
   version on the card (same f32 binning, <= 1e-6); ``Booster.predict``
   (host f64 binning, then the binned kernel) is held against the f64
   host walk ``Tree.predict`` (raw <= 1e-5).  The launch counters are set
   to 0 just before this phase and read just after it.
   ``serve_linear``: the linear Higgs forest served the same way
   (``serve_nonfinite_policy=propagate``, 2% NaN in the rows; responses
   against the plain linear walk, ``/healthz`` reports ``linear``),
   ``Booster.predict`` (the binned linear kernel) against the f64 host
   walk with its affine part, then ``serve_from_config`` with
   ``serve_quantize_leaves=true`` three times: the two scaled forests
   (constant and linear) must freeze to bfloat16 and predict through
   both paths within QUANTIZE_LEAF_ATOL + 1e-5 of the f64 host walk;
   the linear Higgs forest itself, whose summed bf16 error is far over
   the pin, must stay float32 with one ``forest_quantize_fallback``.
   Counters set to 0 before and read after; every linear and bf16
   variant must have launched.
4. ``train``: the training path at full width: the bench operating point
   (binary, ``make_higgs_like(1000000)`` from ``--seed``, 28 features,
   ``num_leaves=63``, ``max_bin=255``, ``learning_rate=0.1``,
   ``min_data_in_leaf=50``), 10 rounds of ``lightgbm_tpu_torch.train``
   with a 100k-row valid set, once per grower on the same datasets: the
   default ``ordered``, ``serial_grow=cached``, ``serial_grow=fused`` and
   ``histogram_pool_size=1 memory_policy=degrade`` (the nocache grower).
   The launch counters are set to 0 just before each run and read just
   after.  Checks (``train_run``): (a) the run's histogram kernel
   launches equal Σ over trees of 1 + splits (ordered) or rounds ×
   num_leaves (the fixed-trip growers), and no other histogram kernel
   ran; (b) the first two trees re-grown on the card through the plain
   versions from the same gradients: bit-identical for ordered and
   cached, structure-equal up to a reported f32 near-tie for fused and
   nocache; (c) ``Booster.predict(raw_score=True)`` of the saved model
   on 4096 train rows equals the training score buffer to 1e-5; (d)
   train and valid AUC finite, above 0.5 and rising, and every grower's
   final valid AUC within 1e-3 of the ordered run's; (e) the cached trees
   structure-equal to the ordered ones, values within 1e-6 relative.
   One more round per grower, outside the counted run, splits the
   round's time into the histogram kernel, the split scan (and the
   ordered grower's partition) and the rest with CUDA events.  The
   datasets keep raw values, and a fifth run trains ``linear_tree=true``
   (``linear_max_leaf_features=5``, ``linear_lambda=0.01``, the ordered
   grower): its launches as ordered's, tree 1 and 2 re-grown (from the
   run's own scores) and re-fit through the plain versions
   structure-equal, the saved model against
   the score buffer (1e-5) and against the f64 host walk with its affine
   part (1e-5), AUC rising, and the fit's share of a round.  Every run
   also counts its histogram kernel's launches by the power-of-two
   class of the rows each scans (``train_windows``: printed only).
   ``examples``: each of the repo's four example confs
   (``examples/{binary_classification,regression,multiclass_classification,
   lambdarank}/train.conf``) through ``lightgbm_tpu_torch.cli.main`` in a
   copy of its directory, once with ``device=cuda`` and once with
   ``device=cpu``, 10 rounds, then its ``predict.conf`` (raw scores) on
   the test file with each model and the card once more with the CPU's
   model: the binary conf loads ``binary.train.weight``, the lambdarank
   conf reads LibSVM with its ``.query`` files and ``ndcg_at=1,3,5``,
   the multiclass conf trains 5 classes, and the regression conf runs
   with ``bagging_fraction``, ``bagging_freq`` and ``feature_fraction``
   taken out (refused until bagging and feature fraction are ported; its
   line says so).  K1 launches Σ over trees of (1 + splits) in the
   card's run and K4 in every card prediction; the card's trees equal
   the CPU's up to a reported f32 near-tie, every round's metrics agree
   within 1e-4 (a ranking metric beyond it only at a near-tie of scores,
   shown by recomputing it from both models), the card's predictions of
   the CPU model within 1e-5 of the CPU's, and of its own model too
   unless a near-tie flipped a split.
   ``objectives``: every objective the port added, at the train phase's
   operating point (``num_leaves=63``, ``max_bin=255``): multiclass (5
   classes, labels the quintiles of a seeded latent over
   ``make_higgs_like(1000000)`` features) and LambdaRank (MSLR-WEB10K's
   shape: 136 dense features, relevance 0-4, query sizes from the seed
   in [1, 1024], mean ~120, 1M rows), 10 rounds each; regression,
   regression_l1, huber and fair on the same latent and poisson on
   counts from it, 5 rounds each.  Each run: K1's launches equal Σ over
   trees of (1 + splits); the first tree of each class re-grown through
   the plain versions from the same gradients is bit-identical; the
   saved model through K4 equals the score buffer within 1e-5; the
   training metric improves; the card's gradients on the final scores
   equal the same function's on the CPU within 1e-6 relative (of each
   value plus the largest; LambdaRank's too); and each round's seconds and the gradient's share of it (CUDA
   events) are printed.
5. ``probes``: the probes' own entry points, ``python -m
   lightgbm_tpu_torch.tools.probe_roll`` and ``probe_dynhist`` (their
   ``main``) at the JAX probes' sizes, each with its launch counter set
   to 0 just before and read just after.
6. ``timing``: each walk variant on the Higgs forest at B in {1, 256,
   4096, 65536} (the linear and bf16 variants on their forests, beside
   the constant walk over the same trees; plain versions at B = 4096, and
   at every B for the constant f32 walks), timed four ways as ``timed``
   does (single call, back to back, host enqueue, device time by kernel
   name: pass 0, 1 and 2) with its launch plan; CUDA-event medians of
   K1, K2 and K3
   at S in {4096, 65536, 500000, 1000000} beside their plain versions
   and the ``index_add_`` library call, and of P1 and P2 at the probes'
   shapes (P1 beside three launch floors and a CUDA graph's replay; P2
   at each of the probe's runs, beside K1 on the same window and
   ``index_add_`` on the unpacked window; both timed four ways), each
   beside its bound.  ``k1_windows``: K1's small path, large
   path, the wrapper as the growers call it and
   ``index_add_`` at every window class the train phase counts (2^10 to
   2^20 rows), each alone (``single_ms``: events around one call, the
   host's enqueue included), back to back (``back_to_back_ms``), by its
   host enqueue (``host_enqueue_us``) and by its device time per kernel
   name from ``torch.profiler`` (``device_us``, or "not measured"); the
   crossover of the two paths.
   ``k3_occupancy``: K3 and K2 on the 1M-row full pass
   with 2^14, 2^17, 2^19 and all rows in the children, timed the same
   ways, beside the ``index_add_`` computing K2's function
   (``library_ms``), and K2's root form (no leaf array).  Then ``rule2``:
   the kernels in the order to redesign them, first those that lose to
   the PyTorch call computing the same function at the sizes the main
   path launches them (K1 timed at each window class the train phase
   counted), then by launches x (ms - bound), each with the PR that
   redesigned it.

Then the kernels summary line, the card's name and power limit as
``nvidia-smi`` gives them, and last ``{"ok": true, "device": {...}}``.
Without a CUDA card the script exits non-zero before printing a result.
"""

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

WALKS = tuple(f"forest_walk{raw}{lin}{q}" for raw in ("", "_raw")
              for lin in ("", "_linear") for q in ("", "_bf16"))
SOURCE = {**{name: "lightgbm_tpu_torch/csrc/forest_walk.cu"
             for name in WALKS},
          "digit_histogram": "lightgbm_tpu_torch/csrc/leaf_hist.cu",
          "children_histograms": "lightgbm_tpu_torch/csrc/children_hist.cu",
          "fused_split_candidates":
              "lightgbm_tpu_torch/csrc/children_hist.cu",
          "roll_chain": "lightgbm_tpu_torch/csrc/roll_chain.cu",
          "window_digit_histogram": "lightgbm_tpu_torch/csrc/window_hist.cu"}
# the binned and raw entry points of the TPU walk; their aff= option is
# the affine epilogue (pallas_walk.py:238-242), a bf16 lv their :236 cast
REPLACES = {**{name: "lightgbm_tpu/ops/pallas_walk.py:"
               + ("391" if "_raw" in name else "372") for name in WALKS},
            "digit_histogram": "lightgbm_tpu/ops/leafhist.py:138",
            "children_histograms": "lightgbm_tpu/ops/pallas_histogram.py:185",
            "fused_split_candidates":
                "lightgbm_tpu/ops/pallas_histogram.py:232",
            "roll_chain": "tools/probe_roll.py:45",
            "window_digit_histogram": "tools/probe_dynhist.py:148"}
# the PR of the port that redesigned a kernel after its first port
REDESIGNED = {"digit_histogram": 6, "fused_split_candidates": 6,
              "children_histograms": 7, **{name: 7 for name in WALKS},
              "roll_chain": 8, "window_digit_histogram": 8}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
TOL = 1e-6
HIGGS = dict(num_features=28, num_trees=500, num_leaves=255, num_cuts=255)
LINEAR_K = 5                   # affine slots a leaf (linear_max_leaf_features)
LINEAR_CAT = (3,)              # the linear Higgs forest's categorical feature
TINY_LEAVES = 1e-2             # leaf scale the bf16 pin accepts at 500 trees
SERVE_SIZES = (1, 64, 4096)
SERVE_CLIENTS = 4
SOLO = 5                       # sequential 1-row requests after the load
TIMING_SIZES = (1, 256, 4096, 65536)
TRAIN_PARAMS = {"objective": "binary", "metric": "auc", "num_leaves": 63,
                "max_bin": 255, "learning_rate": 0.1, "min_data_in_leaf": 50}
TRAIN_ROWS, VALID_ROWS, TRAIN_ROUNDS = 1_000_000, 100_000, 10
HIST_SIZES = (0, 1, 4097, 65536, 1_000_000)
HIST_FEATURES = (5, 28, 30)
HIST_TIMING_SIZES = (4096, 65536, 500_000, 1_000_000)
# K1's window classes on the training path (the power-of-two classes the
# train phase counts: 2^10 .. 2^20 rows) and its paths (None: the
# wrapper's choice); K3's leaf occupancies at the 1M-row full pass (rows in
# the two children)
WINDOW_CLASSES = tuple(1 << k for k in range(10, 21))
K1_PATHS = (None, "small", "large")
OCCUPANCIES = (1 << 14, 1 << 17, 1 << 19, 1 << 20)
# a split of a re-grown tree may differ from the kernel run's only where
# the two choices' gains are this close (relative): an f32 near-tie
TREE_TIE_RTOL = 1e-3
# the training runs: (grower, extra params, the histogram kernel it runs);
# the cache of 63 x 28 x 9 x 255 int32 (16 MB) is over a 1 MB pool
# (the datasets keep raw values for the linear run, so the constant runs
# say linear_tree=false)
CONST = {"linear_tree": False}
LINEAR_PARAMS = {"linear_tree": True, "linear_max_leaf_features": LINEAR_K,
                 "linear_lambda": 0.01}
GROWERS = (("ordered", {**CONST}, "digit_histogram"),
           ("cached", {**CONST, "serial_grow": "cached"}, "digit_histogram"),
           ("fused", {**CONST, "serial_grow": "fused"},
            "fused_split_candidates"),
           ("nocache", {**CONST, "histogram_pool_size": 1,
                        "memory_policy": "degrade"}, "children_histograms"),
           ("linear", LINEAR_PARAMS, "digit_histogram"))
REPO = os.path.dirname(os.path.abspath(__file__))
# the examples phase: (name, folder of examples/), the rounds, and the
# keys taken out of a conf because the port refuses them (bagging and
# feature_fraction are not ported yet)
EXAMPLES = (("binary", "binary_classification"), ("regression", "regression"),
            ("multiclass", "multiclass_classification"),
            ("lambdarank", "lambdarank"))
EXAMPLE_ROUNDS = 10
EXAMPLE_DROPPED = {"regression": ("bagging_fraction", "bagging_freq",
                                  "feature_fraction")}
# card against CPU, a leaf value within this share of its tree's largest:
# f32 sums in another order (an H100 read 5.0e-5 at most, PERF.md)
EXAMPLE_LEAF_RTOL = 2e-4
# the objectives phase: the train phase's operating point, the MSLR-like
# width, and (objective, extra params, rounds, labels) for each run
OBJ_ROWS = 1_000_000
OBJ_PARAMS = {"num_leaves": 63, "max_bin": 255, "learning_rate": 0.1,
              "min_data_in_leaf": 50}
RANK_FEATURES = 136
OBJECTIVE_RUNS = (
    ("multiclass", {"num_class": 5}, 10, "multiclass"),
    ("lambdarank", {"ndcg_eval_at": "1,3,5,10"}, 10, "rank"),
    ("regression", {}, 5, "continuous"),
    ("regression_l1", {}, 5, "continuous"),
    ("huber", {}, 5, "continuous"),
    ("fair", {}, 5, "continuous"),
    ("poisson", {}, 5, "counts"))
# the card's gradients against the CPU's, relative to each value plus
# the largest (LambdaRank's pair sums associate otherwise on the card)
GRAD_RTOL = 1e-6


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


# ---------------------------------------------------------------------------
# model and rows from a seed


def cut_grid(rng, num_features: int, num_cuts: int) -> np.ndarray:
    """[F, C] per-feature N(0,1) quantiles: the cut values a LightGBM
    dataset of normal features gets from ``max_bin = C + 1``."""
    q = np.arange(1, num_cuts + 1) / (num_cuts + 1.0)
    sample = rng.normal(size=(num_features, 1 << 15))
    return np.quantile(sample, q, axis=1).T.copy()


def random_tree(rng, num_leaves, grid, cat_features, num_cats):
    """A tree grown leaf-wise by splitting a uniformly random leaf, in
    the LightGBM node layout (leaves are ``~index`` in the child
    arrays)."""
    from lightgbm_tpu_torch.models.tree import Tree
    t = Tree(num_leaves)
    parent = [-1]                         # node whose child is ~leaf
    for i in range(num_leaves - 1):
        leaf, new = int(rng.randint(i + 1)), i + 1
        p = parent[leaf]
        if p >= 0:
            if t.left_child[p] == ~leaf:
                t.left_child[p] = i
            else:
                t.right_child[p] = i
        f = int(rng.randint(grid.shape[0]))
        t.split_feature[i] = f
        if f in cat_features:
            t.decision_type[i] = 1
            t.threshold[i] = float(rng.randint(num_cats))
        else:
            t.threshold[i] = grid[f, rng.randint(grid.shape[1])]
        t.left_child[i], t.right_child[i] = ~leaf, ~new
        parent[leaf] = i
        parent.append(i)
    t.leaf_parent[:] = parent
    t.leaf_value[:] = rng.normal(0.0, 0.01, num_leaves)
    return t


def random_model(seed: int, num_features: int, num_trees: int,
                 num_leaves: int, num_cuts: int, num_class: int = 1,
                 cat_features=(), num_cats: int = 0, collide: bool = False,
                 ragged_tail: int = 0):
    """A ``GBDT`` of random trees plus its cut grid.  ``collide`` puts
    f64 cut values one ulp apart, which the f32 cut table merges;
    ``ragged_tail`` adds that many trees after the last full round, and
    every fifth tree of a multiclass forest has one leaf."""
    from lightgbm_tpu_torch.models.gbdt import GBDT, _PredictionObjective
    from lightgbm_tpu_torch.models.tree import Tree
    rng = np.random.RandomState(seed)
    grid = cut_grid(rng, num_features, num_cuts)
    if collide:
        for j in range(1, num_cuts, 7):
            grid[:, j] = np.nextafter(grid[:, j - 1], np.inf)
    g = GBDT()
    g.num_class = num_class
    g.max_feature_idx = num_features - 1
    g.sigmoid = 1.0 if num_class == 1 else -1.0
    g.feature_names = [f"Column_{i}" for i in range(num_features)]
    g.feature_infos_ = ["none"] * num_features
    g.objective = _PredictionObjective(
        "binary sigmoid:1" if num_class == 1
        else f"multiclass num_class:{num_class}", g.sigmoid, num_class)
    for i in range(num_trees * num_class + ragged_tail):
        if num_class > 1 and i % 5 == 4:
            t = Tree(1)
            t.leaf_value[0] = rng.normal(0.0, 0.01)
        else:
            t = random_tree(rng, num_leaves, grid, set(cat_features),
                            num_cats)
        g.models.append(t)
    return g, grid


def leaf_path_features(tree):
    """Each leaf's split features from the leaf up to the root, repeats
    dropped (categorical ones kept)."""
    parent = {}
    for node in range(tree.num_leaves - 1):
        for child in (tree.left_child[node], tree.right_child[node]):
            if child >= 0:
                parent[int(child)] = node
    out = []
    for leaf in range(tree.num_leaves):
        feats, node = [], int(tree.leaf_parent[leaf])
        while node >= 0:
            f = int(tree.split_feature[node])
            if f not in feats:
                feats.append(f)
            node = parent.get(node, -1)
        out.append(feats)
    return out


def make_linear(g, seed: int, const_frac: float = 0.1,
                pad_frac: float = 0.1):
    """Give every leaf of ~(1 - const_frac) of ``g``'s trees LINEAR_K
    affine slots from its own path features (categorical ones included,
    as loaded model text may name them), N(0, 0.01) coefficients, and
    ``pad_frac`` of the slots -1; the other trees stay constant."""
    rng = np.random.RandomState(seed)
    for t in g.models:
        if t.num_leaves <= 1 or rng.rand() < const_frac:
            continue
        feat = np.full((t.num_leaves, LINEAR_K), -1, np.int32)
        for leaf, fs in enumerate(leaf_path_features(t)):
            fs = fs[:LINEAR_K]
            feat[leaf, :len(fs)] = fs
        feat[rng.rand(*feat.shape) < pad_frac] = -1
        t.leaf_feat = feat
        t.leaf_coeff = np.where(feat >= 0,
                                rng.normal(0.0, 0.01, feat.shape), 0.0)
    return g


def scaled(g, factor: float):
    """A copy of ``g`` (through its model text) with every leaf value
    times ``factor``; affine coefficients unchanged."""
    from lightgbm_tpu_torch.models.gbdt import GBDT
    out = GBDT.from_string(g.save_model_to_string())
    for t in out.models:
        t.leaf_value = t.leaf_value * factor
    return out


def random_rows(rng, n: int, grid, cat_features=(), num_cats: int = 0,
                nan_frac: float = 0.0, tie_frac: float = 0.0) -> np.ndarray:
    """[n, F] f64 rows: N(0,1) values, ``tie_frac`` of them exactly on a
    cut value, categorical codes in [0, num_cats + 3) (some unseen), and
    ``nan_frac`` NaN."""
    F = grid.shape[0]
    X = rng.normal(size=(n, F))
    ties = rng.rand(n, F) < tie_frac
    X[ties] = grid[np.nonzero(ties)[1], rng.randint(grid.shape[1],
                                                    size=int(ties.sum()))]
    for f in cat_features:
        X[:, f] = rng.randint(0, num_cats + 3, size=n)
    X[rng.rand(n, F) < nan_frac] = np.nan
    return X


def make_higgs_like(num_data: int, num_features: int = 28, seed: int = 42):
    """The bench's synthetic stand-in for the Higgs dataset (a few
    informative low-level features, quadratic 'derived' features, heavy
    noise); a copy, so the script needs nothing outside the port."""
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(num_data, num_features)).astype(np.float32)
    X[:, 7:14] = np.abs(X[:, 7:14])
    X[:, 14:21] = X[:, 0:7] * X[:, 7:14]
    logit = (0.8 * X[:, 0] - 0.6 * X[:, 1] + 0.5 * X[:, 14]
             - 0.4 * X[:, 15] + 0.3 * X[:, 7] * X[:, 2]
             + rng.normal(scale=1.5, size=num_data))
    y = (logit > 0).astype(np.float32)
    return X.astype(np.float64), y


def hist_inputs(rng, rows: int, F: int, max_bin: int, dtype, dev):
    """Row-major bins [rows, F] and balanced int8 digits [rows, 9] of
    random g/h and an all-ones w, on ``dev``."""
    from lightgbm_tpu_torch.ops import leafhist as lh
    bins = torch.from_numpy(rng.randint(0, max_bin, size=(rows, F))
                            .astype(dtype)).to(dev)
    g = torch.from_numpy(rng.normal(size=rows).astype(np.float32)).to(dev)
    h = torch.from_numpy(rng.uniform(0.01, 0.25, size=rows)
                         .astype(np.float32)).to(dev)
    w = torch.ones(rows, dtype=torch.float32, device=dev)
    return bins, lh.quantize_digits(g, h, w, lh.compute_scales(g, h, w))


def leaf_depths(tables) -> np.ndarray:
    """[K, T, L] nodes visited on the way to each leaf (an absorbing
    tree's leaf 0 counts its one root visit)."""
    _, _, _, lc, rc, lv = (a.cpu().numpy() for a in tables.stacks())
    K, T, _ = lc.shape
    depth = np.zeros((K, T, lv.shape[2]), np.int64)
    for k in range(K):
        for t in range(T):
            stack = [(0, 1)]
            while stack:
                node, d = stack.pop()
                for child in (lc[k, t, node], rc[k, t, node]):
                    if child < 0:
                        depth[k, t, ~child] = d
                    else:
                        stack.append((int(child), d + 1))
    return depth


# ---------------------------------------------------------------------------
# phases


def stack_frames(log: str):
    """{kernel: bytes of stack frame} from an ``nvcc -Xptxas -v`` report
    (the line after each "Function properties for <kernel>")."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = ln.rsplit("for", 1)[1].strip()
        elif name is not None and "bytes stack frame" in ln:
            out[name] = int(ln.split("bytes stack frame")[0].split()[-1])
            name = None
    return out


def phase_build():
    """Builds every kernel; P2's kernels (every ``window_hist``
    instantiation) must show a stack frame of 0 bytes: no pointer table
    in local memory."""
    from lightgbm_tpu_torch.ops import _build
    t0 = time.perf_counter()
    secs = _build.build_all()
    wall = time.perf_counter() - t0
    report = [ln.strip() for name in secs
              for ln in _build.build_log(name).splitlines()
              if "registers" in ln or "spill" in ln]
    frames = {name: stack_frames(_build.build_log(name)) for name in secs}
    p2 = {k: v for k, v in frames["window_hist"].items()
          if "window_hist_kernel" in k}
    check(len(p2) >= 2 and not any(p2.values()),
          f"window_hist: every instantiation needs a 0-byte stack frame; "
          f"ptxas reports {p2}")
    smi = nvidia_smi_line()
    emit({"phase": "build", "seconds": wall, "per_source": secs,
          "ptxas": report, "stack_frames": frames, "nvidia_smi": smi})
    return smi


def compare_kernels(cf, X, sizes, label, errs):
    """Both wrappers of ``cf``'s variant against their plain versions at
    each size, bit-equal (``torch.equal``; a bf16 table against the plain
    walk on its dequantized values: both fold the same f32 values in one
    Kahan order); each wrapper launch must add exactly one to its
    variant's counter.  The plain versions run once on the largest batch
    and are sliced to each size: a row's result depends on that row
    alone."""
    from lightgbm_tpu_torch.ops import forest_walk as fw
    tables = cf.walk_tables
    bnd, cats, is_cat = cf.cut_tables()
    nb, nr = tables.variant(raw=False), tables.variant(raw=True)
    out = {"variants": [nb, nr], "bin_dtype": cf.info()["bin_dtype"]}
    top = X[:max(sizes)]
    want_all = fw.forest_walk_plain(
        tables, cf.device_bins(top),
        cf.device_covariates(top) if tables.linear else None)
    want_raw_all = fw.forest_walk_raw_plain(tables, bnd, cats, is_cat,
                                            cf.device_rows(top))
    for B in sizes:
        bins = cf.device_bins(X[:B])
        rows = cf.device_rows(X[:B])
        xt = cf.device_covariates(X[:B]) if tables.linear else None
        before = fw.launch_counts()
        got = fw.forest_walk(tables, bins, xt)
        got_raw = fw.forest_walk_raw(tables, bnd, cats, is_cat, rows)
        torch.cuda.synchronize()
        after = fw.launch_counts()
        check(after[nb] == before[nb] + 1 and after[nr] == before[nr] + 1
              and sum(after.values()) == sum(before.values()) + 2,
              f"{label} B={B}: launch counters {before} -> {after}")
        want, want_raw = want_all[:, :B], want_raw_all[:, :B]
        d = float((got - want).abs().max())
        d_raw = float((got_raw - want_raw).abs().max())
        bit_equal = bool(torch.equal(got, want)
                         and torch.equal(got_raw, want_raw))
        check(bool(torch.isfinite(got).all() and torch.isfinite(got_raw)
                   .all()), f"{label} B={B}: non-finite kernel output")
        check(d <= TOL and d_raw <= TOL,
              f"{label} B={B}: kernel vs plain max_abs_diff binned={d} "
              f"raw={d_raw} (tolerance {TOL})")
        check(bit_equal, f"{label} B={B}: the walk is not bit-equal to its "
                         f"plain version")
        errs[nb] = max(errs[nb], d)
        errs[nr] = max(errs[nr], d_raw)
        out[str(B)] = {"binned": d, "raw": d_raw, "bit_equal": bit_equal}
    return out


def chain_tree(rng, grid, num_leaves: int):
    """A leaf-wise chain on feature 0: node i sends values up to cut i to
    leaf i and the rest on, so a row above cut num_leaves - 2 walks
    num_leaves - 1 levels (254 at 255 leaves)."""
    from lightgbm_tpu_torch.models.tree import Tree
    t = Tree(num_leaves)
    for i in range(num_leaves - 1):
        t.threshold[i] = grid[0, i]
        t.left_child[i] = ~i
        t.right_child[i] = i + 1 if i + 2 < num_leaves else ~(i + 1)
        t.leaf_parent[i] = i
    t.leaf_parent[num_leaves - 1] = num_leaves - 2
    t.leaf_value[:] = rng.normal(0.0, 0.01, num_leaves)
    return t


def walk_edge_forests(seed):
    """(label, GBDT, grid, rows) of the walk's edge cases, 28 features and
    255 leaves as the Higgs forest: one tree; 37 trees (not a multiple of
    the plan's chunk at B = 4096); a chain tree 254 levels deep before 3
    random trees, with an eighth of the rows above every cut of feature
    0.  Rows: 4096, 5% NaN."""
    rng = np.random.RandomState(seed + 85)
    one, g1 = random_model(seed + 80, 28, 1, 255, 255)
    odd, g2 = random_model(seed + 81, 28, 37, 255, 255)
    chain, g3 = random_model(seed + 82, 28, 3, 255, 255)
    chain.models.insert(0, chain_tree(rng, g3, 255))
    out = []
    for label, g, grid in (("one_tree", one, g1), ("trees_37", odd, g2),
                           ("chain_254", chain, g3)):
        X = random_rows(rng, 4096, grid, nan_frac=0.05, tie_frac=0.05)
        if label == "chain_254":
            X[::8, 0] = 10.0
        out.append((label, g, grid, X))
    return out


def compare_walk_edges(seed, dev, errs):
    """All eight walk variants bit-equal to their plain versions on
    ``walk_edge_forests``, each frozen four ways (f32 and bf16 leaves,
    constant and linear), at B = 1, one tile - 1, one tile + 1 (the
    plan's widest tile) and 4096 rows; and the 37-tree forest again with
    the scratch capped at 1000 rows, so that 4096 rows take eight waves of
    512 (a forest of many trees or classes takes waves at its own
    size)."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import forest_walk as fw
    tile = fw.WALK_TILES[0]
    sizes = (1, tile - 1, tile + 1, 4096)
    out = {}
    for label, g, grid, X in walk_edge_forests(seed):
        lin = make_linear(scaled(g, 1.0), seed + 86)
        for kind, model, quantize in (
                ("f32", g, False), ("bf16", scaled(g, TINY_LEAVES), True),
                ("linear", lin, False),
                ("linear_bf16", scaled(lin, TINY_LEAVES), True)):
            cf = lt.CompiledForest.from_booster(model, device=dev,
                                                quantize_leaves=quantize)
            t = cf.walk_tables
            check(t.linear == kind.startswith("linear")
                  and (t.leaves.dtype == torch.bfloat16) == quantize,
                  f"{label}/{kind}: froze as {cf.info()}")
            plans = {B: fw.walk_plan(t, X.shape[1], B, raw=False)
                     for B in sizes}
            if label == "trees_37":
                check(37 % plans[4096].chunk != 0,
                      f"{label}/{kind}: 37 trees are whole chunks of "
                      f"{plans[4096].chunk}")
            if label == "chain_254" and kind == "f32":
                leaf = fw.walk_plain(t, cf.device_bins(X))[1][0, 0]
                check(int(leaf_depths(t)[0, 0].max()) == 254
                      and bool((leaf == 254).any()),
                      f"{label}/{kind}: no row walks 254 levels")
            res = compare_kernels(cf, X, sizes, f"{label}/{kind}", errs)
            res["plans"] = {str(B): p._asdict() for B, p in plans.items()}
            out[f"{label}/{kind}"] = res
            if label == "trees_37":
                out[f"{label}/waves/{kind}"] = compare_waves(cf, X, errs)
    return out


def compare_waves(cf, X, errs):
    """``compare_kernels`` at 1 and 4096 rows with the walk's scratch
    capped at 1000 rows a wave (``WALK_SCRATCH_BYTES``)."""
    from lightgbm_tpu_torch.ops import forest_walk as fw
    t = cf.walk_tables
    saved = fw.WALK_SCRATCH_BYTES
    fw.WALK_SCRATCH_BYTES = 4 * t.num_class * t.trees_per_class * 1000
    fw.plan_walk.cache_clear()
    try:
        p = fw.walk_plan(t, X.shape[1], 4096, raw=False)
        check(p.wave < 4096, f"waves: one wave of {p.wave} rows")
        res = compare_kernels(cf, X, (1, 4096), "waves", errs)
        res["plan"] = p._asdict()
    finally:
        fw.WALK_SCRATCH_BYTES = saved
        fw.plan_walk.cache_clear()
    return res


def linear_forests(seed, higgs_model, higgs_grid):
    """The linear Higgs forest, its grid, and the kernels phase's linear
    and bf16 forests as (label, GBDT, grid, quantize, categorical
    features, categories)."""
    lin, grid = random_model(seed + 5, cat_features=LINEAR_CAT, num_cats=8,
                             **HIGGS)
    make_linear(lin, seed + 6)
    lin8, grid8 = random_model(seed + 7, cat_features=LINEAR_CAT,
                               num_cats=8, **{**HIGGS, "num_cuts": 250})
    make_linear(lin8, seed + 8)
    mc, gmc = random_model(seed + 2, 6, 7, 15, 30, num_class=3,
                           ragged_tail=2, cat_features=(1,), num_cats=6)
    make_linear(mc, seed + 9)
    return lin, grid, [
        ("higgs_linear_u16", lin, grid, False, LINEAR_CAT, 8),
        ("higgs_linear_u8", lin8, grid8, False, LINEAR_CAT, 8),
        ("multiclass_ragged_linear", mc, gmc, False, (1,), 6),
        ("higgs_bf16", scaled(higgs_model, TINY_LEAVES), higgs_grid, True,
         (), 0),
        ("higgs_linear_bf16", scaled(lin, TINY_LEAVES), grid, True,
         LINEAR_CAT, 8)]


def phase_kernels(seed, dev, higgs_model, higgs_grid, linear_set, errs):
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import children_hist as ch
    from lightgbm_tpu_torch.ops import forest_walk as fw
    from lightgbm_tpu_torch.ops import leafhist as lh
    from lightgbm_tpu_torch.ops import roll_chain as rc
    from lightgbm_tpu_torch.ops import window_hist as wh
    results = {}
    cat = (0, 1, 2)
    g, grid = random_model(seed + 1, 8, 20, 31, 40, cat_features=cat,
                           num_cats=6, collide=True)
    cf = lt.CompiledForest.from_booster(g, device=dev)
    X = random_rows(np.random.RandomState(seed + 11), 4096, grid, cat, 6,
                    nan_frac=0.1, tie_frac=0.1)
    results["binary_cat_nan"] = compare_kernels(
        cf, X, (1, 33, 129, 700, 4096), "binary_cat_nan", errs)
    g, grid = random_model(seed + 2, 6, 7, 15, 30, num_class=3,
                           ragged_tail=2)
    cf = lt.CompiledForest.from_booster(g, device=dev)
    check(cf.trees_per_class * 3 > g.num_trees(),
          "multiclass forest is not ragged")
    X = random_rows(np.random.RandomState(seed + 12), 4096, grid,
                    nan_frac=0.05, tie_frac=0.05)
    results["multiclass_ragged"] = compare_kernels(
        cf, X, (1, 33, 129, 700, 4096), "multiclass_ragged", errs)
    cf = lt.CompiledForest.from_booster(higgs_model, device=dev)
    check(cf.info()["bin_dtype"] == "uint16", "Higgs bins are not uint16")
    X = random_rows(np.random.RandomState(seed + 13), 4096, higgs_grid,
                    tie_frac=0.02)
    results["higgs"] = compare_kernels(cf, X, (16, 64, 4096), "higgs", errs)
    for i, (label, g, grid, quantize, cat, ncat) in enumerate(linear_set):
        cf = lt.CompiledForest.from_booster(g, device=dev,
                                            quantize_leaves=quantize)
        info = cf.info()
        check(info["linear"] == ("linear" in label)
              and info["leaf_dtype"] == ("bfloat16" if quantize
                                         else "float32"),
              f"{label}: froze as {info}")
        if label.endswith(("_u8", "_u16")):
            check(info["bin_dtype"] == "uint" + label.rsplit("_u", 1)[1],
                  f"{label}: bins are {info['bin_dtype']}")
        X = random_rows(np.random.RandomState(seed + 60 + i), 4096, grid,
                        cat, ncat, nan_frac=0.05, tie_frac=0.02)
        results[label] = compare_kernels(cf, X, (1, 64, 4096), label, errs)
    results["walk_edges"] = compare_walk_edges(seed, dev, errs)
    results["digit_histogram"] = compare_leaf_hist(seed, dev, errs)
    results["children_hist"] = compare_children_hist(seed, dev, errs)
    results["probes"] = compare_probes(seed, dev, errs)
    emit({"phase": "kernels", "max_abs_diff": results,
          "launches": {**fw.launch_counts(), **lh.launch_counts(),
                       **ch.launch_counts(), **rc.launch_counts(),
                       **wh.launch_counts()}})


def compare_leaf_hist(seed, dev, errs):
    """K1 against its plain version: bit-equal at every dtype, width (F
    in HIST_FEATURES and RANK_FEATURES) and window size, on the
    wrapper's own choice of path and on each path forced; then at every
    window class the train phase counts (2^10 to 2^20 rows, uint8, 28
    features, 255 bins) on both paths.  One launch per call."""
    from lightgbm_tpu_torch.ops import leafhist as lh
    rng = np.random.RandomState(seed + 14)
    out = {}

    def held(bins, dig, max_bin, start, S, label, **kw):
        before = lh.launch_counts()["digit_histogram"]
        got = lh.digit_histogram(bins, dig, max_bin, start, S, **kw)
        torch.cuda.synchronize()
        after = lh.launch_counts()["digit_histogram"]
        check(after == before + (1 if bins.shape[1] else 0),
              f"K1 {label}: launch counter {before} -> {after}")
        want = lh.digit_histogram_plain(bins, dig, max_bin, start, S)
        check(torch.equal(got, want),
              f"K1 {label}: not bit-equal to the plain version")
        d = float((got - want).abs().max()) if got.numel() else 0.0
        errs["digit_histogram"] = max(errs["digit_histogram"], d)
        out[label] = d

    # the K2/K3 widths, and the objectives phase's LambdaRank width (the
    # LambdaRank example's 30 features are among them)
    for dtype, max_bin in ((np.uint8, 255), (np.uint16, 1000)):
        for F in HIST_FEATURES + (RANK_FEATURES,):
            bins, dig = hist_inputs(rng, max(HIST_SIZES) + 3, F, max_bin,
                                    dtype, dev)
            for S in HIST_SIZES:
                start = 3 if S < max(HIST_SIZES) else 0
                for path in K1_PATHS:
                    held(bins, dig, max_bin, start, S,
                         f"{dtype.__name__}/F{F}/S{S}/{path or 'auto'}",
                         path=path)
            del bins, dig
    F, B = 28, 255
    bins, dig = hist_inputs(rng, TRAIN_ROWS + 5, F, B, np.uint8, dev)
    for cls in WINDOW_CLASSES:
        S = min(cls, TRAIN_ROWS)
        for path in ("small", "large"):
            held(bins, dig, B, 5, S, f"class{cls}/{path}", path=path)
    return out


def children_inputs(rng, rows: int, F: int, max_bin: int, dtype, dev):
    """Feature-major bins [F, rows], f32 g/h/w and int32 leaf ids in
    {0, 1, 2} (a third each: 1 is the split leaf, 2 the right leaf, 0
    elsewhere), on ``dev``."""
    bins = torch.from_numpy(rng.randint(0, max_bin, size=(F, rows))
                            .astype(dtype)).to(dev)
    g = torch.from_numpy(rng.normal(size=rows).astype(np.float32)).to(dev)
    h = torch.from_numpy(rng.uniform(0.01, 0.25, size=rows)
                         .astype(np.float32)).to(dev)
    w = torch.ones(rows, dtype=torch.float32, device=dev)
    leaf = torch.from_numpy(rng.randint(0, 3, size=rows)
                            .astype(np.int32)).to(dev)
    return bins, g, h, w, leaf


def occupancy_leaves(seed, N: int, occ: int, dev):
    """[N] int32 leaf ids with min(occ, N) rows in the two children (half
    in the split leaf 1, half in the right leaf 2) at rows drawn from the
    seed, and the rest in leaf 3."""
    occ = min(occ, N)
    perm = np.random.RandomState(seed + 16).permutation(N)
    leaf = np.full(N, 3, dtype=np.int32)
    leaf[perm[:occ // 2]] = 1
    leaf[perm[occ // 2:occ]] = 2
    return torch.from_numpy(leaf).to(dev)


def child_totals(g, h, w, leaf):
    """[2, 3] (g, h, w sums) of the children leaf 1 and leaf 2."""
    return torch.stack([torch.stack([(g * m).sum(), (h * m).sum(),
                                     (w * m).sum()])
                        for m in (leaf == 1, leaf == 2)])


def abs_hist(bins, g, h, w, leaf, parent, right, max_bin):
    """The sums of |g|, |h|, |w| of every histogram entry: the scale of
    its f32 rounding error in any summation order."""
    from lightgbm_tpu_torch.ops import children_hist as ch
    return ch.build_children_histograms(bins, g.abs(), h.abs(), w.abs(),
                                        leaf, parent, right, max_bin)


def check_hist(got, want, scale, label):
    """K2 against its plain version: within HIST_RTOL of each entry's sum
    of absolute values plus HIST_ATOL.  Returns the max absolute
    difference."""
    from lightgbm_tpu_torch.ops import children_hist as ch
    if not got.numel():
        return 0.0
    d = (got - want).abs()
    bad = d > ch.HIST_RTOL * scale + ch.HIST_ATOL
    check(not bool(bad.any()), f"{label}: {int(bad.sum())} entries beyond "
          f"the tolerance, max abs diff {float(d.max())}")
    return float(d.max())


def check_candidates(got, want, scale, totals, is_cat, label, ties):
    """K3's [2, F, 8] against its plain version: the same finite set;
    each gain within ``gain_tolerance`` of the plain version's (the
    left-sum tolerance carried through the gain; ``scale`` [2, F, B, 3]
    from ``abs_hist``, ``totals`` [2, 3]); thresholds equal except at
    near-ties, where the two gains differ by less than the sum of both
    candidates' tolerances (appended to ``ties``); and where the
    thresholds agree, the left sums within HIST_RTOL of their sums of
    absolute values plus HIST_ATOL.  Returns (max gain difference, max
    of difference over tolerance)."""
    from lightgbm_tpu_torch.ops import children_hist as ch
    g, w = got.cpu().double(), want.cpu().double()
    tot = totals.cpu().double()
    # prefix sums for numerical features, the bin itself for categorical
    scale = torch.where(is_cat.cpu()[None, :, None, None], scale.cpu(),
                        scale.cpu().cumsum(dim=2)).double()
    fin = torch.isfinite(w[..., 0])
    check(torch.equal(torch.isfinite(g[..., 0]), fin),
          f"{label}: finite candidates differ")

    def tol(out, c, f):
        t = int(out[c, f, 1])
        return float(ch.gain_tolerance(out[c, f, 2], out[c, f, 3],
                                       tot[c, 0], tot[c, 1],
                                       scale[c, f, t, 0], scale[c, f, t, 1]))

    worst = ratio = 0.0
    for c, f in torch.nonzero(fin).tolist():
        dg = abs(float(g[c, f, 0] - w[c, f, 0]))
        t, same = int(w[c, f, 1]), int(g[c, f, 1]) == int(w[c, f, 1])
        bound = tol(w, c, f) + (0.0 if same else tol(g, c, f))
        worst, ratio = max(worst, dg), max(ratio, dg / bound)
        check(dg <= bound, f"{label} child {c} feature {f}: gain "
                           f"{float(g[c, f, 0])} vs plain {float(w[c, f, 0])} "
                           f"(tolerance {bound})")
        if not same:
            ties.append({"at": label, "child": c, "feature": f,
                         "threshold": [int(g[c, f, 1]), t],
                         "gain": [float(g[c, f, 0]), float(w[c, f, 0])]})
            continue
        for k in range(3):
            d = abs(float(g[c, f, 2 + k] - w[c, f, 2 + k]))
            check(d <= ch.HIST_RTOL * float(scale[c, f, t, k])
                  + ch.HIST_ATOL,
                  f"{label} child {c} feature {f}: left sum {k} "
                  f"{float(g[c, f, 2 + k])} vs plain {float(w[c, f, 2 + k])}")
    return worst, ratio


def compare_children_hist(seed, dev, errs):
    """K2 and K3 against their plain versions on the grid: uint8 with 255
    bins and uint16 with 1000, F in {5, 28, 30}, N in HIST_SIZES, a third
    of the rows in each child; plus the root forms at 1M rows, and the
    1M-row full pass with OCCUPANCIES rows in the children.  Each call adds
    exactly one to its counter."""
    from lightgbm_tpu_torch.ops import children_hist as ch
    from lightgbm_tpu_torch.ops.split import SplitParams
    rng = np.random.RandomState(seed + 15)
    sp = SplitParams(TRAIN_PARAMS["min_data_in_leaf"], 1e-3)
    out, ties = {}, []

    def counted(name, fn):
        before = ch.launch_counts()[name]
        res = fn()
        torch.cuda.synchronize()
        check(ch.launch_counts()[name] == before + 1,
              f"{name}: launch counter did not move by one")
        return res

    for dtype, max_bin in ((np.uint8, 255), (np.uint16, 1000)):
        for F in HIST_FEATURES:
            for N in HIST_SIZES:
                label = f"{dtype.__name__}/F{F}/N{N}"
                bins, g, h, w, leaf = children_inputs(rng, N, F, max_bin,
                                                      dtype, dev)
                got = counted("children_histograms",
                              lambda: ch.children_histograms(
                                  bins, g, h, w, leaf, 1, 2, max_bin))
                want = ch.build_children_histograms(bins, g, h, w, leaf, 1,
                                                    2, max_bin)
                scale = abs_hist(bins, g, h, w, leaf, 1, 2, max_bin)
                d2 = check_hist(got, want, scale, f"K2 {label}")
                totals = child_totals(g, h, w, leaf)
                nb = torch.full((F,), max_bin, dtype=torch.int32, device=dev)
                cat = torch.zeros(F, dtype=torch.bool, device=dev)
                cat[0] = True
                fm = torch.ones(F, dtype=torch.bool, device=dev)
                args = (bins, g, h, w, leaf, 1, 2, totals, nb, cat, fm,
                        max_bin, sp)
                got3 = counted("fused_split_candidates",
                               lambda: ch.fused_split_candidates(*args))
                d3, r3 = check_candidates(
                    got3, ch.fused_split_candidates_plain(*args), scale,
                    totals, cat, f"K3 {label}", ties)
                errs["children_histograms"] = max(
                    errs["children_histograms"], d2)
                errs["fused_split_candidates"] = max(
                    errs["fused_split_candidates"], d3)
                out[label] = {"k2": d2, "k3_gain": d3,
                              "k3_gain_over_tolerance": r3}
                del bins, g, h, w, leaf
    # the root forms: every row in the left child, no right child
    N, F, max_bin = max(HIST_SIZES), 28, 255
    bins, g, h, w, _ = children_inputs(rng, N, F, max_bin, np.uint8, dev)
    got = counted("children_histograms",
                  lambda: ch.root_histogram(bins, g, h, w, max_bin))
    leaf = torch.zeros(N, dtype=torch.int32, device=dev)
    scale = abs_hist(bins, g, h, w, leaf, 0, -2, max_bin)
    d2 = check_hist(got, ch.build_root_histogram(bins, g, h, w, max_bin),
                    scale[0], "K2 root")
    totals = torch.stack([torch.stack([g.sum(), h.sum(), w.sum()]),
                          torch.zeros(3, device=dev)])
    cat = torch.zeros(F, dtype=torch.bool, device=dev)
    args = (bins, g, h, w, leaf, 0, -2, totals,
            torch.full((F,), max_bin, dtype=torch.int32, device=dev), cat,
            torch.ones(F, dtype=torch.bool, device=dev), max_bin, sp)
    got3 = counted("fused_split_candidates",
                   lambda: ch.fused_split_candidates(*args))
    d3, r3 = check_candidates(got3[:1],
                              ch.fused_split_candidates_plain(*args)[:1],
                              scale[:1], totals[:1], cat, "K3 root", ties)
    check(not bool(torch.isfinite(got3[1, :, 0]).any()),
          "K3 root: the absent right child has a finite candidate")
    errs["children_histograms"] = max(errs["children_histograms"], d2)
    errs["fused_split_candidates"] = max(errs["fused_split_candidates"], d3)
    out["root"] = {"k2": d2, "k3_gain": d3, "k3_gain_over_tolerance": r3}
    # the fused grower's full pass at each leaf occupancy
    for occ in OCCUPANCIES:
        leaf = occupancy_leaves(seed, N, occ, dev)
        scale = abs_hist(bins, g, h, w, leaf, 1, 2, max_bin)
        got = counted("children_histograms",
                      lambda: ch.children_histograms(bins, g, h, w, leaf, 1,
                                                     2, max_bin))
        d2 = check_hist(got, ch.build_children_histograms(
            bins, g, h, w, leaf, 1, 2, max_bin), scale, f"K2 occ{occ}")
        totals = child_totals(g, h, w, leaf)
        args = (bins, g, h, w, leaf, 1, 2, totals,
                torch.full((F,), max_bin, dtype=torch.int32, device=dev),
                cat, torch.ones(F, dtype=torch.bool, device=dev), max_bin,
                sp)
        got3 = counted("fused_split_candidates",
                       lambda: ch.fused_split_candidates(*args))
        d3, r3 = check_candidates(
            got3, ch.fused_split_candidates_plain(*args), scale, totals, cat,
            f"K3 occ{occ}", ties)
        errs["children_histograms"] = max(errs["children_histograms"], d2)
        errs["fused_split_candidates"] = max(
            errs["fused_split_candidates"], d3)
        out[f"occupancy{occ}"] = {"k2": d2, "k3_gain": d3,
                                  "k3_gain_over_tolerance": r3}
    return {"max_abs_diff": out, "near_ties": ties,
            "tolerance": {"hist_rtol_of_abs_sums": ch.HIST_RTOL,
                          "hist_atol": ch.HIST_ATOL,
                          "gain": "children_hist.gain_tolerance"}}


def probe_windows(n: int):
    """P2's windows at ``n`` rows as (off, count): the probe's first, an
    empty one, one row, one ending at ``n``, one whose off is not a
    multiple of any probe nb, one clamped past ``n``."""
    return ((5, n // 2), (7, 0), (12345, 1), (n - 100_000, 100_000),
            (3001, 70_000), (n - 1000, 5000))


def roll_inputs(seed):
    """P1's inputs: the probe's seeded block, two more seeds, and keys
    made to break a key-and-source formulation: all equal, only INT_MIN
    and INT_MAX, already sorted ascending and descending."""
    from lightgbm_tpu_torch.ops import roll_chain as rc
    from lightgbm_tpu_torch.tools import probe_roll as pr

    def seeded(k):
        return np.random.RandomState(k).randint(
            -2**31, 2**31 - 1, (rc.WORDS, rc.NB), np.int64).astype(np.int32)
    out = {"probe_input": pr.make_input(),
           **{f"seed{seed + k}": seeded(seed + k) for k in (1, 2)}}
    base = seeded(seed + 3)
    keys = {"keys_equal": np.full(rc.NB, 7, np.int32),
            "keys_int_min_max": np.where(
                np.random.RandomState(seed + 4).rand(rc.NB) < 0.5,
                np.int32(-2**31), np.int32(2**31 - 1)).astype(np.int32),
            "keys_ascending": np.arange(rc.NB, dtype=np.int32) * 1000 - 10**6,
            "keys_descending": -np.arange(rc.NB, dtype=np.int32)}
    for label, k in keys.items():
        x = base.copy()
        x[0] = k
        out[label] = x
    return out


def device_activities(fn, tries: int = 10):
    """{name: count} of the device activities (kernels, memsets, copies)
    that ``torch.profiler`` records over one call of ``fn``, or None
    where it records none in ``tries`` attempts."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = getattr(e, "cuda_time_total", 0)
            if t and t > 0:
                out[e.key[:120]] = e.count
        if out:
            return out
        time.sleep(0.2)
    return None


def compare_probes(seed, dev, errs):
    """P1 bit-equal to its plain version on ``roll_inputs`` (the probe's
    input, two more seeds, adversarial keys), and after the probe's
    50-call chain.  P2 on the probe's inputs (2^20 rows) bit-equal to its
    plain version and to K1 on the same window, for both digit layouts,
    on ``probe_windows``; one call records its one kernel and no other
    device activity (no memset, no fill; a profile that records nothing
    fails); then the probe's 10-call chained loop
    (every run: the TPU's nb sets nothing on the card) under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host read in the
    wrapper raises), replayed through the plain version.  Each call adds
    exactly one to its counter."""
    from lightgbm_tpu_torch.ops import leafhist as lh
    from lightgbm_tpu_torch.ops import roll_chain as rc
    from lightgbm_tpu_torch.ops import window_hist as wh
    from lightgbm_tpu_torch.tools import probe_dynhist as pd
    from lightgbm_tpu_torch.tools import probe_roll as pr
    out = {"roll_chain": {}, "window_digit_histogram": {}}
    for label, x in roll_inputs(seed).items():
        xt = torch.from_numpy(x).to(dev)
        before = rc.launch_counts()["roll_chain"]
        got = rc.roll_chain(xt)
        torch.cuda.synchronize()
        check(rc.launch_counts()["roll_chain"] == before + 1,
              f"P1 {label}: launch counter did not move by one")
        check(torch.equal(got, rc.roll_chain_plain(xt)),
              f"P1 {label}: not bit-equal to the plain version")
        out["roll_chain"][label] = 0.0
    xt = torch.from_numpy(pr.make_input()).to(dev)
    want = xt
    for _ in range(pr.CHAIN):
        want = rc.roll_chain_plain(want) ^ 1
    check(torch.equal(pr.chain(xt), want),
          "P1: the 50-call chain is not bit-equal to the plain chain")
    out["roll_chain"]["chain50"] = 0.0

    bins, digits = pd.make_inputs(pd.N)
    bins[pd.N - 1, 5] = bins[6000, 0] = pd.B - 1      # bin 255 lands too
    n = bins.shape[0]
    bw, dw, dmat = pd.device_inputs(bins, digits, dev)
    tb = torch.from_numpy(bins).to(dev)
    for off, count in probe_windows(n):
        win = torch.tensor([off, count], dtype=torch.int32, device=dev)
        lo, hi = wh.clamp_window(off, count, n)
        k1 = lh.digit_histogram(tb, dmat, pd.B, lo, hi - lo)
        for layout, dig in (("words", dw), ("matrix", dmat)):
            want = wh.window_digit_histogram_plain(bw, dig, win, pd.F, pd.B)
            check(torch.equal(want, k1), f"P2 plain {layout} ({off}, "
                                         f"{count}): not equal to K1")
            before = wh.launch_counts()["window_digit_histogram"]
            got = wh.window_digit_histogram(bw, dig, win, pd.F, pd.B)
            torch.cuda.synchronize()
            check(wh.launch_counts()["window_digit_histogram"]
                  == before + 1, "P2: launch counter did not move by one")
            check(torch.equal(got, want),
                  f"P2 {layout} window ({off}, {count}): not bit-equal to "
                  f"the plain version and K1")
            out["window_digit_histogram"][f"{layout}/{off}+{count}"] = 0.0
    win = torch.tensor([pd.FIRST_OFF, n // 2], dtype=torch.int32, device=dev)
    one_call = {}
    for layout, dig in (("words", dw), ("matrix", dmat)):
        acts = device_activities(lambda: wh.window_digit_histogram(
            bw, dig, win, pd.F, pd.B))
        check(acts is not None, f"P2 {layout}: the profiler recorded no "
                                f"device activity in a call")
        check(list(acts.values()) == [1]
              and all("window_hist_kernel" in k for k in acts),
              f"P2 {layout}: a call ran other than its one kernel: {acts}")
        one_call[layout] = acts
    out["one_call_device_activities"] = one_call
    count = torch.tensor(n // 2, dtype=torch.int32, device=dev)
    chained = {}
    for name, nb, matrix in pd.RUNS:
        dig = dmat if matrix else dw
        start = torch.tensor([pd.FIRST_OFF, n // 2], dtype=torch.int32,
                             device=dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            win, acc = pd.loop(bw, dig, start, count)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        pwin, pacc = start, 0
        for _ in range(pd.CALLS):
            o = wh.window_digit_histogram_plain(bw, dig, pwin, pd.F, pd.B)
            pwin = torch.stack([torch.remainder(o[0, 0, 0], 128), count])
            pacc += int(o[0, 0, 1])
        check(torch.equal(win, pwin) and int(acc) == pacc,
              f"P2 chained loop {name} nb={nb}: window {win.tolist()} acc "
              f"{int(acc)} against the plain replay's {pwin.tolist()} "
              f"{pacc}")
        chained[f"{name}/nb{nb}"] = {"last_window": win.tolist(),
                                     "acc": int(acc)}
    out["chained_under_sync_debug_error"] = chained
    return out


def phase_probes(reps):
    """The probes' own main path: ``python -m
    lightgbm_tpu_torch.tools.probe_roll`` and ``probe_dynhist`` as a user
    runs them (their ``main``), each with its launch counter set to 0
    just before and read just after; returns those counts."""
    from lightgbm_tpu_torch.ops import roll_chain as rc
    from lightgbm_tpu_torch.ops import window_hist as wh
    from lightgbm_tpu_torch.tools import probe_dynhist as pd
    from lightgbm_tpu_torch.tools import probe_roll as pr
    rc.reset_launch_counts()
    roll = pr.main(["--reps", str(reps)])
    torch.cuda.synchronize()
    launches = rc.launch_counts()
    wh.reset_launch_counts()
    dyn = pd.main([])
    torch.cuda.synchronize()
    launches.update(wh.launch_counts())
    check(all(v > 0 for v in launches.values()),
          f"a probe kernel was not launched on its path: {launches}")
    want_dyn = 2 * pd.CALLS * len(pd.RUNS)
    check(launches["window_digit_histogram"] == want_dyn,
          f"P2 launches {launches['window_digit_histogram']} != {want_dyn}")
    check(len({(r["last_off"], r["acc"]) for r in dyn["runs"]}) == 1,
          f"the probe's layouts disagree: {dyn['runs']}")
    emit({"phase": "probes", "launches": launches, "roll_chain": roll,
          "window_digit_histogram": dyn})
    return launches


def _post_rows(base: str, rows: np.ndarray):
    body = json.dumps({"rows": rows.tolist()}).encode()
    req = urllib.request.Request(base + "/predict", data=body,
                                 headers={"Content-Type":
                                          "application/json"})
    t0 = time.perf_counter()
    resp = json.loads(urllib.request.urlopen(req, timeout=120).read())
    return resp, (time.perf_counter() - t0) * 1e3


def phase_serve(seed, dev, higgs_model, higgs_grid, workdir, errs):
    """The main path; returns the launch counts it made."""
    from lightgbm_tpu_torch import Booster
    from lightgbm_tpu_torch.config import Config, parse_cli_args
    from lightgbm_tpu_torch.ops import forest_walk as fw
    from lightgbm_tpu_torch.serve.server import serve_from_config

    path = f"{workdir}/higgs_model.txt"
    with open(path, "w") as fh:
        fh.write(higgs_model.save_model_to_string())
    rng = np.random.RandomState(seed + 20)
    plans = [[random_rows(rng, n, higgs_grid, tie_frac=0.02)
              for n in SERVE_SIZES] for _ in range(SERVE_CLIENTS)]
    Xb = random_rows(rng, 2000, higgs_grid, tie_frac=0.02)

    fw.reset_launch_counts()
    t0 = time.perf_counter()
    cfg = Config(parse_cli_args([
        "task=serve", f"input_model={path}", "serve_port=0",
        "serve_max_batch=4096", "serve_max_delay_ms=2"]))
    srv = serve_from_config(cfg).start()
    startup_s = time.perf_counter() - t0
    try:
        host, port = srv.address
        base = f"http://{host}:{port}"
        got = [[None] * len(SERVE_SIZES) for _ in range(SERVE_CLIENTS)]
        lat = {n: [] for n in SERVE_SIZES}
        failures = []

        def client(c):
            try:
                for j, X in enumerate(plans[c]):
                    resp, ms = _post_rows(base, X)
                    check(resp["num_rows"] == len(X), "num_rows mismatch")
                    got[c][j] = np.asarray(resp["predictions"], np.float64)
                    lat[len(X)].append(ms)
            except BaseException as exc:       # re-raised below
                failures.append(repr(exc))

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        check(not failures, f"client failures: {failures}")
        solo = [_post_rows(base, plans[0][0])[1] for _ in range(SOLO)]
        stats = json.loads(urllib.request.urlopen(base + "/stats",
                                                  timeout=60).read())
        health = json.loads(urllib.request.urlopen(base + "/healthz",
                                                   timeout=60).read())
        booster = Booster(model_file=path)
        pred = booster.predict(Xb, raw_score=True)
        torch.cuda.synchronize()
        launches = {k: v for k, v in fw.launch_counts().items()
                    if k in ("forest_walk", "forest_walk_raw")}
        check(sum(fw.launch_counts().values()) == sum(launches.values()),
              "the constant f32 forest launched another walk variant")
    finally:
        srv.stop()
    check(not srv.batcher._worker.is_alive(), "batcher worker still alive")
    try:
        urllib.request.urlopen(base + "/healthz", timeout=2)
        closed = False
    except OSError:
        closed = True
    check(closed, "server still answers after stop()")

    # every response against the plain version on the card
    from lightgbm_tpu_torch.ops.forest_walk import forest_walk_raw_plain
    cf = srv.forest
    Xall = np.concatenate([X for p in plans for X in p], axis=0)
    raw = forest_walk_raw_plain(cf.walk_tables, *cf.cut_tables(),
                                cf.device_rows(Xall))
    want = cf.transform_scores(raw)[0].double().cpu().numpy()
    flat = np.concatenate([g for row in got for g in row])
    check(flat.shape == want.shape and np.isfinite(flat).all(),
          "responses have the wrong shape or non-finite values")
    d_serve = float(np.abs(flat - want).max())
    check(d_serve <= TOL, f"served predictions vs plain: {d_serve}")
    errs["forest_walk_raw"] = max(errs["forest_walk_raw"], d_serve)
    host = booster._booster.predict_raw(Xb)[0]
    d_host = float(np.abs(pred - host).max())
    check(d_host <= 1e-5, f"Booster.predict vs f64 host walk: {d_host}")
    check(stats["requests"] == SERVE_CLIENTS * len(SERVE_SIZES) + SOLO,
          f"/stats requests {stats['requests']}")
    check(1 <= stats["batches"] <= stats["requests"],
          f"/stats batches {stats['batches']} > requests")
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched on the main path: {launches}")
    emit({"phase": "serve", "model": {**HIGGS, "seed": seed},
          "startup_s": startup_s, "requests": stats["requests"],
          "batches": stats["batches"], "rows": stats["rows"],
          "launches": launches,
          "latency_ms_median": {str(n): float(np.median(v))
                                for n, v in lat.items()},
          "solo_latency_ms_median_1row": float(np.median(solo)),
          "max_abs_diff_vs_plain": d_serve,
          "booster_vs_host_f64": d_host,
          "healthz": {k: health[k] for k in ("num_trees", "max_cuts",
                                             "bin_dtype", "device")}})
    return launches


def phase_serve_linear(seed, dev, lin_model, lin_grid, higgs_model,
                       workdir, errs):
    """The linear Higgs forest over HTTP, then three freezes with
    ``serve_quantize_leaves=true``; returns the launch counts of the
    linear and bf16 variants, every one of which must have run."""
    from lightgbm_tpu_torch import Booster
    from lightgbm_tpu_torch.config import Config, parse_cli_args
    from lightgbm_tpu_torch.ops import forest_walk as fw
    from lightgbm_tpu_torch.serve.forest import CompiledForest
    from lightgbm_tpu_torch.serve.server import serve_from_config
    from lightgbm_tpu_torch.utils import log

    paths = {}
    for name, g in (("linear", lin_model),
                    ("linear_tiny", scaled(lin_model, TINY_LEAVES)),
                    ("tiny", scaled(higgs_model, TINY_LEAVES))):
        paths[name] = f"{workdir}/higgs_{name}.txt"
        with open(paths[name], "w") as fh:
            fh.write(g.save_model_to_string())
    rng = np.random.RandomState(seed + 70)

    def rows(n):
        return random_rows(rng, n, lin_grid, LINEAR_CAT, 8, nan_frac=0.02,
                           tie_frac=0.02)
    plans = [[rows(n) for n in SERVE_SIZES] for _ in range(SERVE_CLIENTS)]
    Xb = rows(2000)

    def serve_config(path, *extra):
        return Config(parse_cli_args([
            "task=serve", f"input_model={path}", "serve_port=0",
            "serve_max_batch=4096", "serve_max_delay_ms=2",
            "serve_nonfinite_policy=propagate", *extra]))

    fw.reset_launch_counts()
    t0 = time.perf_counter()
    srv = serve_from_config(serve_config(paths["linear"])).start()
    startup_s = time.perf_counter() - t0
    try:
        host, port = srv.address
        base = f"http://{host}:{port}"
        got = [[None] * len(SERVE_SIZES) for _ in range(SERVE_CLIENTS)]
        lat = {n: [] for n in SERVE_SIZES}
        failures = []

        def client(c):
            try:
                for j, X in enumerate(plans[c]):
                    resp, ms = _post_rows(base, X)
                    check(resp["num_rows"] == len(X), "num_rows mismatch")
                    got[c][j] = np.asarray(resp["predictions"], np.float64)
                    lat[len(X)].append(ms)
            except BaseException as exc:       # re-raised below
                failures.append(repr(exc))

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        check(not failures, f"client failures: {failures}")
        health = json.loads(urllib.request.urlopen(base + "/healthz",
                                                   timeout=60).read())
        booster = Booster(model_file=paths["linear"])
        pred = booster.predict(Xb, raw_score=True)
        torch.cuda.synchronize()
    finally:
        srv.stop()
    cf = srv.forest
    Xall = np.concatenate([X for p in plans for X in p], axis=0)
    want = cf.transform_scores(fw.forest_walk_raw_plain(
        cf.walk_tables, *cf.cut_tables(), cf.device_rows(Xall)))[0]
    flat = np.concatenate([g for row in got for g in row])
    check(flat.shape == (Xall.shape[0],) and np.isfinite(flat).all(),
          "linear responses have the wrong shape or non-finite values")
    d_serve = float(np.abs(flat - want.double().cpu().numpy()).max())
    check(d_serve <= TOL, f"served linear predictions vs plain: {d_serve}")
    errs["forest_walk_raw_linear"] = max(errs["forest_walk_raw_linear"],
                                         d_serve)
    d_host = float(np.abs(pred - booster._booster.predict_raw(Xb)[0]).max())
    check(d_host <= 1e-5, f"linear Booster.predict vs f64 host walk: "
                          f"{d_host}")
    check(health["linear"] is True and health["linear_k"] == LINEAR_K
          and health["leaf_dtype"] == "float32",
          f"/healthz of the linear forest: {health}")

    # serve_quantize_leaves=true: two forests the pin accepts, one it
    # refuses (the real Higgs leaves: their summed bf16 error)
    frozen = {}
    atol = CompiledForest.QUANTIZE_LEAF_ATOL + 1e-5
    for name in ("tiny", "linear_tiny", "linear"):
        b32 = Booster(model_file=paths[name])
        f32 = CompiledForest.from_booster(b32, quantize_leaves=False)
        fell = log.counter("forest_quantize_fallback")
        qsrv = serve_from_config(serve_config(paths[name],
                                              "serve_quantize_leaves=true"))
        fell = log.counter("forest_quantize_fallback") - fell
        qf = qsrv.forest
        dtype = qf.info()["leaf_dtype"]
        check(dtype == ("float32" if name == "linear" else "bfloat16")
              and fell == (name == "linear"),
              f"quantize {name}: leaf_dtype {dtype}, fallbacks {fell}")
        # host f64 binning against the f64 host walk; the f32 binning of
        # the serving path against the f32 table's, which bins the same
        host = b32._booster.predict_raw(Xb)[0]
        d_bin = float(np.abs(qf.predict(Xb, raw_score=True) - host).max())
        d_dev = float(np.abs(
            qf.predict(Xb, raw_score=True, device_binning=True)
            - f32.predict(Xb, raw_score=True, device_binning=True)).max())
        check(max(d_bin, d_dev) <= atol,
              f"quantize {name}: {d_bin} from the f64 host walk, {d_dev} "
              f"from the f32 table")
        frozen[name] = {"leaf_dtype": dtype, "fallbacks": fell,
                        "binned_vs_host_f64": d_bin,
                        "raw_vs_f32_table": d_dev}
    torch.cuda.synchronize()
    launches = {k: v for k, v in fw.launch_counts().items()
                if k not in ("forest_walk", "forest_walk_raw")}
    check(all(v > 0 for v in launches.values()),
          f"a linear or bf16 walk was not launched on the main path: "
          f"{launches}")
    emit({"phase": "serve_linear", "startup_s": startup_s,
          "launches": launches,
          "latency_ms_median": {str(n): float(np.median(v))
                                for n, v in lat.items()},
          "max_abs_diff_vs_plain": d_serve,
          "booster_vs_host_f64": d_host, "quantize": frozen,
          "healthz": {k: health[k] for k in ("linear", "linear_k",
                                             "leaf_dtype", "bin_dtype",
                                             "num_features")}})
    return launches


class _timed_updates:
    """Record the synchronized wall time of every ``Booster.update`` call
    made inside the block (one boosting round each)."""

    def __init__(self):
        self.seconds = []

    def __enter__(self):
        from lightgbm_tpu_torch.basic import Booster
        self._orig = orig = Booster.update
        rec = self.seconds

        def update(booster, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(booster, **kwargs)
            torch.cuda.synchronize()
            rec.append(time.perf_counter() - t0)
            return out
        Booster.update = update
        return self

    def __exit__(self, *exc):
        from lightgbm_tpu_torch.basic import Booster
        Booster.update = self._orig


def phase_train(seed, dev, workdir):
    """The training path at full width, once per grower of GROWERS on
    the same constructed datasets; returns the launches of each kernel
    summed over the runs that have it on their path."""
    import lightgbm_tpu_torch as lt
    t0 = time.perf_counter()
    X, y = make_higgs_like(TRAIN_ROWS, seed=seed + 40)
    Xv, yv = make_higgs_like(VALID_ROWS, seed=seed + 41)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # raw values kept for the linear run (the constant runs ignore them)
    train_set = lt.Dataset(X, y, params={**TRAIN_PARAMS,
                                         "linear_tree": True}).construct()
    valid_set = lt.Dataset(Xv, yv, reference=train_set).construct()
    binning_s = time.perf_counter() - t0
    emit({"phase": "train_data", "rows": TRAIN_ROWS,
          "valid_rows": VALID_ROWS, "features": X.shape[1], "seed": seed,
          "generate_s": gen_s, "binning_s": binning_s})
    launches, windows = {}, {}
    ordered = None
    for name, extra, kernel in GROWERS:
        run = train_run(name, extra, kernel, train_set, valid_set, X,
                        workdir, ordered)
        if ordered is None:
            ordered = run
        launches[kernel] = launches.get(kernel, 0) + run["launches"][kernel]
        for cls, n in run["windows"].get(kernel, {}).items():
            per = windows.setdefault(kernel, {})
            per[cls] = per.get(cls, 0) + n
    windows = {k: dict(sorted(v.items(), key=lambda kv: int(kv[0])))
               for k, v in windows.items()}
    emit({"phase": "train_windows", "runs": [g[0] for g in GROWERS],
          "launches_by_window_rows": windows})
    return launches, windows


class _plain_kernels:
    """Inside the block every kernel wrapper of the training path runs
    its plain PyTorch version instead (on the card, uncounted)."""

    def __enter__(self):
        from lightgbm_tpu_torch.ops import children_hist as ch
        from lightgbm_tpu_torch.ops import leafhist as lh
        self._saved = (lh.digit_histogram, ch.children_histograms,
                       ch.root_histogram, ch.fused_split_candidates)
        lh.digit_histogram = lh.digit_histogram_plain
        ch.children_histograms = ch.build_children_histograms
        ch.root_histogram = ch.build_root_histogram
        ch.fused_split_candidates = ch.fused_split_candidates_plain
        return self

    def __exit__(self, *exc):
        from lightgbm_tpu_torch.ops import children_hist as ch
        from lightgbm_tpu_torch.ops import leafhist as lh
        (lh.digit_histogram, ch.children_histograms, ch.root_histogram,
         ch.fused_split_candidates) = self._saved


def compare_regrown(a, b, label, exact):
    """Tree ``a`` (kernel run) against ``b`` (re-grown through the plain
    versions).  ``exact``: bit-identical.  Otherwise the structure must be
    equal up to the first near-tie flip, a node where the two runs chose
    different splits whose gains differ by less than TREE_TIE_RTOL of the
    larger (reported, and nothing after it compared); the values of an
    equal tree within 1e-3 of each field's largest magnitude.  Returns
    (flip or None, max value diff over the field's largest magnitude)."""
    from lightgbm_tpu_torch.ops.grow import pack_tree_arrays
    if exact:
        pa, pb = pack_tree_arrays(a), pack_tree_arrays(b)
        check(torch.equal(pa[0], pb[0]) and torch.equal(pa[1], pb[1]),
              f"{label}: re-grown through the plain versions, not "
              f"bit-identical")
        return None, 0.0
    na = [(int(a.split_feature[k]), int(a.split_bin[k]),
           int(a.left_child[k]), int(a.right_child[k]))
          for k in range(len(a.split_feature))]
    nb = [(int(b.split_feature[k]), int(b.split_bin[k]),
           int(b.left_child[k]), int(b.right_child[k]))
          for k in range(len(b.split_feature))]
    for k, (x, z) in enumerate(zip(na, nb)):
        if x[:2] != z[:2]:
            ga, gb = float(a.split_gain[k]), float(b.split_gain[k])
            flip = {"node": k, "kernel": {"feature": x[0], "bin": x[1],
                                          "gain": ga},
                    "plain": {"feature": z[0], "bin": z[1], "gain": gb}}
            check(abs(ga - gb) <= TREE_TIE_RTOL * max(abs(ga), abs(gb)),
                  f"{label}: split {k} differs beyond a near-tie: {flip}")
            return flip, 0.0
    check(na == nb and int(a.num_leaves) == int(b.num_leaves)
          and torch.equal(a.leaf_count, b.leaf_count)
          and torch.equal(a.internal_count, b.internal_count),
          f"{label}: re-grown tree structure differs")
    # f32 sums in another order: a value whose sums cancel to near zero
    # keeps a small absolute error that is large beside itself, so each
    # field is held against its largest magnitude in the tree
    worst = 0.0
    for field in ("leaf_value", "internal_value", "split_gain"):
        x = getattr(a, field).double()
        z = getattr(b, field).double()
        top = float(z.abs().max())
        if top > 0:
            worst = max(worst, float((x - z).abs().max()) / top)
    check(worst <= 1e-3, f"{label}: re-grown values differ by {worst} of "
                         f"their largest magnitude")
    return None, worst


class _window_classes:
    """Inside the block, count every histogram kernel call (K1, K2, K3)
    by the power-of-two class of the rows it scans (``2^k`` counts
    windows of ``2^(k-1) + 1`` to ``2^k`` rows): K1 its window, K2 and
    K3 every row of the full pass (``root_histogram``, K2's root form,
    counts as K2).  A printed count only."""

    WRAPPED = (("leafhist", "digit_histogram", "digit_histogram"),
               ("children_hist", "children_histograms",
                "children_histograms"),
               ("children_hist", "root_histogram", "children_histograms"),
               ("children_hist", "fused_split_candidates",
                "fused_split_candidates"))

    def __init__(self):
        self.counts = {}

    def __enter__(self):
        from lightgbm_tpu_torch.ops import children_hist as ch
        from lightgbm_tpu_torch.ops import leafhist as lh
        mods = {"leafhist": lh, "children_hist": ch}
        self._saved = [(mods[m], attr, getattr(mods[m], attr))
                       for m, attr, _ in self.WRAPPED]
        for (mod, attr, fn), (_, _, name) in zip(self._saved, self.WRAPPED):
            setattr(mod, attr, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def counted(*args, **kwargs):
            if name == "digit_histogram":
                start = args[3] if len(args) > 3 else kwargs.get("start", 0)
                count = args[4] if len(args) > 4 else kwargs.get("count")
                rows = args[0].shape[0] - start if count is None \
                    else int(count)
            else:
                rows = args[0].shape[1]
            cls = str(1 << (rows - 1).bit_length()) if rows > 0 else "0"
            per = self.counts.setdefault(name, {})
            per[cls] = per.get(cls, 0) + 1
            return fn(*args, **kwargs)
        return counted

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)


def train_run(name, extra, kernel, train_set, valid_set, X, workdir,
              ordered):
    """10 rounds of one grower.  Launch counts: the ordered grower runs
    K1 once per root and once per split, Σ over trees of the leaves
    grown; the fixed-trip ``grow_tree`` runs its kernel once for the root
    and once in each of its L - 1 steps, stop or not, so rounds × L (K3
    for fused, K2 for nocache, K1 for cached); no other histogram kernel
    runs.  Checks the re-grow of the first two trees through the plain
    versions, the saved model against
    the training score buffer, the AUC and, beside the ordered run, the
    cached trees and every constant grower's final valid AUC.  The
    ``linear`` run grows with the ordered grower and fits its leaves:
    its trees are re-grown from the run's own scores and re-fit
    (structure-equal: the fit's ``index_add_`` adds in no fixed order),
    and its saved model is also held against the f64 host walk with its
    affine part."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import children_hist as ch
    from lightgbm_tpu_torch.ops import grow as gr
    from lightgbm_tpu_torch.ops import leafhist as lh
    from lightgbm_tpu_torch.ops import ordered_grow as og
    params = {**TRAIN_PARAMS, **extra}
    L = params["num_leaves"]
    linear = name == "linear"
    kind = "ordered" if linear else name
    evals = {}
    lh.reset_launch_counts()
    ch.reset_launch_counts()
    og.reset_host_syncs()
    gr.reset_host_syncs()
    t0 = time.perf_counter()
    with _timed_updates() as rounds, _window_classes() as windows:
        booster = lt.train(params, train_set, TRAIN_ROUNDS,
                           valid_sets=[train_set, valid_set],
                           valid_names=["train", "valid"],
                           evals_result=evals, verbose_eval=False)
    torch.cuda.synchronize()
    launches = {**lh.launch_counts(), **ch.launch_counts()}
    check(all(sum(windows.counts.get(k, {}).values()) == v
              for k, v in launches.items()),
          f"{name}: launches by window class {windows.counts} do not add "
          f"up to {launches}")
    syncs = og.host_syncs() + gr.host_syncs()
    train_s = time.perf_counter() - t0

    gbdt = booster._booster
    check(gbdt.grow_kind == kind, f"{name}: the booster grew with "
                                  f"{gbdt.grow_kind}")
    check((gbdt._linear is not None) == linear,
          f"{name}: linear_tree setting not taken")
    grown = list(gbdt.tree_arrays)
    leaves = [int(ta.num_leaves) for ta in grown]
    check(booster.num_trees() == TRAIN_ROUNDS,
          f"{name}: {booster.num_trees()} trees after {TRAIN_ROUNDS} rounds")
    want = sum(leaves) if kind == "ordered" else TRAIN_ROUNDS * L
    check(launches[kernel] == want,
          f"{name}: {kernel} launches {launches[kernel]} != {want}")
    check(all(v == 0 for k, v in launches.items() if k != kernel),
          f"{name}: another histogram kernel ran: {launches}")

    # the first two trees again from the same gradients, through the
    # plain versions of every kernel (the first tree's gradients, +-0.5
    # and hessians 0.25, sum exactly in f32 in any order; the second's
    # do not)
    score = torch.zeros_like(gbdt.train_data.score)
    regrow = []
    for i in range(2):
        grad, hess = gbdt.objective.gradients_with(gbdt._grad_arrays, score)
        with _plain_kernels():
            ta, leaf_id, delta = gbdt._grow(grad[0], hess[0])
        if linear:
            ta = gbdt._fit_linear(ta, leaf_id, grad[0], hess[0])[0]
            # the next gradients from the run's own fitted tree (its delta
            # bit for bit), so the re-fit's atomic sums do not compound
            delta = gbdt._tree_delta(gbdt.train_data, grown[i],
                                     gbdt.tree_linear[i])
        score[0] += delta
        flip, rel = compare_regrown(grown[i], ta, f"{name} tree {i}",
                                    exact=name in ("ordered", "cached"))
        regrow.append({"tree": i, "near_tie_flip": flip,
                       "max_value_diff_of_field_max": rel})

    path = f"{workdir}/higgs_{name}.txt"
    booster.save_model(path)
    pred = lt.Booster(model_file=path).predict(X[:4096], raw_score=True)
    buf = gbdt.train_data.score[0, :4096].double().cpu().numpy()
    check(pred.shape == buf.shape and np.isfinite(pred).all(),
          f"{name}: saved-model predictions have the wrong shape or "
          f"non-finite values")
    d_pred = float(np.abs(pred - buf).max())
    check(d_pred <= 1e-5, f"{name}: saved model vs training score buffer: "
                          f"{d_pred}")
    beside = {}
    if linear:
        loaded = lt.Booster(model_file=path)
        d_host = float(np.abs(loaded._booster.predict_raw(X[:4096])[0]
                              - pred).max())
        check(d_host <= 1e-5, f"{name}: kernel vs f64 host walk: {d_host}")
        n_lin = sum(t.has_linear() for t in loaded._booster.models)
        check(n_lin == len(grown), f"{name}: {n_lin} linear trees saved")
        beside.update(kernel_vs_host_f64=d_host,
                      linear_fallbacks=gbdt.linear_fallbacks,
                      valid_auc_ordered=ordered["auc"]["valid"])

    auc = {k: v["auc"] for k, v in evals.items()}
    for key in ("train", "valid"):
        a = auc[key]
        check(len(a) == TRAIN_ROUNDS and all(np.isfinite(a))
              and min(a) > 0.5 and a[-1] > a[0],
              f"{name}: {key} AUC {a} is not finite, above 0.5 and rising")
    if ordered is not None and not linear:
        d_auc = abs(auc["valid"][-1] - ordered["auc"]["valid"][-1])
        check(d_auc <= 1e-3, f"{name}: valid AUC {auc['valid'][-1]} vs the "
                             f"ordered run's {ordered['auc']['valid'][-1]}")
        beside["valid_auc_diff_vs_ordered"] = d_auc
    if name == "cached":
        beside["max_rel_value_diff_vs_ordered"] = same_trees(
            grown, ordered["trees"])

    phases = profile_round(booster, name)
    out = {"phase": "train", "grower": name, "params": params,
           "rounds": TRAIN_ROUNDS, "train_s": train_s,
           "round_s": rounds.seconds,
           "round_s_median_3_10": float(np.median(rounds.seconds[2:])),
           "leaves_per_tree": leaves,
           "host_syncs_per_tree": syncs / len(grown),
           "launches": launches,
           "launches_by_window_rows": windows.counts, "regrown": regrow,
           "saved_model_vs_score_buffer": d_pred,
           "auc_train": auc["train"], "auc_valid": auc["valid"],
           **beside, "profile_round": phases}
    emit(out)
    return {"launches": launches, "auc": auc, "trees": grown,
            "windows": windows.counts}


def same_trees(trees, ref):
    """Every tree structure-equal to the reference run's, values within
    1e-6 relative (the JAX package's ordered-against-cached tolerance);
    returns the largest relative value difference."""
    exact = ("num_leaves", "split_feature", "split_bin", "left_child",
             "right_child", "internal_count", "leaf_count", "leaf_parent",
             "leaf_depth")
    worst = 0.0
    for i, (a, b) in enumerate(zip(trees, ref)):
        for field in exact:
            check(torch.equal(getattr(a, field), getattr(b, field)),
                  f"cached tree {i}: {field} differs from the ordered run's")
        for field in ("leaf_value", "internal_value", "split_gain"):
            x, z = getattr(a, field).double(), getattr(b, field).double()
            d = (x - z).abs()
            check(bool((d <= 1e-6 * z.abs() + 1e-7).all()),
                  f"cached tree {i}: {field} beyond 1e-6 of the ordered "
                  f"run's")
            worst = max(worst, float((d / z.abs().clamp(min=1e-12)).max()))
    return worst


def profile_round(booster, name):
    """One extra boosting round with CUDA events around every histogram
    kernel call (K1, K2 or K3), every split scan (``find_best_split``, or
    the across-feature ``combine_feature_candidates`` after K3) and, for
    the ordered grower, every partition: the summed event times of each,
    beside the round's synchronized wall time."""
    from lightgbm_tpu_torch.ops import children_hist as ch
    from lightgbm_tpu_torch.ops import grow as gr
    from lightgbm_tpu_torch.ops import leafhist as lh
    from lightgbm_tpu_torch.ops import ordered_grow as og
    spans = {}

    def wrap(fn, key):
        spans.setdefault(key, [])

        def timed(*args, **kwargs):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*args, **kwargs)
            e.record()
            spans[key].append((s, e))
            return out
        return timed

    targets = {"ordered": ((lh, "digit_histogram", "k1"),
                           (og, "_partition", "partition"),
                           (og, "find_best_split", "split_scan")),
               "cached": ((lh, "digit_histogram", "k1"),
                          (gr, "find_best_split", "split_scan")),
               "linear": ((lh, "digit_histogram", "k1"),
                          (og, "_partition", "partition"),
                          (og, "find_best_split", "split_scan"),
                          (booster._booster, "_fit_linear", "linear_fit")),
               "fused": ((ch, "fused_split_candidates", "k3"),
                         (gr, "combine_feature_candidates", "split_scan")),
               "nocache": ((ch, "children_histograms", "k2"),
                           (ch, "root_histogram", "k2"),
                           (gr, "find_best_split", "split_scan"))}[name]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]
    for mod, attr, key in targets:
        setattr(mod, attr, wrap(getattr(mod, attr), key))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        booster.update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    out = {"round_s": wall}
    rest = wall * 1e3
    for key, pairs in spans.items():
        ms = sum(s.elapsed_time(e) for s, e in pairs)
        rest -= ms
        out[key] = {"calls": len(pairs), "ms": ms,
                    "share": ms * 1e-3 / wall}
    out["rest"] = {"ms": rest, "share": rest * 1e-3 / wall}
    return out


# ---------------------------------------------------------------------------
# the repo's example confs through the CLI, card against CPU


@contextlib.contextmanager
def in_dir(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def run_main(main, argv) -> str:
    """``main(argv)`` (a CLI's entry point) with its log captured; it
    must exit 0.  Returns the log."""
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        check(main(argv) == 0, f"cli {argv}: exit code")
    return buf.getvalue()


def _cli(argv) -> str:
    from lightgbm_tpu_torch import cli
    return run_main(cli.main, argv)


def copy_example(name: str, folder: str, work: str) -> str:
    """The files of ``examples/<folder>`` copied into ``work``; returns
    the train conf to run, ``train.conf`` less EXAMPLE_DROPPED[name]."""
    shutil.copytree(os.path.join(REPO, "examples", folder), work,
                    dirs_exist_ok=True)
    if name not in EXAMPLE_DROPPED:
        return "train.conf"
    with open(f"{work}/train.conf") as fh:
        keep = [ln for ln in fh.read().splitlines()
                if ln.split("#", 1)[0].split("=", 1)[0].strip()
                not in EXAMPLE_DROPPED[name]]
    with open(f"{work}/train_port.conf", "w") as fh:
        fh.write("\n".join(keep) + "\n")
    return "train_port.conf"


_ROUND_LINE = re.compile(r"Iteration:(\d+), (\S+) (\S+) : (\S+)")


def round_metrics(log_text: str) -> dict:
    """{(round, data, metric): value} of the port's round lines."""
    return {(int(m.group(1)), m.group(2), m.group(3)): float(m.group(4))
            for m in _ROUND_LINE.finditer(log_text)}


def tree_sections(text: str):
    """[{field: value}] of every tree of a model text."""
    out, cur = [], None
    for ln in text.splitlines():
        if ln.startswith("Tree="):
            cur = {}
            out.append(cur)
        elif ln.startswith("feature importances"):
            cur = None
        elif cur is not None and "=" in ln:
            k, v = ln.split("=", 1)
            cur[k] = v
    return out


def _field(tree, name):
    return np.array(tree[name].split(), dtype=np.float64) \
        if tree.get(name) else np.zeros(0)


def compare_model_texts(a_text: str, b_text: str, label: str,
                        names=("card", "cpu"), tie_rtol=TREE_TIE_RTOL,
                        leaf_rtol=EXAMPLE_LEAF_RTOL):
    """Trees of model ``a`` against the reference ``b``: structure-equal
    (thresholds to 1e-9 relative), leaf values within ``leaf_rtol`` of
    the tree's largest, up to the first split where the two choices
    differ, which must be an f32 near-tie (gains within ``tie_rtol``,
    the nodes before it equal; reported under ``names``, and no later
    tree compared: every later score depends on it).  Returns (trees
    compared, the flip or None, the largest leaf-value difference over
    the tree's largest leaf)."""
    ta, tb = tree_sections(a_text), tree_sections(b_text)
    check(len(ta) == len(tb) > 0, f"{label}: {len(ta)} vs {len(tb)} trees")
    worst = 0.0
    for i, (a, b) in enumerate(zip(ta, tb)):
        fa, fb = _field(a, "split_feature"), _field(b, "split_feature")
        ha, hb = _field(a, "threshold"), _field(b, "threshold")
        n = min(len(fa), len(fb))
        differ = [k for k in range(n) if fa[k] != fb[k]
                  or not np.isclose(ha[k], hb[k], rtol=1e-9, atol=0)]
        if differ or len(fa) != len(fb):
            k = differ[0] if differ else n
            check(k < n, f"{label} tree {i}: leaf counts differ with no "
                         f"split that does")
            ga, gb = _field(a, "split_gain")[k], _field(b, "split_gain")[k]
            flip = {"tree": i, "node": k,
                    names[0]: {"feature": int(fa[k]), "gain": float(ga)},
                    names[1]: {"feature": int(fb[k]), "gain": float(gb)}}
            for name in ("left_child", "right_child", "decision_type"):
                check(_field(a, name)[:k].tolist()
                      == _field(b, name)[:k].tolist(),
                      f"{label}: {name} before the flip {flip}")
            check(abs(ga - gb) <= tie_rtol * max(abs(ga), abs(gb)),
                  f"{label}: split differs beyond a near-tie: {flip}")
            print(f"{label}: near-tie flip {flip}", file=sys.stderr)
            return i, flip, worst
        for name in ("num_leaves", "left_child", "right_child",
                     "decision_type", "leaf_count", "internal_count"):
            check(a.get(name) == b.get(name), f"{label} tree {i}: {name}")
        la, lb = _field(a, "leaf_value"), _field(b, "leaf_value")
        rel = float(np.abs(la - lb).max() / max(np.abs(lb).max(), 1e-12))
        check(rel <= leaf_rtol, f"{label} tree {i}: leaf values {rel}")
        worst = max(worst, rel)
    return len(ta), None, worst


def rank_metric_from_models(work, conf, key, models, digits=None):
    """The ranking metric ``key`` = (round, data, name) recomputed on the
    CPU from each model's raw scores after ``round`` rounds (scores
    rounded to ``digits`` significant digits first, when given), by the
    port's metric on the port's reading of the data file."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.config import Config, parse_config_file
    from lightgbm_tpu_torch.io.parser import parse_file
    from lightgbm_tpu_torch.metric import create_metric
    rnd, data, name = key
    with in_dir(work):
        params = parse_config_file(conf)
        cfg = Config(params)
        path = cfg.data if data == "training" else \
            cfg.valid_data[int(data.split("_")[1]) - 1]
        ds = lt.Dataset(path, params=params).construct()._binned
        X = parse_file(path, cfg.has_header, 0, ds.num_total_features)[1]
        out = []
        for model in models:
            raw = lt.Booster(model_file=model, device="cpu").predict(
                X, num_iteration=rnd, raw_score=True).reshape(1, -1)
            if digits is not None:
                raw = np.array([[float(f"{v:.{digits}g}") for v in raw[0]]])
            m = create_metric(name.split("@")[0], cfg)
            m.init(ds.metadata, ds.num_data)
            out.append(dict(zip(m.names, m.eval(raw)))[name])
    return out


def compare_round_metrics(a, b, work, conf, label, models,
                          names=("card", "cpu")):
    """Every round's every metric of log ``a`` against the reference
    ``b`` (``round_metrics`` dicts) within 1e-4.  A ranking metric (auc,
    ndcg, map) jumps where two scores tie, and rows that score alike in
    exact arithmetic tie or not by the last bit of f32 sums summed in
    another order; such a metric beyond 1e-4 passes only when its
    recomputation from the two ``models`` (a's, b's) gives the two
    logged values (1e-5) and agrees within 1e-4 once the scores are
    rounded to 6 significant digits, which merges such ties.  Returns
    (max difference within 1e-4, the ties so explained)."""
    check(set(a) == set(b) and b, f"{label}: metric sets differ")
    worst, ties = 0.0, []
    for key in sorted(b):
        d = abs(a[key] - b[key])
        if d <= 1e-4:
            worst = max(worst, d)
            continue
        check(key[2].split("@")[0] in ("auc", "ndcg", "map"),
              f"{label}: {key} {names[0]} {a[key]} {names[1]} {b[key]}")
        exact = rank_metric_from_models(work, conf, key, models)
        check(abs(exact[0] - a[key]) <= 1e-5
              and abs(exact[1] - b[key]) <= 1e-5,
              f"{label}: {key} recomputed {exact}")
        rounded = rank_metric_from_models(work, conf, key, models, 6)
        check(abs(rounded[0] - rounded[1]) <= 1e-4,
              f"{label}: {key} beyond 1e-4 after rounding: {rounded}")
        ties.append({"metric": list(key), names[0]: a[key],
                     names[1]: b[key], "rounded_6_digits": rounded})
        print(f"{label}: ranking metric at a near-tie of scores "
              f"{ties[-1]}", file=sys.stderr)
    return worst, ties


def phase_examples(workdir):
    """Each example conf through ``lightgbm_tpu_torch.cli.main``, on the
    card and on the CPU, in a copy of its directory: EXAMPLE_ROUNDS
    rounds, then the conf's ``predict.conf`` (raw scores) on its test
    file with each model, and the card once more with the CPU's model.
    K1 must launch Σ over trees of (1 + splits) times in the card's
    training run, and K4 in every card prediction.  Returns the
    launches."""
    from lightgbm_tpu_torch.ops import forest_walk as fw
    from lightgbm_tpu_torch.ops import leafhist as lh
    total = {}
    for name, folder in EXAMPLES:
        work = f"{workdir}/example_{name}"
        conf = copy_example(name, folder, work)
        runs = {}
        with in_dir(work):
            for dev in ("cuda", "cpu"):
                lh.reset_launch_counts()
                t0 = time.perf_counter()
                text = _cli([f"config={conf}", f"num_trees={EXAMPLE_ROUNDS}",
                             f"device={dev}", f"output_model=model_{dev}.txt"])
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
                with open(f"model_{dev}.txt") as fh:
                    model = fh.read()
                trees = tree_sections(model)
                runs[dev] = {
                    "text": model, "trees": len(trees), "train_s": train_s,
                    "leaves": sum(int(t["num_leaves"]) for t in trees),
                    "k1": lh.launch_counts()["digit_histogram"],
                    "metrics": round_metrics(text),
                    "preds": {}}
            for dev, model_dev in (("cuda", "cuda"), ("cuda", "cpu"),
                                   ("cpu", "cpu")):
                fw.reset_launch_counts()
                out = f"pred_{dev}_on_{model_dev}.txt"
                _cli(["config=predict.conf", f"device={dev}",
                      f"input_model=model_{model_dev}.txt",
                      "is_predict_raw_score=true", f"output_result={out}"])
                runs[dev]["preds"][model_dev] = (
                    np.loadtxt(out, ndmin=1),
                    sum(fw.launch_counts().values()))
        card, cpu = runs["cuda"], runs["cpu"]
        check(card["k1"] == card["leaves"],
              f"{name}: K1 launches {card['k1']} != {card['leaves']}")
        check(cpu["k1"] == 0, f"{name}: K1 launched in the CPU run")
        check(all(n > 0 for _, n in card["preds"].values()),
              f"{name}: a card prediction launched no K4")
        check(all(n == 0 for _, n in cpu["preds"].values()),
              f"{name}: K4 launched in the CPU prediction")
        compared, flip, leaf_rel = compare_model_texts(
            card["text"], cpu["text"], f"examples {name}")
        worst, ties = compare_round_metrics(
            card["metrics"], cpu["metrics"], work, conf, f"examples {name}",
            ("model_cuda.txt", "model_cpu.txt"))
        # the card's predict path on the CPU's model always; the two
        # models' own predictions unless a near-tie flipped a split
        want = cpu["preds"]["cpu"][0]
        same_model = float(np.abs(card["preds"]["cpu"][0] - want).max())
        check(np.allclose(card["preds"]["cpu"][0], want, rtol=1e-5,
                          atol=1e-5),
              f"{name}: card predict of the CPU model: {same_model}")
        own = float(np.abs(card["preds"]["cuda"][0] - want).max())
        if flip is None:
            check(np.allclose(card["preds"]["cuda"][0], want, rtol=1e-5,
                              atol=1e-5), f"{name}: predictions {own}")
        check(np.isfinite(card["preds"]["cuda"][0]).all(),
              f"{name}: non-finite predictions")
        emit({"phase": "examples", "conf": f"examples/{folder}/train.conf",
              "dropped_keys": list(EXAMPLE_DROPPED.get(name, ())),
              "dropped_because": "refused until bagging and "
                                 "feature_fraction are ported"
              if name in EXAMPLE_DROPPED else None,
              "rounds": EXAMPLE_ROUNDS, "trees": card["trees"],
              "train_s": {"cuda": card["train_s"], "cpu": cpu["train_s"]},
              "k1_launches": card["k1"],
              "k4_launches": {m: n for m, (_, n) in card["preds"].items()},
              "trees_structure_equal": compared, "near_tie_flip": flip,
              "max_leaf_value_diff_of_tree_max": leaf_rel,
              "metrics_compared": len(cpu["metrics"]),
              "max_metric_diff": worst, "ranking_metric_ties": ties,
              "final_metrics": {f"{k[1]} {k[2]}": v for k, v in
                                card["metrics"].items()
                                if k[0] == EXAMPLE_ROUNDS},
              "max_pred_diff_card_vs_cpu": own,
              "max_pred_diff_same_model": same_model,
              "predictions": int(want.shape[0])})
        total["digit_histogram"] = total.get("digit_histogram", 0) \
            + card["k1"]
        total["forest_walk"] = total.get("forest_walk", 0) + sum(
            n for _, n in card["preds"].values())
    return total


# ---------------------------------------------------------------------------
# the new objectives at full width on the card


def mslr_like(num_data: int, seed: int):
    """A stand-in for MSLR-WEB10K at its published shape: 136 dense
    features, relevance labels 0-4, and query sizes drawn from ``seed``
    between 1 and 1024 with a mean of about 120 (a clipped log-normal);
    a few features carry the relevance."""
    rng = np.random.RandomState(seed)
    sizes = np.clip(np.round(np.exp(rng.normal(4.5, 0.75, size=num_data))),
                    1, 1024).astype(np.int64)
    sizes = sizes[:np.searchsorted(np.cumsum(sizes), num_data) + 1]
    sizes[-1] -= sizes.sum() - num_data
    sizes = sizes[sizes > 0]
    X = rng.normal(size=(num_data, RANK_FEATURES)).astype(np.float32)
    latent = X[:, :8] @ rng.uniform(0.2, 1.0, size=8) \
        + rng.normal(scale=1.5, size=num_data)
    label = np.digitize(latent, np.quantile(latent, [0.45, 0.7, 0.88,
                                                     0.97]))
    return X.astype(np.float64), label.astype(np.float64), sizes


def objective_data(seed):
    """{kind: (Dataset, X)} of the objectives phase: the Higgs-like
    features with multiclass, continuous and count labels from one
    seeded latent, and the MSLR-like ranking set."""
    import lightgbm_tpu_torch as lt
    X, _ = make_higgs_like(OBJ_ROWS, seed=seed + 60)
    rng = np.random.RandomState(seed + 61)
    latent = 0.8 * X[:, 0] - 0.6 * X[:, 1] + 0.5 * X[:, 14] \
        + 0.3 * X[:, 7] * X[:, 2] + rng.normal(scale=0.8, size=OBJ_ROWS)
    labels = {
        "multiclass": np.digitize(latent, np.quantile(
            latent, [0.2, 0.4, 0.6, 0.8])).astype(np.float64),
        "continuous": latent,
        "counts": rng.poisson(np.exp(0.4 * latent)).astype(np.float64)}
    t0 = time.perf_counter()
    higgs = lt.Dataset(X, labels["continuous"],
                       params=dict(OBJ_PARAMS)).construct()
    Xr, yr, sizes = mslr_like(OBJ_ROWS, seed + 62)
    rank = lt.Dataset(Xr, yr, group=sizes,
                      params=dict(OBJ_PARAMS)).construct()
    emit({"phase": "objectives_data", "rows": OBJ_ROWS,
          "higgs_features": X.shape[1], "rank_features": RANK_FEATURES,
          "queries": int(len(sizes)), "query_size_mean": float(sizes.mean()),
          "query_size_max": int(sizes.max()),
          "relevance_counts": np.bincount(yr.astype(int)).tolist(),
          "binning_s": time.perf_counter() - t0})
    return higgs, X, labels, rank, Xr


class _timed_gradients:
    """CUDA events around every ``gradients_with`` of ``objective``
    inside the block."""

    def __init__(self, objective):
        self.objective, self.spans = objective, []

    def __enter__(self):
        fn = self.objective.gradients_with

        def timed(arrays, score):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(arrays, score)
            e.record()
            self.spans.append((s, e))
            return out
        self.objective.gradients_with = timed
        return self

    def __exit__(self, *exc):
        del self.objective.gradients_with

    def ms(self):
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.spans]


def k1_on_run(gbdt, grad, hess, label):
    """K1 on a training run's own card bins and digits (``grad``/``hess``
    of one class, the row weights), held bit-equal to its plain version:
    the root window (all rows), and windows of the rows ordered by the
    last feature, which carries no signal in the objectives phase's sets,
    as the ordered grower orders a leaf's rows, at sizes that take each
    of the wrapper's paths.  Returns the windows."""
    from lightgbm_tpu_torch.ops import leafhist as lh
    bins, w = gbdt.train_data.bins_rm, gbdt._row_weight
    g, h = grad * w, hess * w
    dig = lh.quantize_digits(g, h, w, lh.compute_scales(g, h, w))
    B = gbdt.grow_params.max_bin
    N, F = bins.shape
    order = torch.sort(bins[:, F - 1].to(torch.int32), stable=True).indices
    store = bins.view(torch.int16) if bins.dtype == torch.uint16 else bins
    ordered = store.index_select(0, order).view(bins.dtype)
    ordered_dig = dig.index_select(0, order)
    windows = [("root", bins, dig, 0, N)] + [
        ("ordered", ordered, ordered_dig, start, min(S, N - start))
        for start, S in ((N // 2 - 3, 4097), (5, lh.SMALL_WINDOW_MAX_ROWS),
                         (7, lh.SMALL_WINDOW_MAX_ROWS + 1),
                         (N - N // 3 - 1, N // 3))]
    for kind, b, d, start, S in windows:
        before = lh.launch_counts()["digit_histogram"]
        got = lh.digit_histogram(b, d, B, start, S)
        torch.cuda.synchronize()
        check(lh.launch_counts()["digit_histogram"] == before + 1,
              f"{label}: K1 on the run's bins launched no kernel")
        want = lh.digit_histogram_plain(b, d, B, start, S)
        check(torch.equal(got, want),
              f"{label}: K1 on the run's bins, {kind} window "
              f"[{start}, {start + S}) of {F} features, not bit-equal to "
              f"the plain version")
    return [[kind, start, S] for kind, _, _, start, S in windows]


def objective_run(name, extra, rounds, train_set, X, workdir):
    """``rounds`` rounds of one objective on the card: K1's launches,
    the first tree of each class re-grown through the plain versions
    (bit-identical), K1 on the run's own bins bit-equal to its plain
    version (``k1_on_run``), the saved model through K4 against the score
    buffer, the training metric's direction, the card's gradients
    against the same function on the CPU, and each round's seconds and
    gradient share."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import forest_walk as fw
    from lightgbm_tpu_torch.ops import leafhist as lh
    params = {**OBJ_PARAMS, "objective": name, **extra}
    booster = lt.Booster(params=params, train_set=train_set)
    gbdt = booster._booster
    lh.reset_launch_counts()
    evals = []
    seconds = []
    with _timed_gradients(gbdt.objective) as grads:
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            booster.update()
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            evals.append(booster.eval_train())
        grad_ms = grads.ms()
    k1 = lh.launch_counts()["digit_histogram"]
    grown = list(gbdt.tree_arrays)
    K = gbdt.num_class
    check(len(grown) == rounds * K, f"{name}: {len(grown)} trees")
    want = sum(int(ta.num_leaves) for ta in grown)
    check(k1 == want, f"{name}: K1 launches {k1} != {want}")

    # (b) the first tree of each class from the round-0 gradients
    score = torch.zeros_like(gbdt.train_data.score)
    grad, hess = gbdt.objective.gradients_with(gbdt._grad_arrays, score)
    for c in range(K):
        with _plain_kernels():
            ta, _, _ = gbdt._grow(grad[c], hess[c])
        compare_regrown(grown[c], ta, f"{name} class {c} tree 1", exact=True)
    k1_windows = k1_on_run(gbdt, grad[0], hess[0], name)
    # the card's gradients against the CPU's on the final scores
    cpu_arrays = gbdt.objective.gradient_arrays(torch.device("cpu"))
    final = gbdt.train_data.score
    g_card, h_card = gbdt.objective.gradients_with(gbdt._grad_arrays, final)
    g_cpu, h_cpu = gbdt.objective.gradients_with(cpu_arrays, final.cpu())
    tol = GRAD_RTOL
    grad_err = {}
    for what, a, b in (("grad", g_card, g_cpu), ("hess", h_card, h_cpu)):
        a, b = a.double().cpu(), b.double()
        err = float(((a - b).abs() / (b.abs() + b.abs().max())).max())
        check(bool(((a - b).abs() <= tol * b.abs()
                    + tol * b.abs().max()).all()),
              f"{name}: card {what} against the CPU's: {err}")
        grad_err[what] = err

    path = f"{workdir}/objective_{name}.txt"
    booster.save_model(path)
    fw.reset_launch_counts()
    pred = lt.Booster(model_file=path).predict(X[:4096], raw_score=True)
    k4 = sum(fw.launch_counts().values())
    check(k4 > 0, f"{name}: the saved model's prediction launched no K4")
    buf = gbdt.train_data.score[:, :4096].double().cpu().numpy()
    pred = pred.T if pred.ndim == 2 else pred[None]
    d_pred = float(np.abs(pred - buf).max())
    check(np.isfinite(pred).all() and d_pred <= 1e-5,
          f"{name}: saved model vs score buffer: {d_pred}")

    curve = {}
    for per_round in evals:
        for _, metric, value, bigger in per_round:
            curve.setdefault(metric, ([], bigger))[0].append(value)
    for metric, (values, bigger) in curve.items():
        check(all(np.isfinite(values))
              and (values[-1] > values[0] if bigger
                   else values[-1] < values[0]),
              f"{name}: training {metric} {values} does not improve")
    round_ms = [s * 1e3 for s in seconds]
    share = [g / r for g, r in zip(grad_ms, round_ms)]
    emit({"phase": "objectives", "objective": name, "params": params,
          "rows": train_set.num_data(), "features": X.shape[1],
          "rounds": rounds, "trees": len(grown),
          "leaves_per_tree": [int(ta.num_leaves) for ta in grown],
          "k1_launches": k1, "k4_launches": k4,
          "k1_bit_equal_on_run_bins": k1_windows,
          "round_s": seconds,
          "round_s_median_after_2": float(np.median(seconds[2:])),
          "gradient_ms": grad_ms,
          "gradient_share_median": float(np.median(share)),
          "gradient_vs_cpu_max_rel_err": grad_err,
          "saved_model_vs_score_buffer": d_pred,
          "training_metric": {m: v for m, (v, _) in curve.items()}})
    return {"digit_histogram": k1, "forest_walk": k4}


def phase_objectives(seed, workdir):
    """Every objective the port added, at full width on the card
    (OBJECTIVE_RUNS); returns the launches."""
    higgs, X, labels, rank, Xr = objective_data(seed)
    total = {}
    for name, extra, rounds, kind in OBJECTIVE_RUNS:
        if kind == "rank":
            ds, rows = rank, Xr
        else:
            ds, rows = higgs.set_label(labels[kind]), X
        got = objective_run(name, extra, rounds, ds, rows, workdir)
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
    return total


def cuda_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def phase_rule2(seed, dev, reps, at, windows, launches):
    """The order in which to redesign the kernels: first those that lose
    to the PyTorch call computing the same function at the sizes the
    main path launches them, then by launches x (ms - bound_ms); each
    entry names the PR that redesigned the kernel (REDESIGNED), if one
    did.  K1 is
    timed, beside ``index_add_`` and its bound, at each power-of-two
    window class the train phase counted (at the class's top size, the
    1M-row root for the largest); every other kernel at its kernels-line
    shape (K2/K3 run only at the training root, the full pass)."""
    from lightgbm_tpu_torch.ops import leafhist as lh
    F, B = 28, 255
    bins, dig = hist_inputs(np.random.RandomState(seed + 52), TRAIN_ROWS, F,
                            B, np.uint8, dev)
    k1 = []
    for cls, n in windows.get("digit_histogram", {}).items():
        S = min(int(cls), TRAIN_ROWS)
        nbytes = S * F + 9 * S + 4 * F * 9 * B
        ops = int((dig[:S] != 0).sum()) * F
        k1.append({"window_class": int(cls), "S": S, "launches": n,
                   "ms": cuda_ms(lambda: lh.digit_histogram(bins, dig, B, 0,
                                                            S), reps),
                   "library_ms": cuda_ms(index_add_call(bins, dig, S, F, B),
                                         5),
                   "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                                   ops / F32_OPS_PER_S) * 1e3})
    order = []
    for name, r in at.items():
        if name == "digit_histogram" and k1:
            gap = sum(c["launches"] * (c["ms"] - c["bound_ms"]) for c in k1)
            losing = sum(c["launches"] for c in k1
                         if c["ms"] > c["library_ms"])
        else:
            gap = launches[name] * (r["ms"] - r["bound_ms"])
            lib = r.get("library_ms")
            losing = launches[name] if lib is not None and r["ms"] > lib \
                else 0
        order.append({"kernel": name, "launches": launches[name],
                      "launches_losing_to_library": losing,
                      "launch_ms_over_bound": gap,
                      "redesigned_in_pr": REDESIGNED.get(name)})
    order.sort(key=lambda o: (o["launches_losing_to_library"] == 0,
                              -o["launch_ms_over_bound"]))
    emit({"phase": "rule2", "k1_by_window_class": k1, "order": order})


def back_to_back_ms(fn, reps: int, per: int = 50) -> float:
    """Median over ``reps`` CUDA-event timings of ``per`` calls of ``fn``
    enqueued back to back, divided by ``per``: a kernel's time without
    the host's launch cost where the kernel is the longer of the two."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(per):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / per)
    return float(np.median(times))


def graph_ms(fn, per: int = 50, reps: int = 10) -> float:
    """Median over ``reps`` CUDA-event timings of one replay of a CUDA
    graph that holds ``per`` calls of ``fn``, divided by ``per``: a
    call's device time back to back, with no host launch path between
    the calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per):
            fn()
    return cuda_ms(graph.replay, reps) / per


def phase_timing(seed, dev, higgs_model, higgs_grid, lin_model, lin_grid,
                 reps):
    """Every walk variant at each B of TIMING_SIZES: the constant f32 and
    bf16 tables on the Higgs forest's trees, the linear f32 and bf16 ones
    on the linear Higgs forest's, beside the constant walk over the same
    trees (``const_walk_ms``), each timed as ``timed`` does (``ms`` is
    its ``single_ms``; ``device_us`` names pass 0, the raw rows'
    bucketize, pass 1 and pass 2), with its launch plan.  Plain versions
    at every B for the constant f32 walks, at B = 4096 for the others.
    Bound: bins (or raw rows) plus the linear binned walk's covariates
    plus the output plus the forest tables (nodes, leaves, affine
    tables) and the raw walk's cut tables once, over 3.35 TB/s; ops: this
    data's node visits, 4 Kahan operations a tree a row, the raw walk's
    binary searches and, for linear leaves, a multiply and an add a used
    slot plus one add."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import forest_walk as fw

    def freeze(g, quantize=False):
        return lt.CompiledForest.from_booster(g, device=dev,
                                              quantize_leaves=quantize)

    structures = (
        ("higgs", (freeze(higgs_model),
                   freeze(scaled(higgs_model, TINY_LEAVES), True)),
         higgs_grid, (), 0),
        ("higgs_linear", (freeze(lin_model),
                          freeze(scaled(lin_model, TINY_LEAVES), True)),
         lin_grid, LINEAR_CAT, 8))
    rng = np.random.RandomState(seed + 30)
    rows = []
    for struct, cfs, grid, cat, ncat in structures:
        base = cfs[0].walk_tables
        const = base._replace(coeff=None, feat=None, max_feat=-1)
        bnd, cats, is_cat = cfs[0].cut_tables()
        depth = torch.from_numpy(leaf_depths(base)).to(dev)
        K, T = base.num_class, base.trees_per_class
        cut_bytes = bnd.numel() * 4 + cats.numel() * 4 + is_cat.numel()
        search_steps = int(np.ceil(np.log2(bnd.shape[1] + 1)))
        for B in TIMING_SIZES:
            X = random_rows(rng, B, grid, cat, ncat, tie_frac=0.02)
            bins = cfs[0].device_bins(X)
            xr = cfs[0].device_rows(X)
            xt = cfs[0].device_covariates(X)
            F = xr.shape[0]
            leaves = fw.walk_plain(const, bins)[1]
            leaves_r = fw.walk_plain(const, fw.bucketize_plain(
                bnd, cats, is_cat, xr, const.nan_bin))[1]
            const_ms = (cuda_ms(lambda: fw.forest_walk(const, bins), reps),
                        cuda_ms(lambda: fw.forest_walk_raw(
                            const, bnd, cats, is_cat, xr), reps))
            for cf in cfs:
                t = cf.walk_tables
                cov = xt if t.linear else None
                table_bytes = (t.nodes.numel() * 4 + t.leaves.numel()
                               * t.leaves.element_size())
                slots = None
                if t.linear:
                    table_bytes += t.coeff.numel() * 4 + t.feat.numel() * 4
                    slots = (t.feat >= 0).sum(dim=2).reshape(K, T, -1)
                for raw in (False, True):
                    name = t.variant(raw)
                    lv = leaves_r if raw else leaves
                    if raw:
                        def run():
                            return fw.forest_walk_raw(t, bnd, cats, is_cat,
                                                      xr)

                        def plain():
                            return fw.forest_walk_raw_plain(
                                t, bnd, cats, is_cat, xr)
                        nbytes = xr.numel() * 4 + cut_bytes
                    else:
                        def run():
                            return fw.forest_walk(t, bins, cov)

                        def plain():
                            return fw.forest_walk_plain(t, bins, cov)
                        nbytes = bins.numel() * bins.element_size() + (
                            cov.numel() * 4 if t.linear else 0)
                    nbytes += table_bytes + K * B * 4
                    visits = int(depth.gather(2, lv).sum())
                    ops = visits + 4 * K * T * B + (
                        B * F * search_steps if raw else 0)
                    if t.linear:
                        ops += int((2 * slots.gather(2, lv) + 1).sum())
                    t4 = timed(run, reps)
                    ms = t4["single_ms"]
                    const_f32 = name in ("forest_walk", "forest_walk_raw")
                    plain_ms = (cuda_ms(plain, 1) if const_f32 or B == 4096
                                else None)
                    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                    ops_ms = ops / F32_OPS_PER_S * 1e3
                    row = {"kernel": name, "forest": struct, "B": B,
                           "ms": ms, "plain_ms": plain_ms,
                           "rows_per_s": B / (ms * 1e-3),
                           "node_visits": visits,
                           "bytes": int(nbytes), "ops": int(ops),
                           "bound_ms": max(bytes_ms, ops_ms),
                           "bound_by": "bytes" if bytes_ms >= ops_ms
                           else "operations"}
                    if not const_f32:
                        row["const_walk_ms"] = const_ms[int(raw)]
                    row.update(t4)
                    row["plan"] = fw.walk_plan(t, F, B, raw)._asdict()
                    rows.append(row)
    rows += leaf_hist_timing(seed, dev, reps)
    rows += children_hist_timing(seed, dev, reps)
    rows += probe_timing(dev, reps)
    emit({"phase": "timing", "reps": reps, "rows": rows})
    return rows


def leaf_hist_timing(seed, dev, reps):
    """K1 at the root of the training cell (28 features, 255 bins, uint8)
    and at smaller windows: kernel, plain version and the one
    ``index_add_`` call the plain version is built on, beside the bound.
    Bytes: every input row read once and the output written once; ops:
    one add per non-zero digit per feature (this data's count)."""
    from lightgbm_tpu_torch.ops import leafhist as lh
    rng = np.random.RandomState(seed + 50)
    F, B = 28, 255
    bins, dig = hist_inputs(rng, max(HIST_TIMING_SIZES), F, B, np.uint8,
                            dev)
    rows = []
    for S in HIST_TIMING_SIZES:
        k_ms = cuda_ms(lambda: lh.digit_histogram(bins, dig, B, 0, S), reps)
        p_ms = cuda_ms(lambda: lh.digit_histogram_plain(bins, dig, B, 0, S),
                       2)
        lib_ms = cuda_ms(index_add_call(bins, dig, S, F, B), 2)
        nbytes = S * F * bins.element_size() + 9 * S + 4 * F * 9 * B
        ops = int((dig[:S] != 0).sum()) * F
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        rows.append({"kernel": "digit_histogram", "S": S, "F": F,
                     "max_bin": B,
                     "ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                     "rows_per_s": S / (k_ms * 1e-3), "bytes": int(nbytes),
                     "ops": ops, "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms
                     else "operations"})
    return rows


def children_hist_timing(seed, dev, reps):
    """K2 and K3 in their root form (every row in the left child) at S
    rows, 28 features, 255 bins, uint8: kernel, plain version and, for
    K2, the one f32 ``index_add_`` its plain version is built on (no
    PyTorch call computes K3's candidates: null), beside the bound.
    Bytes: bins, g, h, w and leaf ids read once, the output written once
    (K3's scratch stays in L2); ops: three adds per row per feature (this
    data puts every row in a child), plus for K3 about 20 operations per
    (child, feature, bin) of the scan."""
    from lightgbm_tpu_torch.ops import children_hist as ch
    from lightgbm_tpu_torch.ops.split import SplitParams
    rng = np.random.RandomState(seed + 51)
    F, B = 28, 255
    Smax = max(HIST_TIMING_SIZES)
    bins_all, g_all, h_all, w_all, _ = children_inputs(rng, Smax, F, B,
                                                       np.uint8, dev)
    sp = SplitParams(TRAIN_PARAMS["min_data_in_leaf"], 1e-3)
    nb = torch.full((F,), B, dtype=torch.int32, device=dev)
    cat = torch.zeros(F, dtype=torch.bool, device=dev)
    fm = torch.ones(F, dtype=torch.bool, device=dev)
    rows = []
    for S in HIST_TIMING_SIZES:
        bins = bins_all[:, :S].contiguous()
        g, h, w = g_all[:S], h_all[:S], w_all[:S]
        leaf = torch.zeros(S, dtype=torch.int32, device=dev)
        totals = torch.stack([torch.stack([g.sum(), h.sum(), w.sum()]),
                              torch.zeros(3, device=dev)])
        k2 = (bins, g, h, w, leaf, 0, -2, B)
        k3 = (bins, g, h, w, leaf, 0, -2, totals, nb, cat, fm, B, sp)
        k2_ms = cuda_ms(lambda: ch.children_histograms(*k2), reps)
        k3_ms = cuda_ms(lambda: ch.fused_split_candidates(*k3), reps)
        p2_ms = cuda_ms(lambda: ch.build_children_histograms(*k2), 2)
        p3_ms = cuda_ms(lambda: ch.fused_split_candidates_plain(*k3), 2)
        seg = (torch.arange(F, device=dev)[:, None] * B
               + bins.long()).reshape(-1)
        vals = torch.stack([g, h, w], dim=-1)[None].expand(F, S, 3) \
            .reshape(-1, 3)
        acc = torch.zeros((2 * F * B + 1, 3), dtype=torch.float32,
                          device=dev)
        lib_ms = cuda_ms(lambda: acc.index_add_(0, seg, vals), 2)
        del seg, vals, acc
        in_bytes = S * F * bins.element_size() + 16 * S
        for name, ms, plain_ms, lib, out_bytes, ops in (
                ("children_histograms", k2_ms, p2_ms, lib_ms,
                 2 * F * B * 3 * 4, 3 * S * F),
                ("fused_split_candidates", k3_ms, p3_ms, None,
                 2 * F * 8 * 4, 3 * S * F + 20 * 2 * F * B)):
            nbytes = in_bytes + out_bytes
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / F32_OPS_PER_S * 1e3
            rows.append({"kernel": name, "S": S, "F": F, "max_bin": B,
                         "ms": ms, "plain_ms": plain_ms, "library_ms": lib,
                         "rows_per_s": S / (ms * 1e-3),
                         "bytes": int(nbytes), "ops": int(ops),
                         "bound_ms": max(bytes_ms, ops_ms),
                         "bound_by": "bytes" if bytes_ms >= ops_ms
                         else "operations"})
        del bins, leaf
    return rows


def host_enqueue_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn`` takes to enqueue its work (no
    synchronize inside the loop): the host part of a call's time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def device_us(fn, calls: int = 10, tries: int = 5):
    """Device-only microseconds a call of ``fn`` by kernel name, from
    ``torch.profiler`` over ``calls`` calls, or "not measured" where the
    profiler shows no device time in ``tries`` attempts (0.2 s apart).  Each timed call
    launches each of its kernels once, so a kernel's time a call is the
    mean over the launches the profiler recorded (it does not always
    record all of them, nor always any)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = getattr(e, "cuda_time_total", 0)
            if t and t > 0 and e.count > 0:
                out[e.key[:120]] = t / e.count
        if out:
            return out
        time.sleep(0.2)
    return "not measured"


def timed(fn, reps: int):
    """A call's time three ways: alone (CUDA events around one call,
    host enqueue included), back to back (``back_to_back_ms``) and its
    host enqueue; plus its device-only time by kernel name."""
    dev_us = device_us(fn)
    row = {"single_ms": cuda_ms(fn, reps),
           "back_to_back_ms": back_to_back_ms(fn, max(1, reps // 2), 20),
           "host_enqueue_us": host_enqueue_us(fn), "device_us": dev_us}
    if isinstance(dev_us, dict):
        row["device_ms_total"] = sum(dev_us.values()) * 1e-3
    return row


def index_add_call(bins, dig, S: int, F: int, B: int):
    """The one ``index_add_`` call that computes K1's function over the
    first S rows (its inputs built outside the timed call)."""
    dev = bins.device
    seg = (torch.arange(F, device=dev)[None, :] * B
           + bins[:S].long()).reshape(-1)
    vals = dig[:S].to(torch.int32)[:, None, :].expand(S, F, 9).reshape(-1, 9)
    acc = torch.zeros((F * B, 9), dtype=torch.int32, device=dev)
    return lambda: acc.index_add_(0, seg, vals)


def k1_window_timing(seed, dev, reps):
    """K1 at every window class of the train phase (uint8, 28 features,
    255 bins, the class's top size, the 1M-row root for 2^20): the small
    path, the large path, the wrapper as the growers call it (its own
    choice of path) and the ``index_add_`` library call, each timed
    alone, back to back, by its host enqueue and by its device time.
    The crossover: the smallest class from which the large path's
    device time (back to back where the profiler shows none) is below the
    small path's at every larger class."""
    from lightgbm_tpu_torch.ops import leafhist as lh
    F, B = 28, 255
    rng = np.random.RandomState(seed + 53)
    bins, dig = hist_inputs(rng, TRAIN_ROWS, F, B, np.uint8, dev)
    classes = []
    for cls in WINDOW_CLASSES:
        S = min(cls, TRAIN_ROWS)
        calls = {
            "small": lambda: lh.digit_histogram(bins, dig, B, 0, S,
                                                path="small"),
            "large": lambda: lh.digit_histogram(bins, dig, B, 0, S,
                                                path="large"),
            "wrapper": lambda: lh.digit_histogram(bins, dig, B, 0, S),
            "index_add_": index_add_call(bins, dig, S, F, B)}
        row = {"window_class": cls, "S": S,
               "plan": lh.plan(S, F, B, lh.sm_count(dev.index))._asdict(),
               **{name: timed(fn, reps) for name, fn in calls.items()}}
        classes.append(row)

    def device_ms(t):
        return t.get("device_ms_total", t["back_to_back_ms"])

    crossover = None
    for row in reversed(classes):
        if device_ms(row["large"]) >= device_ms(row["small"]):
            break
        crossover = row["window_class"]
    return {"classes": classes, "crossover_class": crossover,
            "small_window_max_rows": lh.SMALL_WINDOW_MAX_ROWS}


def children_index_add(bins, g, h, w, leaf, max_bin: int):
    """The one ``index_add_`` call that computes K2's function, as its
    plain version builds it: (child, feature, bin) keys with a dump slot
    for rows of neither child (leaf 1 left, leaf 2 right; its inputs built
    outside the timed call)."""
    F, N = bins.shape
    dev = bins.device
    child = (leaf == 2).long()
    seg = (child[None, :] * (F * max_bin)
           + torch.arange(F, device=dev)[:, None] * max_bin + bins.long())
    seg = torch.where(((leaf == 1) | (leaf == 2))[None, :], seg,
                      torch.full_like(seg, 2 * F * max_bin)).reshape(-1)
    vals = torch.stack([g, h, w], dim=-1)[None].expand(F, N, 3) \
        .reshape(-1, 3)
    acc = torch.zeros((2 * F * max_bin + 1, 3), dtype=torch.float32,
                      device=dev)
    return lambda: acc.index_add_(0, seg, vals)


def k3_occupancy_timing(seed, dev, reps):
    """K3 and K2 on the fused grower's 1M-row full pass
    (28 features, 255 bins, uint8) with OCCUPANCIES rows in the two
    children (``occupancy_leaves``), each timed as ``timed`` does, beside
    the ``index_add_`` call computing K2's function (``library_ms``,
    CUDA events); and K2's root form (``root_histogram``, no leaf
    array) over all rows."""
    from lightgbm_tpu_torch.ops import children_hist as ch
    from lightgbm_tpu_torch.ops.split import SplitParams
    N, F, B = TRAIN_ROWS, 28, 255
    bins, g, h, w, _ = children_inputs(np.random.RandomState(seed + 54), N,
                                       F, B, np.uint8, dev)
    sp = SplitParams(TRAIN_PARAMS["min_data_in_leaf"], 1e-3)
    nb = torch.full((F,), B, dtype=torch.int32, device=dev)
    cat = torch.zeros(F, dtype=torch.bool, device=dev)
    fm = torch.ones(F, dtype=torch.bool, device=dev)
    rows = []
    for occ in OCCUPANCIES:
        leaf = occupancy_leaves(seed, N, occ, dev)
        k3 = (bins, g, h, w, leaf, 1, 2, child_totals(g, h, w, leaf), nb,
              cat, fm, B, sp)
        lib = children_index_add(bins, g, h, w, leaf, B)
        row = {"occupancy": min(occ, N), "rows": N,
               "k2": timed(lambda: ch.children_histograms(
                   bins, g, h, w, leaf, 1, 2, B), reps),
               "k3": timed(lambda: ch.fused_split_candidates(*k3), reps),
               "library_ms": cuda_ms(lib, 5)}
        del lib
        rows.append(row)
    return {"occupancies": rows,
            "k2_root": timed(lambda: ch.root_histogram(bins, g, h, w, B),
                             reps)}


def probe_timing(dev, reps):
    """P1 on the probe's input: the kernel alone (launched back to back;
    also as single launches, which include the host's launch cost, and
    by its host enqueue), the plain version and one call of the probe's
    50-call chain (kernel + ``^ 1``) and a CUDA graph of 50 launches
    replayed (``graph_ms``: the device's time a launch, no host path),
    beside three launch floors: an empty kernel launched back to back
    from one C loop (``launch_floor_ms``), from one Python call a launch
    through the same host path as the wrapper
    (``python_launch_floor_ms``) and in a replayed graph
    (``graph_launch_floor_ms``).  Bytes: the block read once and
    written once; ops: per stage and column one compare, one select per
    word and the 13 roll reads (the count the JAX probe's comment
    implies), 2 x 13 a column.  No PyTorch call computes a roll-select
    chain (library null).

    P2 on the probe's inputs and first window (5, N/2): each of the
    probe's five runs as the probe calls it (the TPU's nb sets nothing on
    the card, so the words runs and the matrix runs each time one call),
    each timed as ``timed`` does (``ms`` is ``single_ms``: events around
    one call), beside K1 on the same window timed the same ways in the
    same run (``over_k1``: the ratios), the plain version (which reads
    the window on the host and unpacks it) and the ``index_add_`` its
    plain version is built on, on the already unpacked window (the unpack
    not timed).
    Bytes: the window's bin and digit words (or matrix rows) read once,
    the window and the output; ops: one add per non-zero digit per
    feature (this data's count).  The kernels line takes laneconcat at
    nb = 2048, the probe's first run."""
    from lightgbm_tpu_torch.ops import leafhist as lh
    from lightgbm_tpu_torch.ops import roll_chain as rc
    from lightgbm_tpu_torch.ops import window_hist as wh
    from lightgbm_tpu_torch.tools import probe_dynhist as pd
    from lightgbm_tpu_torch.tools import probe_roll as pr

    def bound(nbytes, ops):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        return {"bytes": int(nbytes), "ops": int(ops),
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}

    x = torch.from_numpy(pr.make_input()).to(dev)
    floor_calls = 1000
    p1 = timed(lambda: rc.roll_chain(x), reps)
    rows = [{"kernel": "roll_chain", "stages": rc.STAGES,
             "words": rc.WORDS, "nb": rc.NB,
             "ms": back_to_back_ms(lambda: rc.roll_chain(x), reps),
             **p1, "plain_ms": cuda_ms(lambda: rc.roll_chain_plain(x), reps),
             "library_ms": None,
             "chain_ms_per_call": cuda_ms(lambda: pr.chain(x), 5) / pr.CHAIN,
             "launch_floor_ms": cuda_ms(
                 lambda: rc.empty_launches(dev, floor_calls), 5)
             / floor_calls,
             "python_launch_floor_ms": back_to_back_ms(
                 lambda: rc.empty_launches(dev), reps),
             "graph_ms": graph_ms(lambda: rc.roll_chain(x)),
             "graph_launch_floor_ms": graph_ms(
                 lambda: rc.empty_launches(dev)),
             # one SM's shared-memory traffic: per stage and column one
             # 8-byte (key, source) read and one 8-byte write
             "smem_bytes": rc.STAGES * rc.NB * 16,
             **bound(2 * x.numel() * 4,
                     rc.STAGES * rc.NB * 2 * (rc.WORDS + 1)),
             "kernels_line": True}]

    bins, digits = pd.make_inputs(pd.N)
    n = bins.shape[0]
    bw, dw, dmat = pd.device_inputs(bins, digits, dev)
    off, count = pd.FIRST_OFF, n // 2
    win = torch.tensor([off, count], dtype=torch.int32, device=dev)
    tb = torch.from_numpy(bins).to(dev)
    k1 = timed(lambda: lh.digit_histogram(tb, dmat, pd.B, off, count), reps)
    ops = int((dmat[off:off + count] != 0).sum()) * pd.F
    seg = (torch.arange(pd.F, device=dev)[None, :] * pd.B
           + tb[off:off + count].long()).reshape(-1)
    vals = dmat[off:off + count].to(torch.int32)[:, None, :] \
        .expand(count, pd.F, 9).reshape(-1, 9)
    acc = torch.zeros((pd.F * pd.B, 9), dtype=torch.int32, device=dev)
    lib_ms = cuda_ms(lambda: acc.index_add_(0, seg, vals), 2)
    del seg, vals, acc
    plain = {m: cuda_ms(lambda: wh.window_digit_histogram_plain(
        bw, dmat if m else dw, win, pd.F, pd.B), 2) for m in (False, True)}
    out_bytes = 4 * pd.F * 9 * pd.B

    def p2_row(name, nb, matrix):
        dig = dmat if matrix else dw
        t = timed(lambda: wh.window_digit_histogram(
            bw, dig, win, pd.F, pd.B), reps)
        nbytes = count * (len(bw) * 4 + (9 if matrix else 12)) + 8 \
            + out_bytes
        return {"kernel": "window_digit_histogram", "layout": name,
                "nb": nb, "digits": "matrix" if matrix else "words",
                "plan": wh.card_plan(bw, dig, pd.F, pd.B)._asdict(),
                "S": count, "F": pd.F, "max_bin": pd.B,
                "ms": t["single_ms"], **t,
                "plain_ms": plain[matrix], "library_ms": lib_ms,
                "k1_same_window": k1,
                "over_k1": {k: t[k] / k1[k] for k in
                            ("single_ms", "back_to_back_ms",
                             "device_ms_total") if k in t and k in k1},
                "rows_per_s": count / (t["single_ms"] * 1e-3),
                **bound(nbytes, ops),
                "kernels_line": name == "laneconcat" and nb == 2048}

    for name, nb, matrix in pd.RUNS:
        rows.append(p2_row(name, nb, matrix))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timing-reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from lightgbm_tpu_torch.ops import children_hist as ch
    from lightgbm_tpu_torch.ops import forest_walk as fw
    from lightgbm_tpu_torch.ops import leafhist as lh
    from lightgbm_tpu_torch.ops import roll_chain as rc
    from lightgbm_tpu_torch.ops import window_hist as wh
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    smi = phase_build()
    higgs_model, higgs_grid = random_model(args.seed, **HIGGS)
    lin_model, lin_grid, linear_set = linear_forests(args.seed, higgs_model,
                                                     higgs_grid)
    errs = {name: 0.0 for name in SOURCE}
    phase_kernels(args.seed, dev, higgs_model, higgs_grid, linear_set, errs)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        served = phase_serve(args.seed, dev, higgs_model, higgs_grid,
                             workdir, errs)
        launches = dict(served)
        launches.update(phase_serve_linear(args.seed, dev, lin_model,
                                           lin_grid, higgs_model, workdir,
                                           errs))
        trained, windows = phase_train(args.seed, dev, workdir)
        launches.update(trained)
        for name, n in [*phase_examples(workdir).items(),
                        *phase_objectives(args.seed, workdir).items()]:
            launches[name] += n
    launches.update(phase_probes(args.timing_reps))
    timing = phase_timing(args.seed, dev, higgs_model, higgs_grid,
                          lin_model, lin_grid, args.timing_reps)
    emit({"phase": "k1_windows",
          **k1_window_timing(args.seed, dev, args.timing_reps)})
    emit({"phase": "k3_occupancy",
          **k3_occupancy_timing(args.seed, dev, args.timing_reps)})
    # the walks at B=4096, the histograms at the training root (S = 1M),
    # the probes at the probe's shapes
    at = {r["kernel"]: r for r in timing
          if r.get("B") == 4096 or r.get("S") == TRAIN_ROWS
          or r.get("kernels_line")}
    check(set(fw.LAUNCHES) | set(lh.LAUNCHES) | set(ch.LAUNCHES)
          | set(rc.LAUNCHES) | set(wh.LAUNCHES) == set(REPLACES),
          "a kernel is missing a row")
    phase_rule2(args.seed, dev, args.timing_reps, at, windows, launches)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errs[name], "ms": at[name]["ms"],
         "plain_ms": at[name]["plain_ms"], "bound_ms": at[name]["bound_ms"],
         "bound_by": at[name]["bound_by"],
         "library_ms": at[name].get("library_ms")}
        for name in SOURCE]})
    print(f"seconds {time.perf_counter() - t_start:.1f}", flush=True)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
