#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA
card.

    python3 chip_smoke.py [--seed 0] [--timing-reps 20]

Every phase prints one JSON line; any failure raises and exits non-zero.

1. ``build``: nvcc builds every kernel under ``lightgbm_tpu_torch/csrc/``
   for ``sm_90a`` (one nvcc per source, all started together).
2. ``kernels``: each kernel's wrapper on tensors on the card, held
   against its plain PyTorch version on the same inputs.  Forest walks
   (raw scores to <= 1e-6 absolute; both fold f32 leaf values in one
   Kahan order, so they are expected bit-equal): a small binary forest
   (3 categorical and 5 numeric features, 10% NaN, f32-colliding cut
   values, 31 leaves, 20 trees), a multiclass forest with a ragged number
   of trees per class, and the Higgs forest below at the bucket sizes its
   serving run uses.  The leaf histogram K1 (exact int32 sums, so
   bit-equal, ``torch.equal``): uint8 and uint16 bins, F in {5, 28, 30},
   windows of S in {0, 1, 4097, 65536, 1000000} rows at a row offset.
   The children histograms K2 and the fused split candidates K3 (f32
   atomics: the tolerances of ``ops/children_hist.py``): uint8 with 255
   bins and uint16 with 1000, F in {5, 28, 30}, N in the same sizes, a
   third of the rows in each child and a third elsewhere, plus the root
   forms at 1M rows; K3's features and thresholds equal except at
   reported near-ties.  Each call adds exactly one to its launch counter.
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
   ordered grower's partition) and the rest with CUDA events.
5. ``timing``: CUDA-event medians of each kernel and its plain version on
   the Higgs forest at B in {1, 256, 4096, 65536}, and of K1, K2 and K3
   at S in {4096, 65536, 500000, 1000000} beside their plain versions
   and the ``index_add_`` library call, each beside its bound.

Then the kernels summary line, the card's name and power limit as
``nvidia-smi`` gives them, and last ``{"ok": true, "device": {...}}``.
Without a CUDA card the script exits non-zero before printing a result.
"""

import argparse
import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

SOURCE = {"forest_walk": "lightgbm_tpu_torch/csrc/forest_walk.cu",
          "forest_walk_raw": "lightgbm_tpu_torch/csrc/forest_walk.cu",
          "digit_histogram": "lightgbm_tpu_torch/csrc/leaf_hist.cu",
          "children_histograms": "lightgbm_tpu_torch/csrc/children_hist.cu",
          "fused_split_candidates":
              "lightgbm_tpu_torch/csrc/children_hist.cu"}
REPLACES = {"forest_walk": "lightgbm_tpu/ops/pallas_walk.py:372",
            "forest_walk_raw": "lightgbm_tpu/ops/pallas_walk.py:391",
            "digit_histogram": "lightgbm_tpu/ops/leafhist.py:138",
            "children_histograms": "lightgbm_tpu/ops/pallas_histogram.py:185",
            "fused_split_candidates":
                "lightgbm_tpu/ops/pallas_histogram.py:232"}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
TOL = 1e-6
HIGGS = dict(num_features=28, num_trees=500, num_leaves=255, num_cuts=255)
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
# a split of a re-grown tree may differ from the kernel run's only where
# the two choices' gains are this close (relative): an f32 near-tie
TREE_TIE_RTOL = 1e-3
# the training runs: (grower, extra params, the histogram kernel it runs);
# the cache of 63 x 28 x 9 x 255 int32 (16 MB) is over a 1 MB pool
GROWERS = (("ordered", {}, "digit_histogram"),
           ("cached", {"serial_grow": "cached"}, "digit_histogram"),
           ("fused", {"serial_grow": "fused"}, "fused_split_candidates"),
           ("nocache", {"histogram_pool_size": 1, "memory_policy": "degrade"},
            "children_histograms"))


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


def phase_build():
    from lightgbm_tpu_torch.ops import _build
    t0 = time.perf_counter()
    secs = _build.build_all()
    wall = time.perf_counter() - t0
    report = [ln.strip() for name in secs
              for ln in _build.build_log(name).splitlines()
              if "registers" in ln or "spill" in ln]
    smi = nvidia_smi_line()
    emit({"phase": "build", "seconds": wall, "per_source": secs,
          "ptxas": report, "nvidia_smi": smi})
    return smi


def compare_kernels(cf, X, sizes, label, errs):
    """Both wrappers against their plain versions at each size; each
    wrapper launch must add exactly one to its counter."""
    from lightgbm_tpu_torch.ops import forest_walk as fw
    tables = cf.walk_tables
    bnd, cats, is_cat = cf.cut_tables()
    out = {}
    for B in sizes:
        bins = cf.device_bins(X[:B])
        rows = cf.device_rows(X[:B])
        before = fw.launch_counts()
        got = fw.forest_walk(tables, bins)
        got_raw = fw.forest_walk_raw(tables, bnd, cats, is_cat, rows)
        torch.cuda.synchronize()
        after = fw.launch_counts()
        check(after["forest_walk"] == before["forest_walk"] + 1
              and after["forest_walk_raw"] == before["forest_walk_raw"] + 1,
              f"{label} B={B}: launch counters {before} -> {after}")
        want = fw.forest_walk_plain(tables, bins)
        want_raw = fw.forest_walk_raw_plain(tables, bnd, cats, is_cat, rows)
        d = float((got - want).abs().max())
        d_raw = float((got_raw - want_raw).abs().max())
        check(bool(torch.isfinite(got).all() and torch.isfinite(got_raw)
                   .all()), f"{label} B={B}: non-finite kernel output")
        check(d <= TOL and d_raw <= TOL,
              f"{label} B={B}: kernel vs plain max_abs_diff binned={d} "
              f"raw={d_raw} (tolerance {TOL})")
        errs["forest_walk"] = max(errs["forest_walk"], d)
        errs["forest_walk_raw"] = max(errs["forest_walk_raw"], d_raw)
        out[str(B)] = {"binned": d, "raw": d_raw,
                       "bit_equal": bool(torch.equal(got, want)
                                         and torch.equal(got_raw, want_raw))}
    return out


def phase_kernels(seed, dev, higgs_model, higgs_grid, errs):
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import children_hist as ch
    from lightgbm_tpu_torch.ops import forest_walk as fw
    from lightgbm_tpu_torch.ops import leafhist as lh
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
    results["digit_histogram"] = compare_leaf_hist(seed, dev, errs)
    results["children_hist"] = compare_children_hist(seed, dev, errs)
    emit({"phase": "kernels", "max_abs_diff": results,
          "launches": {**fw.launch_counts(), **lh.launch_counts(),
                       **ch.launch_counts()}})


def compare_leaf_hist(seed, dev, errs):
    """K1 against its plain version: bit-equal at every dtype, width and
    window size, one launch per call."""
    from lightgbm_tpu_torch.ops import leafhist as lh
    rng = np.random.RandomState(seed + 14)
    out = {}
    for dtype, max_bin in ((np.uint8, 255), (np.uint16, 1000)):
        for F in HIST_FEATURES:
            bins, dig = hist_inputs(rng, max(HIST_SIZES) + 3, F, max_bin,
                                    dtype, dev)
            for S in HIST_SIZES:
                start = 3 if S < max(HIST_SIZES) else 0
                before = lh.launch_counts()["digit_histogram"]
                got = lh.digit_histogram(bins, dig, max_bin, start, S)
                torch.cuda.synchronize()
                after = lh.launch_counts()["digit_histogram"]
                check(after == before + 1,
                      f"K1 {dtype.__name__} F={F} S={S}: launch counter "
                      f"{before} -> {after}")
                want = lh.digit_histogram_plain(bins, dig, max_bin, start, S)
                check(torch.equal(got, want),
                      f"K1 {dtype.__name__} F={F} S={S}: not bit-equal to "
                      f"the plain version")
                d = float((got - want).abs().max()) if got.numel() else 0.0
                errs["digit_histogram"] = max(errs["digit_histogram"], d)
                out[f"{dtype.__name__}/F{F}/S{S}"] = d
            del bins, dig
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
    of the rows in each child; plus the root forms at 1M rows.  Each call
    adds exactly one to its counter."""
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
                totals = torch.stack([torch.stack([
                    (g * m).sum(), (h * m).sum(), (w * m).sum()])
                    for m in (leaf == 1, leaf == 2)])
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
    return {"max_abs_diff": out, "near_ties": ties,
            "tolerance": {"hist_rtol_of_abs_sums": ch.HIST_RTOL,
                          "hist_atol": ch.HIST_ATOL,
                          "gain": "children_hist.gain_tolerance"}}


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
        launches = fw.launch_counts()
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


class _timed_updates:
    """Record the synchronized wall time of every ``Booster.update`` call
    made inside the block (one boosting round each)."""

    def __init__(self):
        self.seconds = []

    def __enter__(self):
        from lightgbm_tpu_torch.basic import Booster
        self._orig = orig = Booster.update
        rec = self.seconds

        def update(booster):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(booster)
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
    train_set = lt.Dataset(X, y, params=TRAIN_PARAMS).construct()
    valid_set = lt.Dataset(Xv, yv, reference=train_set).construct()
    binning_s = time.perf_counter() - t0
    emit({"phase": "train_data", "rows": TRAIN_ROWS,
          "valid_rows": VALID_ROWS, "features": X.shape[1], "seed": seed,
          "generate_s": gen_s, "binning_s": binning_s})
    launches = {}
    ordered = None
    for name, extra, kernel in GROWERS:
        run = train_run(name, extra, kernel, train_set, valid_set, X,
                        workdir, ordered)
        if ordered is None:
            ordered = run
        launches[kernel] = launches.get(kernel, 0) + run["launches"][kernel]
    return launches


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
    cached trees and every grower's final valid AUC."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import children_hist as ch
    from lightgbm_tpu_torch.ops import grow as gr
    from lightgbm_tpu_torch.ops import leafhist as lh
    from lightgbm_tpu_torch.ops import ordered_grow as og
    params = {**TRAIN_PARAMS, **extra}
    L = params["num_leaves"]
    evals = {}
    lh.reset_launch_counts()
    ch.reset_launch_counts()
    og.reset_host_syncs()
    gr.reset_host_syncs()
    t0 = time.perf_counter()
    with _timed_updates() as rounds:
        booster = lt.train(params, train_set, TRAIN_ROUNDS,
                           valid_sets=[train_set, valid_set],
                           valid_names=["train", "valid"],
                           evals_result=evals, verbose_eval=False)
    torch.cuda.synchronize()
    launches = {**lh.launch_counts(), **ch.launch_counts()}
    syncs = og.host_syncs() + gr.host_syncs()
    train_s = time.perf_counter() - t0

    gbdt = booster._booster
    check(gbdt.grow_kind == name, f"{name}: the booster grew with "
                                  f"{gbdt.grow_kind}")
    grown = list(gbdt.tree_arrays)
    leaves = [int(ta.num_leaves) for ta in grown]
    check(booster.num_trees() == TRAIN_ROUNDS,
          f"{name}: {booster.num_trees()} trees after {TRAIN_ROUNDS} rounds")
    want = sum(leaves) if name == "ordered" else TRAIN_ROUNDS * L
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
            ta, _, delta = gbdt._grow(grad[0], hess[0])
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

    auc = {k: v["auc"] for k, v in evals.items()}
    for key in ("train", "valid"):
        a = auc[key]
        check(len(a) == TRAIN_ROUNDS and all(np.isfinite(a))
              and min(a) > 0.5 and a[-1] > a[0],
              f"{name}: {key} AUC {a} is not finite, above 0.5 and rising")
    beside = {}
    if ordered is not None:
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
           "launches": launches, "regrown": regrow,
           "saved_model_vs_score_buffer": d_pred,
           "auc_train": auc["train"], "auc_valid": auc["valid"],
           **beside, "profile_round": phases}
    emit(out)
    return {"launches": launches, "auc": auc, "trees": grown}


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
        spans[key] = []

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
               "fused": ((ch, "fused_split_candidates", "k3"),
                         (gr, "combine_feature_candidates", "split_scan")),
               "nocache": ((ch, "children_histograms", "k2"),
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


def phase_timing(seed, dev, higgs_model, higgs_grid, reps):
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import forest_walk as fw
    cf = lt.CompiledForest.from_booster(higgs_model, device=dev)
    tables = cf.walk_tables
    bnd, cats, is_cat = cf.cut_tables()
    depth = torch.from_numpy(leaf_depths(tables)).to(dev)
    K, T = tables.num_class, tables.trees_per_class
    table_bytes = (tables.nodes.numel() * 4 + tables.leaves.numel() * 4)
    cut_bytes = bnd.numel() * 4 + cats.numel() * 4 + is_cat.numel()
    search_steps = int(np.ceil(np.log2(bnd.shape[1] + 1)))
    rng = np.random.RandomState(seed + 30)
    rows = []
    for B in TIMING_SIZES:
        X = random_rows(rng, B, higgs_grid, tie_frac=0.02)
        bins = cf.device_bins(X)
        xt = cf.device_rows(X)
        F = xt.shape[0]
        k_ms = cuda_ms(lambda: fw.forest_walk(tables, bins), reps)
        kr_ms = cuda_ms(lambda: fw.forest_walk_raw(tables, bnd, cats,
                                                   is_cat, xt), reps)
        p_ms = cuda_ms(lambda: fw.forest_walk_plain(tables, bins), 2)
        pr_ms = cuda_ms(lambda: fw.forest_walk_raw_plain(
            tables, bnd, cats, is_cat, xt), 2)
        leaves = fw.walk_plain(tables, bins)[1]
        visits = int(depth.gather(2, leaves).sum())
        leaves_r = fw.walk_plain(tables, fw.bucketize_plain(
            bnd, cats, is_cat, xt, tables.nan_bin))[1]
        visits_r = int(depth.gather(2, leaves_r).sum())
        out_bytes = K * B * 4
        for name, ms, plain_ms, nbytes, ops in (
                ("forest_walk", k_ms, p_ms,
                 bins.numel() * bins.element_size() + table_bytes
                 + out_bytes, visits + 4 * K * T * B),
                ("forest_walk_raw", kr_ms, pr_ms,
                 xt.numel() * 4 + cut_bytes + table_bytes + out_bytes,
                 visits_r + 4 * K * T * B + B * F * search_steps)):
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / F32_OPS_PER_S * 1e3
            rows.append({"kernel": name, "B": B, "ms": ms,
                         "plain_ms": plain_ms,
                         "rows_per_s": B / (ms * 1e-3),
                         "node_visits": visits if name == "forest_walk"
                         else visits_r,
                         "bytes": int(nbytes), "ops": int(ops),
                         "bound_ms": max(bytes_ms, ops_ms),
                         "bound_by": "bytes" if bytes_ms >= ops_ms
                         else "operations"})
    rows += leaf_hist_timing(seed, dev, reps)
    rows += children_hist_timing(seed, dev, reps)
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
        seg = (torch.arange(F, device=dev)[None, :] * B
               + bins[:S].long()).reshape(-1)
        vals = dig[:S].to(torch.int32)[:, None, :].expand(S, F, 9) \
            .reshape(-1, 9)
        acc = torch.zeros((F * B, 9), dtype=torch.int32, device=dev)
        lib_ms = cuda_ms(lambda: acc.index_add_(0, seg, vals), 2)
        del seg, vals, acc
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
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    smi = phase_build()
    higgs_model, higgs_grid = random_model(args.seed, **HIGGS)
    errs = {name: 0.0 for name in SOURCE}
    phase_kernels(args.seed, dev, higgs_model, higgs_grid, errs)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        launches = phase_serve(args.seed, dev, higgs_model, higgs_grid,
                               workdir, errs)
        launches.update(phase_train(args.seed, dev, workdir))
    timing = phase_timing(args.seed, dev, higgs_model, higgs_grid,
                          args.timing_reps)
    # the walks at B=4096, the histograms at the training root (S = 1M)
    at = {r["kernel"]: r for r in timing
          if r.get("B") == 4096 or r.get("S") == TRAIN_ROWS}
    check(set(fw.LAUNCHES) | set(lh.LAUNCHES) | set(ch.LAUNCHES)
          == set(REPLACES), "a kernel is missing a row")
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
