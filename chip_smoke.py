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
   windows of S in {0, 1, 4097, 65536, 1000000} rows at a row offset;
   each call adds exactly one to its launch counter.
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
   with a 100k-row valid set.  The K1 counter is set to 0 just before and
   read just after.  Checks: (a) K1 launches equal the sum over trees of
   1 + splits; (b) the first two trees re-grown on the card with the
   plain histogram from the same gradients are bit-identical
   ``TreeArrays``; (c) ``Booster.predict(raw_score=True)`` of the saved
   model on 4096 train rows equals the training score buffer to 1e-5;
   (d) train and valid AUC finite, above 0.5 and higher after round 10
   than after round 1.  One more round, outside the counted run, splits
   the round's time into K1, partition and split-scan with CUDA events.
5. ``timing``: CUDA-event medians of each kernel and its plain version on
   the Higgs forest at B in {1, 256, 4096, 65536}, and of K1 at S in
   {4096, 65536, 500000, 1000000} beside its plain version and the
   ``index_add_`` library call, each beside its bound.

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
          "digit_histogram": "lightgbm_tpu_torch/csrc/leaf_hist.cu"}
REPLACES = {"forest_walk": "lightgbm_tpu/ops/pallas_walk.py:372",
            "forest_walk_raw": "lightgbm_tpu/ops/pallas_walk.py:391",
            "digit_histogram": "lightgbm_tpu/ops/leafhist.py:138"}
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
    emit({"phase": "kernels", "max_abs_diff": results,
          "launches": {**fw.launch_counts(), **lh.launch_counts()}})


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
    """The training path at full width; returns the K1 launches it made."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import leafhist as lh
    from lightgbm_tpu_torch.ops import ordered_grow as og
    from lightgbm_tpu_torch.ops.grow import pack_tree_arrays

    t0 = time.perf_counter()
    X, y = make_higgs_like(TRAIN_ROWS, seed=seed + 40)
    Xv, yv = make_higgs_like(VALID_ROWS, seed=seed + 41)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_set = lt.Dataset(X, y, params=TRAIN_PARAMS).construct()
    valid_set = lt.Dataset(Xv, yv, reference=train_set).construct()
    binning_s = time.perf_counter() - t0

    evals = {}
    lh.reset_launch_counts()
    og.reset_host_syncs()
    t0 = time.perf_counter()
    with _timed_updates() as rounds:
        booster = lt.train(TRAIN_PARAMS, train_set, TRAIN_ROUNDS,
                           valid_sets=[train_set, valid_set],
                           valid_names=["train", "valid"],
                           evals_result=evals, verbose_eval=False)
    torch.cuda.synchronize()
    launches = lh.launch_counts()
    syncs = og.host_syncs()
    train_s = time.perf_counter() - t0

    gbdt = booster._booster
    grown = list(gbdt.tree_arrays)
    leaves = [int(ta.num_leaves) for ta in grown]
    check(booster.num_trees() == TRAIN_ROUNDS,
          f"{booster.num_trees()} trees after {TRAIN_ROUNDS} rounds")
    # (a) one K1 launch for each root and each split
    check(launches["digit_histogram"] == sum(leaves),
          f"K1 launches {launches['digit_histogram']} != sum over trees of "
          f"1 + splits ({sum(leaves)})")

    # (b) the first two trees again, through the plain histogram
    score = torch.zeros_like(gbdt.train_data.score)
    regrown = []
    for i in range(2):
        grad, hess = gbdt.objective.gradients_with(gbdt._grad_arrays, score)
        ta, _, delta = og.grow_tree_ordered(
            gbdt.train_data.bins_rm, gbdt.num_bin, gbdt.is_cat,
            gbdt._feat_mask, grad[0], hess[0], gbdt._row_weight,
            gbdt.shrinkage_rate, gbdt.grow_params,
            histogram=lh.digit_histogram_plain)
        score[0] += delta
        a, b = pack_tree_arrays(ta), pack_tree_arrays(grown[i])
        same = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        check(same, f"tree {i} re-grown with the plain histogram differs "
                    f"from the kernel run's")
        regrown.append(same)

    # (c) the saved model predicts the training scores
    path = f"{workdir}/higgs_trained.txt"
    booster.save_model(path)
    loaded = lt.Booster(model_file=path)
    pred = loaded.predict(X[:4096], raw_score=True)
    buf = gbdt.train_data.score[0, :4096].double().cpu().numpy()
    check(pred.shape == buf.shape and np.isfinite(pred).all(),
          "saved-model predictions have the wrong shape or non-finite "
          "values")
    d_pred = float(np.abs(pred - buf).max())
    check(d_pred <= 1e-5, f"saved model vs training score buffer: {d_pred}")

    # (d) AUC
    auc = {k: v["auc"] for k, v in evals.items()}
    for name in ("train", "valid"):
        a = auc[name]
        check(len(a) == TRAIN_ROUNDS and all(np.isfinite(a))
              and min(a) > 0.5 and a[-1] > a[0],
              f"{name} AUC {a} is not finite, above 0.5 and rising")

    # one more round, outside the counted run, split by phase
    phases = profile_round(booster)
    emit({"phase": "train", "rows": TRAIN_ROWS, "valid_rows": VALID_ROWS,
          "features": X.shape[1], "params": TRAIN_PARAMS,
          "rounds": TRAIN_ROUNDS, "seed": seed,
          "generate_s": gen_s, "binning_s": binning_s, "train_s": train_s,
          "round_s": rounds.seconds,
          "round_s_median_3_10": float(np.median(rounds.seconds[2:])),
          "leaves_per_tree": leaves,
          "host_syncs_per_tree": syncs / len(grown),
          "launches": launches, "regrown_bit_identical": regrown,
          "saved_model_vs_score_buffer": d_pred,
          "auc_train": auc["train"], "auc_valid": auc["valid"],
          "profile_round": phases})
    return launches


def profile_round(booster):
    """One extra boosting round with CUDA events around every K1 call,
    every partition and every split scan of the grower: the summed
    event times of each, beside the round's synchronized wall time."""
    from lightgbm_tpu_torch.ops import leafhist as lh
    from lightgbm_tpu_torch.ops import ordered_grow as og
    spans = {"k1": [], "partition": [], "split_scan": []}

    def wrap(fn, key):
        def timed(*args, **kwargs):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*args, **kwargs)
            e.record()
            spans[key].append((s, e))
            return out
        return timed

    saved = (lh.digit_histogram, og._partition, og.find_best_split)
    lh.digit_histogram = wrap(saved[0], "k1")
    og._partition = wrap(saved[1], "partition")
    og.find_best_split = wrap(saved[2], "split_scan")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        booster.update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        lh.digit_histogram, og._partition, og.find_best_split = saved
    out = {"round_s": wall}
    for key, pairs in spans.items():
        ms = sum(s.elapsed_time(e) for s, e in pairs)
        out[key] = {"calls": len(pairs), "ms": ms,
                    "share": ms * 1e-3 / wall}
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timing-reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from lightgbm_tpu_torch.ops import forest_walk as fw
    from lightgbm_tpu_torch.ops import leafhist as lh
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    smi = phase_build()
    higgs_model, higgs_grid = random_model(args.seed, **HIGGS)
    errs = {"forest_walk": 0.0, "forest_walk_raw": 0.0,
            "digit_histogram": 0.0}
    phase_kernels(args.seed, dev, higgs_model, higgs_grid, errs)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        launches = phase_serve(args.seed, dev, higgs_model, higgs_grid,
                               workdir, errs)
        launches.update(phase_train(args.seed, dev, workdir))
    timing = phase_timing(args.seed, dev, higgs_model, higgs_grid,
                          args.timing_reps)
    # the walks at B=4096, K1 at the training root (S = 1M)
    at = {r["kernel"]: r for r in timing
          if r.get("B") == 4096 or r.get("S") == TRAIN_ROWS}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errs[name], "ms": at[name]["ms"],
         "plain_ms": at[name]["plain_ms"], "bound_ms": at[name]["bound_ms"],
         "bound_by": at[name]["bound_by"],
         "library_ms": at[name].get("library_ms")}
        for name in ("forest_walk", "forest_walk_raw", "digit_histogram")]})
    check(set(fw.LAUNCHES) | set(lh.LAUNCHES) == set(REPLACES),
          "a kernel is missing a row")
    print(f"seconds {time.perf_counter() - t_start:.1f}", flush=True)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
