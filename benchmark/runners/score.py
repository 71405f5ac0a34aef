"""The scoring runner: batch scoring of a configuration's forest.

Set-up makes a pool of raw rows and a random forest from the seed
(``data/forest.py``), writes the forest as model text, loads it with
``lt.Booster(model_str=...)`` and warms every bucket of its walk.  The
window is one caller's closed loop of ``Booster.predict`` calls, back to
back, each on a slice of the pool at an offset drawn from the seed; the
call sizes are one fixed log-uniform multiset of ``cycle_calls`` sizes
(``call_sizes``), repeated.  Each call is timed from its start to its result on the
host.  With ``--trace 1`` a ``torch.profiler`` window records the first
``trace_calls`` calls.

Afterwards the plain reference walks the raw rows of the first two
blocks' calls (two of every octave, the largest among them) and of a
seed-drawn sample of the cycle's other calls made in the window through
the forest in f64, and compares the probabilities.
"""

from __future__ import annotations

import gc
import importlib
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from ..data import forest as forest_gen
from ..reference import model_text, walk


def call_sizes(traffic: dict, seed: int) -> np.ndarray:
    """The cycle's sizes: log-uniform over [rows_min, rows_max], as blocks
    that each hold one call of every octave of the range.  Block ``j`` of
    ``K`` takes each octave's ``(j + 0.5) / K`` quantile; the blocks come
    in an order drawn from the seed, and each block's octaves too, so
    every seed sends the same sizes and any run of whole blocks the same
    mix."""
    lo, hi = np.log2(traffic["rows_min"]), np.log2(traffic["rows_max"])
    octaves = int(round(hi - lo))
    K = int(traffic["cycle_calls"]) // octaves
    rng = np.random.default_rng(seed)
    out = []
    for j in rng.permutation(K):
        for o in rng.permutation(octaves):
            out.append(2.0 ** (lo + (hi - lo) * (o + (j + 0.5) / K) / octaves))
    return np.round(out).astype(np.int64)


class ProgramScorer:
    def __init__(self, lt, text, device, setup):
        self.booster = lt.Booster(model_str=text, device=device)
        setup.mark("load")
        self.booster.compile(warmup=True)

    def predict(self, X):
        return self.booster.predict(X)

    def close(self):
        self.booster = None


class ControlScorer:
    """The plain reference in the program's place, one precision below
    the configuration's float32 leaf values: leaf values in bfloat16,
    summed in float32."""

    def __init__(self, trees, text, device):
        self.forest = walk.stack(trees, device)
        self.device = device

    def predict(self, X):
        raw, _ = walk.raw_scores(torch.from_numpy(X).to(self.device),
                                 self.forest, torch.bfloat16)
        return walk.sigmoid(raw.double()).cpu().numpy()

    def close(self):
        self.forest = None


def run(lt, cell, cfg, traffic, seed, seconds, trace, device, setup,
        make_scorer=None, log=None):
    gen = importlib.import_module(
        f"{__package__.rsplit('.', 1)[0]}.data.{cfg['generator']}")
    pool_rows = int(traffic["pool_rows"])
    pool = gen.pool(cfg, pool_rows, seed, device)
    fc = cfg["forest"]
    sample = torch.from_numpy(pool[-int(fc["sample_rows"]):]).to(device)
    trees = forest_gen.make(sample, int(fc["trees"]), int(fc["num_leaves"]),
                            float(fc["leaf_value_std"]), seed)
    text = model_text.write_model(trees, int(cfg["features"]))
    setup.mark("data_and_model")
    if make_scorer is None:
        scorer = ProgramScorer(lt, text, device, setup)
    else:
        scorer = make_scorer(trees, text, device)
    sizes = call_sizes(traffic, seed)
    rng = np.random.default_rng(seed + 1)
    offsets = rng.integers(0, pool_rows - sizes + 1)
    # warm the host path at the cycle's smallest and largest calls
    for i in (int(np.argmin(sizes)), int(np.argmax(sizes))):
        scorer.predict(pool[offsets[i]:offsets[i] + sizes[i]])
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    setup.mark("warm")
    setup_s = setup.total()

    # the calls compared: the first two blocks (two calls of every octave,
    # the largest among them) and a seed-drawn sample of the cycle's rest
    c = len(sizes)
    head = 2 * int(round(np.log2(traffic["rows_max"] / traffic["rows_min"])))
    check = set(range(head)) | set((head + rng.choice(
        c - head, int(traffic["check_calls"]), replace=False)).tolist())
    kept = {}
    lat, rows_done = [], []
    failed = 0
    trace_calls = int(traffic["trace_calls"]) if trace else 0
    prof = None
    if trace_calls:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    t0 = time.perf_counter()
    i = 0
    while True:
        k = i % c
        n, off = int(sizes[k]), int(offsets[k])
        a = time.perf_counter()
        try:
            out = scorer.predict(pool[off:off + n])
        except Exception as e:  # noqa: BLE001 - a failed call is counted
            failed += 1
            out = None
            if log:
                log(f"call {i} failed: {e!r}")
        lat.append(time.perf_counter() - a)
        rows_done.append(n)
        if i < c and k in check:
            kept[k] = out
        i += 1
        if prof is not None and i == trace_calls:
            prof.stop()
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds and i > trace_calls:
            break
    memory_peak = [torch.cuda.max_memory_allocated(j)
                   for j in range(torch.cuda.device_count())] \
        if torch.device(device).type == "cuda" else [0]
    scorer.close()
    del scorer
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    summary = None
    if prof is not None:
        from .. import tracing
        tdir = tempfile.mkdtemp(prefix="bench_trace_")
        path = os.path.join(tdir, "score.json")
        prof.export_chrome_trace(path)
        summary = tracing.summarize(path)
        shutil.rmtree(tdir, ignore_errors=True)
        del prof

    # the reference, after the program's state is gone
    t_ref = time.perf_counter()
    forest = walk.stack(trees, device)
    gap, bad = 0.0, 0
    for k in sorted(kept):
        got = kept[k]
        n, off = int(sizes[k]), int(offsets[k])
        X = torch.from_numpy(pool[off:off + n]).to(device)
        want = walk.sigmoid(walk.raw_scores(X, forest)[0]).cpu().numpy()
        if got is None or np.shape(got) != (n,):
            bad += 1
            continue
        gap = max(gap, float(np.max(np.abs(np.asarray(got, np.float64)
                                           - want))))
    vs = torch.from_numpy(pool[:int(traffic["visit_sample_rows"])]).to(device)
    _, visits = walk.raw_scores(vs, forest)
    if log:
        log(f"reference: {time.perf_counter() - t_ref:.3f} s, "
            f"{len(kept)} calls compared")

    numbers = {"score_gap": gap, "calls_wrong_shape": float(bad)}
    lat_ms = np.asarray(lat) * 1e3
    if log:
        log(f"calls: {len(lat)}, ms a call: median {np.median(lat_ms):.3f} "
            f"p95 {np.percentile(lat_ms, 95):.3f} max {lat_ms.max():.3f}")
    ctx = None
    if trace:
        nodes = sum(t["num_leaves"] - 1 for t in trees)
        leaves = sum(t["num_leaves"] for t in trees)
        ctx = {"trace": summary, "score": {
            "features": int(cfg["features"]), "trees": len(trees),
            "nodes": nodes, "leaves": leaves,
            "bin_bytes": 2 if max(len(np.unique(np.concatenate(
                [t["threshold"][t["split_feature"] == f] for t in trees])))
                for f in range(int(cfg["features"]))) >= 255 else 1,
            "visits_per_row": visits / vs.shape[0],
            "traced_rows": rows_done[:trace_calls],
            "untraced_rows": rows_done[trace_calls:],
            "untraced_walls": lat[trace_calls:]}}
    return {"e2e": {"score_rows_per_s": float(np.sum(rows_done)) / elapsed,
                    "score_p95_ms": float(np.percentile(lat_ms, 95)),
                    "setup_s": setup_s},
            "numbers": numbers, "attempted": len(lat), "failed": failed,
            "memory_peak": max(memory_peak), "ctx": ctx, "trace": summary,
            "window_s": elapsed}
