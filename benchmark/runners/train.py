"""The training runner: one training job of a configuration.

Set-up makes the table (its row order drawn from the seed), bins it
through ``lt.Dataset``, builds the ``lt.Booster`` and runs the traffic's
warm rounds (the first loads the kernels).  The window then runs
``Booster.update()`` rounds, each followed by a device synchronisation,
until ``--seconds`` have passed; the rate is all its rounds over all its
time.  With ``--trace 1`` the program's own trace window (``trace_dir``)
records the first ``trace_rounds`` rounds of the window.

Afterwards the program's trees (its model text) and training scores are
judged by the plain reference (``reference/``): the binning, the first
tree and a seed-drawn sample of the window's trees, and the scores
after the last round.
"""

from __future__ import annotations

import gc
import glob
import importlib
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from ..reference import binning, model_text
from ..reference import tree as ref_tree


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class ProgramTrainer:
    """The system under test: ``lt.Booster.update()`` rounds."""

    def __init__(self, lt, X, y, group, params, device, setup):
        ds = lt.Dataset(X, y, group=group, params=dict(params))
        ds.construct()
        setup.mark("dataset")
        self.booster = lt.Booster(params=dict(params), train_set=ds,
                                  device=device)
        setup.mark("booster")

    def update(self) -> bool:
        return bool(self.booster.update())

    def trees(self):
        return model_text.parse_trees(self.booster.model_to_string())

    def scores(self) -> np.ndarray:
        return np.asarray(self.booster._inner_predict(0), np.float64)

    def close(self) -> None:
        self.booster = None


class Reference:
    """The plain reference's view of one table: its own binning, codes
    and objective state, made from the raw inputs alone."""

    def __init__(self, X, y, group, cfg, device):
        p = cfg["params"]
        self.params = ref_tree.Params.from_config(p)
        self.bounds = binning.bin_bounds(
            X, int(p.get("max_bin", 255)), int(p.get("min_data_in_bin", 3)),
            int(p.get("bin_construct_sample_cnt", 200000)),
            int(p.get("data_random_seed", 1)))
        self.codes = binning.codes(torch.from_numpy(X).to(device), self.bounds)
        self.num_bin = torch.tensor([len(b) for b in self.bounds],
                                    dtype=torch.int64, device=device)
        self.objective = importlib.import_module(
            f"{__package__.rsplit('.', 1)[0]}.reference.objectives."
            f"{cfg['objective']}")
        self.state = self.objective.prepare(y, group, p, device)

    def judge(self, trees, check, early, prog_scores) -> dict:
        misses = 0
        for t in trees:
            n = t["num_leaves"] - 1
            t["split_bin"], m = binning.threshold_bins(
                t["split_feature"][:n], t["threshold"][:n], self.bounds)
            misses += m
        out = ref_tree.judge_run(self.codes, self.num_bin, trees, check,
                                 early, self.objective, self.state,
                                 prog_scores, self.params)
        out["threshold_misses"] = float(misses)
        return out


class ControlTrainer:
    """The plain reference in the program's place, one precision below
    the configuration's float32: gradients, hessians, leaf values and
    scores held in bfloat16, sums accumulated in float32."""

    def __init__(self, X, y, group, cfg, device, setup=None):
        self.ref = Reference(X, y, group, cfg, device)
        self.cfg = cfg
        self.score = torch.zeros(X.shape[0], dtype=torch.bfloat16,
                                 device=device)
        self._trees = []
        if setup is not None:
            setup.mark("dataset")

    def update(self) -> bool:
        r = self.ref
        g, h = r.objective.gradients(r.state, self.score.float())
        t = ref_tree.grow(r.codes, r.num_bin, g.to(torch.bfloat16),
                          h.to(torch.bfloat16), r.params,
                          acc_dtype=torch.float32, out_dtype=torch.bfloat16)
        leaf = ref_tree.leaf_of_rows(r.codes, t)
        val = torch.as_tensor(t["leaf_value"], device=self.score.device)
        self.score = (self.score.float() + val.float()[leaf]).to(torch.bfloat16)
        n = t["num_leaves"] - 1
        t["threshold"] = np.array([r.bounds[f][b] for f, b in
                                   zip(t["split_feature"][:n], t["split_bin"][:n])])
        self._trees.append(t)
        return False

    def trees(self):
        return [dict(t) for t in self._trees]

    def scores(self) -> np.ndarray:
        return self.score.double().cpu().numpy()

    def close(self) -> None:
        self.ref = None


def check_indices(first_window: int, rounds: int, count: int, seed: int):
    """The first tree, then up to ``count`` window trees drawn from the
    seed, the first and the last of the window always among them."""
    window = list(range(first_window, first_window + rounds))
    if len(window) <= count:
        pick = window
    else:
        rng = np.random.default_rng(seed)
        inner = rng.choice(window[1:-1], count - 2, replace=False).tolist()
        pick = [window[0], window[-1]] + inner
    return sorted({0, *pick})


def run(lt, cell, cfg, traffic, seed, seconds, trace, device, setup,
        make_trainer=None, log=None):
    """One run; returns what ``run.py`` prints."""
    gen = importlib.import_module(
        f"{__package__.rsplit('.', 1)[0]}.data.{cfg['generator']}")
    X, y, group = gen.make(cfg, seed, device)
    setup.mark("data")
    params = dict(cfg["params"])
    warm = int(traffic["warm_rounds"])
    trace_rounds = int(traffic["trace_rounds"]) if trace else 0
    trace_dir = None
    if trace:
        trace_dir = tempfile.mkdtemp(prefix="bench_trace_")
        params.update(trace_dir=trace_dir, trace_start_iter=warm,
                      trace_num_iters=trace_rounds)
    if make_trainer is None:
        trainer = ProgramTrainer(lt, X, y, group, params, device, setup)
    else:
        trainer = make_trainer(X, y, group, cfg, device, setup)
    expected = 0
    for i in range(warm):
        expected += 0 if trainer.update() else 1
        _sync(device)
        setup.mark("warm_first_round" if i == 0 else f"warm_round_{i}")
    setup_s = setup.total()

    max_rounds = int(params.get("num_trees", 500)) - warm
    walls = []
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        stop = trainer.update()
        _sync(device)
        walls.append(time.perf_counter() - a)
        expected += 0 if stop else 1
        elapsed = time.perf_counter() - t0
        if stop or len(walls) >= max_rounds:
            break
        if elapsed >= seconds and len(walls) > trace_rounds:
            break
    rounds = len(walls)
    rate = rounds / elapsed
    if log:
        w = np.sort(walls)
        log(f"rounds: {rounds}, s a round: min {w[0]:.4f} median "
            f"{np.median(w):.4f} max {w[-1]:.4f}")
    memory_peak = [torch.cuda.max_memory_allocated(i)
                   for i in range(torch.cuda.device_count())] \
        if torch.device(device).type == "cuda" else [0]

    trees = trainer.trees()
    scores = trainer.scores()
    trainer.close()
    del trainer
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    summary = None
    if trace_dir is not None:
        from .. import tracing
        files = glob.glob(os.path.join(trace_dir, "trace_iter*.json"))
        summary = tracing.summarize(files[0]) if files else None
        shutil.rmtree(trace_dir, ignore_errors=True)

    # the reference, after the program's state is gone
    t_ref = time.perf_counter()
    ref = Reference(X, y, group, cfg, device)
    check = check_indices(warm, rounds, int(traffic["check_trees"]), seed)
    # the start and the first window tree carry the split regret
    numbers = ref.judge(trees, [i for i in check if i < len(trees)],
                        [0, warm], scores)
    numbers["tree_count_gap"] = float(abs(len(trees) - expected))
    ref_s = time.perf_counter() - t_ref
    if log:
        log(f"reference: {ref_s:.3f} s, {len(check)} trees judged, "
            f"{len(trees)} trees")
        log("readings: " + " ".join(f"{k}={v!r}" for k, v in
                                    sorted(numbers.items())))

    ctx = None
    if trace:
        num_data, F = X.shape
        obj_cost = importlib.import_module(
            f"{__package__.rsplit('.', 1)[0]}.cost.{cfg['objective']}")
        work = obj_cost.pair_work(y, group) if hasattr(obj_cost, "pair_work") \
            else {}
        ctx = {"trace": summary, "trace_rounds": trace_rounds,
               "train": {"num_data": num_data, "features": F,
                         "bin_bytes": 1 if int(params.get("max_bin", 255)) < 256
                         else 2,
                         "max_bin": int(params.get("max_bin", 255)),
                         "objective": cfg["objective"],
                         "objective_work": work,
                         "traced_trees": trees[warm:warm + trace_rounds],
                         "untraced_trees": trees[warm + trace_rounds:
                                                 warm + rounds],
                         "untraced_walls": walls[trace_rounds:]}}
    return {"e2e": {"train_iters_per_s": rate, "setup_s": setup_s},
            "numbers": numbers, "attempted": rounds, "failed": 0,
            "memory_peak": max(memory_peak), "ctx": ctx, "trace": summary,
            "window_s": elapsed}
