"""Readings that set a cell's correctness limits, on the card:

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --modes program,control,stale_step,half_batch,altered_answer \
        [--seconds 5]

Runs the cell's runner once a seed and mode, in one process: ``program``
is the system under test, ``control`` the plain reference in its place
one precision below the configuration's (``ControlTrainer`` /
``ControlScorer``), and each fault of ``faults.py`` the program with
that fault planted.  One JSON line a run on standard output: the cell,
the seed, the mode and every number the check compares."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program,control")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    os.environ.setdefault("TRITON_CACHE_DIR", str(HERE / ".cache" / "triton"))
    sys.path.insert(0, str(REPO))
    import importlib

    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    import lightgbm_tpu_torch as lt
    from benchmark import faults, harness

    _, cell, cfg, traffic = harness.load_cell(args.workload)
    runner = importlib.import_module(f"benchmark.runners.{traffic['runner']}")
    for seed in [int(s) for s in args.seeds.split(",")]:
        for mode in args.modes.split(","):
            setup = harness.Setup(time.perf_counter())
            kw = {}
            if traffic["runner"] == "train":
                if mode == "control":
                    kw["make_trainer"] = runner.ControlTrainer
                elif mode != "program":
                    kw["make_trainer"] = faults.trainer(mode, lt)
            else:
                if mode == "control":
                    kw["make_scorer"] = runner.ControlScorer
                elif mode != "program":
                    kw["make_scorer"] = faults.scorer(mode, lt, setup)
            t = time.perf_counter()
            res = runner.run(lt, cell, cfg, traffic, seed, args.seconds, False,
                             "cuda", setup, log=lambda m: print(
                                 m, file=sys.stderr, flush=True), **kw)
            print(json.dumps({"cell": cell["name"], "seed": seed,
                              "mode": mode, "numbers": res["numbers"],
                              "attempted": res["attempted"],
                              "e2e": res["e2e"],
                              "seconds": time.perf_counter() - t}),
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
