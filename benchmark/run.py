"""Benchmark of lightgbm_tpu_torch on NVIDIA cards.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card(s) of this machine: the
cell's configuration (``benchmark/configs/<config>.json``) under its
traffic mix (``benchmark/traffic/<traffic>.json``, whose ``runner``
names the module of ``benchmark/runners/`` that runs it).  Standard
error gets set-up's parts, then each correctness number beside its
limit as its last lines; the last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones, each read
by ``benchmark/metrics/<name>.py``), ``device``, with ``--trace 1``
``breakdown``, and ``checks`` last.  Exits non-zero, printing no
result, without enough CUDA cards, and when a module of JAX or of the
JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def _err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(REPO))
    from benchmark import harness
    try:
        bench, cell, cfg, traffic = harness.load_cell(args.workload)
    except KeyError:
        _err(f"unknown workload {args.workload!r}")
        return 2

    # every kernel cache of the run at a fixed place in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(HERE / ".cache" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(HERE / ".cache" / "torch_extensions"))
    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _err(f"this cell needs {chips} CUDA card(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
             " found")
        return 3

    setup = harness.Setup(T0)
    import lightgbm_tpu_torch as lt
    setup.mark("import")
    import importlib
    runner = importlib.import_module(f"benchmark.runners.{traffic['runner']}")
    torch.cuda.reset_peak_memory_stats()
    res = runner.run(lt, cell, cfg, traffic, args.seed, args.seconds,
                     bool(args.trace), "cuda", setup, log=_err)

    device = harness.device_line(torch, chips, res["memory_peak"],
                                 res["trace"] if args.trace else None)
    return report(bench, cell, res, device, bool(args.trace))


def report(bench: dict, cell: dict, res: dict, device: dict,
           trace: bool) -> int:
    """Print the run's result from the runner's ``res``: the per-layer
    readers run here, so the import guard comes last, after every module
    the run loads; a forbidden module ends the run with no result."""
    from benchmark import harness
    correct, checks = harness.verdict(res["numbers"],
                                      harness.load_limits(cell["name"]))
    from benchmark.cost import peaks
    _err(f"card: {peaks.power_limit()}")
    _err(f"window: {res['window_s']:.6f} s, attempted {res['attempted']}, "
         f"failed {res['failed']}")
    if trace:
        metrics = harness.per_layer(bench, cell, res["ctx"])
    else:
        metrics = {m["name"]: {"value": res["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in bench["end_to_end"]
                   if cell["name"] in m.get("workloads", [cell["name"]])}
    out = {"correct": bool(correct), "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics, "device": device}
    if trace and res["trace"] is not None:
        out["breakdown"] = {
            "device_ops": [[k, v] for k, v in res["trace"]["device_ops"]],
            "idle_gaps": [[k, v] for k, v in res["trace"]["idle_gaps"][:10]]}
    out["checks"] = checks
    line = json.dumps(out)
    bad = harness.forbidden_modules()
    if bad:
        _err(f"forbidden modules were loaded: {bad}")
        return 4
    for name, c in checks.items():
        _err(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    sys.stdout.flush()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
