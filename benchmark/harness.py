"""What every runner shares: the set-up clock, the limits of a cell's
correctness numbers, the device line, the per-layer readers and the
import guard."""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional

HERE = Path(__file__).resolve().parent

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "lightgbm_tpu")


class Setup:
    """Set-up's parts, each printed on its own line of standard error as
    it ends; ``total`` is the time from the process's start."""

    def __init__(self, t0: float):
        self.t0 = t0
        self.last = t0
        self.parts: Dict[str, float] = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.parts[name] = now - self.last
        self.last = now
        print(f"setup {name}: {self.parts[name]:.6f} s", file=sys.stderr,
              flush=True)

    def total(self) -> float:
        return self.last - self.t0


def load_cell(name: str):
    """(BENCHMARK.json, the cell's entry, its configuration, its traffic
    mix) of the cell ``name``; KeyError for an unknown cell."""
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((HERE.parent / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    return bench, cell, cfg, traffic


def load_limits(cell: str) -> Dict[str, float]:
    return json.loads((HERE / "limits" / f"{cell}.json").read_text())["limits"]


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {value, limit}}): every number at or under its
    limit; a number that is missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and v == v and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks


def forbidden_modules():
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def per_layer(bench: dict, cell: dict, ctx: dict) -> Dict[str, dict]:
    """Each per-layer metric whose ``workloads`` list this cell (every
    per-layer entry lists its cells), read by its own reader
    ``metrics/<name>.py``; a reader that finds nothing is left out."""
    out = {}
    for m in bench["per_layer"]:
        if cell["name"] not in m["workloads"]:
            continue
        reader = load_file(HERE / "metrics" / f"{m['name']}.py",
                           "bench_metric_" + m["name"].replace(".", "_"))
        v = reader.read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def device_line(torch, count: int, memory_peak: int,
                trace: Optional[dict]) -> dict:
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": count, "memory_peak_bytes": int(memory_peak)}
    if trace is not None:
        dev["busy_s"] = trace["busy_s"]
        dev["window_s"] = trace["window_s"]
    return dev
