"""The import guard: no module of JAX or of the JAX package is loaded by
the benchmark or by the port it drives, compared by whole top-level
names (``lightgbm_tpu_torch`` is not ``lightgbm_tpu``); and the harness
refuses to run without a card."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"


def test_forbidden_names_compare_whole(monkeypatch):
    mods = dict(sys.modules)
    mods.update({"lightgbm_tpu_torch.fake": object(), "jaxtyping": object(),
                 "lightgbm_tpu_torchx": object()})
    monkeypatch.setattr(sys, "modules", mods)
    assert harness.forbidden_modules() == []
    mods.update({"lightgbm_tpu.ops": object(), "jax": object(),
                 "flax.core": object()})
    assert harness.forbidden_modules() == ["flax.core", "jax",
                                           "lightgbm_tpu.ops"]


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in harness.FORBIDDEN, (path, n)


def test_the_run_loads_no_jax_module():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import lightgbm_tpu_torch\n"
        "from benchmark import harness, faults, tracing, calibrate\n"
        "from benchmark.runners import train, score\n"
        "from benchmark.reference.objectives import binary, lambdarank\n"
        "import benchmark.run\n"
        "print(harness.forbidden_modules())\n" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal is not reachable")


def test_run_refuses_without_a_card():
    _no_card()
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "mslr.train",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=str(REPO))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_run_refuses_in_a_checkout_without_the_program(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for p in json.loads((REPO / "BENCHMARK.json").read_text())["paths"]:
        shutil.copytree(REPO / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "higgs.score",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("module", ["jax", "lightgbm_tpu", None])
def test_a_reader_that_loads_a_forbidden_module_ends_the_run_unprinted(
        tmp_path, module):
    """The end of a traced run (``run.report``) in a copy of the benchmark
    whose one per-layer reader, a file a later change could add, imports
    a stand-in of ``module``: the guard comes after it and prints no
    result; a reader that imports nothing lets the result through."""
    for p in json.loads((REPO / "BENCHMARK.json").read_text())["paths"]:
        shutil.copytree(REPO / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["per_layer"] = [{
        "name": "stand_in_share", "unit": "%", "better": "higher",
        "source": "program_counter", "layer": "device",
        "moves": "score_rows_per_s", "workloads": ["higgs.score"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    body = f"    import {module}\n" if module else ""
    (tmp_path / "benchmark" / "metrics" / "stand_in_share.py").write_text(
        f"def read(ctx):\n{body}    return 1.5\n")
    stubs = tmp_path / "stubs"
    for name in ("jax", "lightgbm_tpu"):
        (stubs / name).mkdir(parents=True)
        (stubs / name / "__init__.py").write_text("")
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from benchmark import harness, run\n"
        "bench, cell, _, _ = harness.load_cell('higgs.score')\n"
        "res = {'numbers': {'calls_wrong_shape': 0.0, 'score_gap': 0.0},\n"
        "       'window_s': 1.0, 'attempted': 1, 'failed': 0, 'ctx': {},\n"
        "       'trace': None, 'e2e': {}}\n"
        "device = {'platform': 'gpu', 'kind': 'stand-in', 'count': 1,\n"
        "          'memory_peak_bytes': 1, 'busy_s': 0.5, 'window_s': 1.0}\n"
        "sys.exit(run.report(bench, cell, res, device, True))\n"
        % (str(stubs), str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(tmp_path))
    if module is None:
        assert out.returncode == 0, out.stderr[-2000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["metrics"] == {"stand_in_share": {"value": 1.5,
                                                      "unit": "%"}}
    else:
        assert out.returncode == 4, out.stderr[-2000:]
        assert out.stdout.strip() == ""
        assert module in out.stderr
