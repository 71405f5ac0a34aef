"""The port's compile ledger (lightgbm_tpu_torch/obs/compile_ledger.py):
one event an nvcc build of ``ops/_build.py``, in the JAX ledger's
schema, held against the JAX package's readers on the CPU.

There is no ``nvcc`` here: a fake one on ``CUDA_HOME/bin`` (a script
that writes its ``-o`` file) stands in, with ``_build.BUILD_DIR`` in a
temporary directory, so the real ``_start`` / ``_finish`` path runs.
"""

import json
import os
import stat

import pytest

from lightgbm_tpu.obs import compile_ledger as jledger
from lightgbm_tpu.obs import report as jreport

from lightgbm_tpu_torch import cli
from lightgbm_tpu_torch.obs import compile_ledger, registry
from lightgbm_tpu_torch.ops import _build

JAX_KEYS = {"program", "shapes", "seconds", "t", "count", "flops",
            "bytes_accessed", "output_bytes"}

FAKE_NVCC = """#!/bin/sh
# writes the file after -o, like nvcc's -shared build
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  shift
done
sleep 0.05
echo "ptxas info    : Used 16 registers"
printf 'fake' > "$out"
"""


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """A fake nvcc first in line and an empty build directory; the
    ledger's sink at ``tmp_path / 'ledger.jsonl'`` through the env."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    ledger = tmp_path / "ledger.jsonl"
    monkeypatch.setenv(compile_ledger.ENV_PATH, str(ledger))
    compile_ledger.configure(None)
    yield ledger
    monkeypatch.delenv(compile_ledger.ENV_PATH)
    compile_ledger.configure(None)


def test_one_line_a_build_none_on_a_cached_load(fake_build):
    c0 = registry.get_counter("compile_count")
    n0 = compile_ledger.recorded()
    secs = _build.build_all(("roll_chain", "leaf_hist"))
    assert set(secs) == {"roll_chain", "leaf_hist"}
    assert all(s >= 0.05 for s in secs.values())
    rows = compile_ledger.read_ledger(str(fake_build))
    assert [r["program"] for r in sorted(rows, key=lambda r: r["program"])] \
        == ["leaf_hist", "roll_chain"]
    for r in rows:
        assert set(r) == JAX_KEYS
        arch, digest = r["shapes"].split(",")
        assert arch == "sm_90a" and len(digest) == 16
        assert r["flops"] is None and r["bytes_accessed"] is None
        assert r["seconds"] == pytest.approx(secs[r["program"]], abs=1e-5)
    assert registry.get_counter("compile_count") == c0 + 2
    assert registry.get_counter("compile_count_leaf_hist") >= 1
    assert compile_ledger.recorded() == n0 + 2
    # current libraries: no nvcc, no event
    assert _build.build_all(("roll_chain", "leaf_hist")) == \
        {"roll_chain": 0.0, "leaf_hist": 0.0}
    assert len(compile_ledger.read_ledger(str(fake_build))) == 2
    assert compile_ledger.recorded() == n0 + 2


def test_both_readers_and_reports_agree(fake_build, tmp_path, capsys):
    _build.build_all(("window_hist",))
    with open(fake_build, "a") as fh:
        fh.write('{"program": "torn", "sha')      # a crashed run's tail
    assert compile_ledger.read_ledger(str(fake_build)) == \
        jledger.read_ledger(str(fake_build))
    events = tmp_path / "events.jsonl"
    events.write_text(json.dumps({"iter": 0, "wall_s": 0.5}) + "\n")
    argv = [str(events), f"--compile={fake_build}"]
    outs = []
    for fmt in ("--format=json", "--format=table"):
        assert jreport.main(argv + [fmt]) == 0
        want = capsys.readouterr().out
        assert cli.main(["obs-report", *argv, fmt]) == 0
        got = capsys.readouterr().out
        assert got == want
        outs.append(got)
    section = json.loads(outs[0])["compile"]
    assert section["count"] == 1
    assert "window_hist" in outs[1]


def test_configure_precedence_matches_jax(tmp_path, monkeypatch):
    monkeypatch.delenv(compile_ledger.ENV_PATH, raising=False)
    try:
        for mod in (compile_ledger, jledger):
            assert mod.configure(None) is None
            assert mod.configure(str(tmp_path / "a")) == str(tmp_path / "a")
            monkeypatch.setenv(mod.ENV_PATH, str(tmp_path / "env"))
            assert mod.configure(str(tmp_path / "a")) == \
                str(tmp_path / "env")
            monkeypatch.delenv(mod.ENV_PATH)
            assert mod.configure(None) is None
    finally:
        compile_ledger.configure(None)
        jledger.configure(None)


def test_record_schema_and_summary_match_jax(monkeypatch):
    monkeypatch.setattr(jledger, "_path", None)
    monkeypatch.setattr(compile_ledger, "_path", None)
    got = compile_ledger.record("t_cl_prog", "sm_90a,abc", 1.25)
    want = jledger.record("t_cl_prog", "sm_90a,abc", 1.25)
    assert set(got) == set(want) == JAX_KEYS
    for k in ("program", "shapes", "seconds", "flops", "bytes_accessed",
              "output_bytes"):
        assert got[k] == want[k]
    summary = compile_ledger.summary(100)
    assert {"program": "t_cl_prog", "shapes": "sm_90a,abc",
            "seconds": 1.25} in summary["slowest"]
    assert set(summary) == set(jledger.summary())


def test_a_full_disk_degrades_the_ledger_to_memory(fake_build, monkeypatch):
    from lightgbm_tpu_torch.testing import faults
    from lightgbm_tpu_torch.utils import diskguard
    diskguard.reset_disabled()
    n0 = len(compile_ledger.events())
    with faults.fail_writes(28, path_glob=str(fake_build)):
        compile_ledger.record("t_cl_full", "sm_90a,x", 0.1)
    assert len(compile_ledger.events()) == n0 + 1
    assert not os.path.exists(fake_build) or \
        "t_cl_full" not in fake_build.read_text()
    diskguard.reset_disabled()
