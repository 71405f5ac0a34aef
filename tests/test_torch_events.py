"""The port's per-iteration event stream (lightgbm_tpu_torch/obs/events.py,
``events_file``), its producers in ``GBDT.train_one_iter`` and
``callback.log_telemetry``, and ``Booster.telemetry()``, against the
JAX package on the CPU.

- ``train`` with ``events_file`` on the same bagged binary data in both
  packages: the records are equal in ``iter``, ``trees``, ``bag_cnt``,
  ``comm_*``, ``phases``, ``saturated`` and ``discarded``; ``eval``
  within 1e-6 relative (the two packages' f32 scores differ in the last
  bits, ~1e-7 relative in the metrics).
- A saturating run records ``saturated`` at the round JAX records it.
  The JAX booster pipelines its rounds and dispatches one more round
  after the saturated one, which it records as ``discarded``; the
  port's rounds are synchronous and dispatch none, so its stream equals
  the JAX stream with pipelining off.
- The writer: commit on advance, ``events_flush_every`` (>= 1), records
  committed before a kill are on disk, a full disk disables the sink
  with one warning and a ``sink_write_errors_total`` count while the
  run trains on to the same model.
- Two gloo ranks write ``.rank0`` / ``.rank1`` streams with ``rank``.
- The stream adds no host read: the registry's ``grower_host_reads`` per
  tree is the same with ``events_file`` as without, for the ordered and
  fused growers.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.models.gbdt import GBDT as JaxGBDT
from lightgbm_tpu.obs import events as jevents

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.obs import events, prom
from lightgbm_tpu_torch.parallel.launch import machine_list, run_ranks
from lightgbm_tpu_torch.testing import faults
from lightgbm_tpu_torch.utils import diskguard, log

from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch

REPO = pathlib.Path(__file__).resolve().parent.parent
WORKER = str(REPO / "tests" / "torch_parallel_worker.py")
EVAL_RTOL = 1e-6
EXACT = ("schema", "iter", "trees", "bag_cnt", "comm_bytes_cum",
         "comm_calls_cum", "phases", "saturated", "discarded",
         "nan_poisoned", "nan_policy", "rank")
BAGGED = {"objective": "binary", "num_leaves": 15, "verbose": -1,
          "min_data_in_leaf": 20, "bagging_fraction": 0.8,
          "bagging_freq": 1, "metric": "binary_logloss,auc"}
SATURATING = {"objective": "binary", "num_leaves": 7, "verbose": -1,
              "min_data_in_leaf": 20, "learning_rate": 1.0,
              "min_gain_to_split": 1.0}


@pytest.fixture(autouse=True)
def _fresh_sinks(monkeypatch):
    # warnings print whatever verbosity an earlier CLI run in this
    # process left behind
    monkeypatch.setattr(log, "_current_level", 1)
    diskguard.reset_disabled()
    log.reset_warn_once()
    yield
    diskguard.reset_disabled()


def _data(n=1500, f=6, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f))
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.normal(size=n) > 0)
    return X, y.astype(np.float64)


def _run(pkg, params, X, y, rounds, path, valid=True, **kw):
    if pkg is lt:
        kw["device"] = "cpu"
    ds = pkg.Dataset(X, y)
    vs = [pkg.Dataset(X[:500], y[:500], reference=ds)] if valid else None
    return pkg.train({**params, "events_file": str(path)}, ds, rounds,
                     valid_sets=vs, verbose_eval=False, **kw)


def assert_streams_equal(got, want):
    assert [r["iter"] for r in got] == [r["iter"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in EXACT:
            assert g.get(key) == w.get(key), (g["iter"], key)
        assert g["wall_s"] > 0
        for ds, metrics in w.get("eval", {}).items():
            assert g["eval"][ds].keys() == metrics.keys()
            for name, v in metrics.items():
                assert abs(g["eval"][ds][name] - v) <= EVAL_RTOL * abs(v)


# ---------------------------------------------------------------------------
# the stream against the JAX package's


def test_event_stream_matches_jax(tmp_path):
    X, y = _data()
    for name, pkg in (("jax", lgb), ("torch", lt)):
        _run(pkg, BAGGED, X, y, 8, tmp_path / f"{name}.jsonl")
    want = jevents.read_events(str(tmp_path / "jax.jsonl"))
    got = events.read_events(str(tmp_path / "torch.jsonl"))
    assert len(got) == 8
    assert_streams_equal(got, want)
    assert {r["bag_cnt"] for r in got} == {1200}
    assert all(r["trees"][0]["num_leaves"] == 15 for r in got)
    assert all(set(r["eval"]["valid_0"]) == {"binary_logloss", "auc"}
               for r in got)


def test_saturating_run_records_saturated_like_jax(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    X = rng.normal(size=(400, 3))
    y = (X[:, 0] > 0).astype(np.float64)
    _run(lgb, SATURATING, X, y, 10, tmp_path / "jax.jsonl")
    monkeypatch.setattr(JaxGBDT, "_pipeline", False)
    _run(lgb, SATURATING, X, y, 10, tmp_path / "jax_sync.jsonl")
    monkeypatch.undo()
    b = _run(lt, SATURATING, X, y, 10, tmp_path / "torch.jsonl")
    got = events.read_events(str(tmp_path / "torch.jsonl"))
    pipelined = jevents.read_events(str(tmp_path / "jax.jsonl"))
    synchronous = jevents.read_events(str(tmp_path / "jax_sync.jsonl"))
    assert b.num_trees() == 2 and len(got) == 3
    assert got[-1]["saturated"] is True
    assert got[-1]["trees"] == [{"num_leaves": 1, "max_depth": 0}]
    assert_streams_equal(got, synchronous)
    assert_streams_equal(got, pipelined[:3])
    assert pipelined[3]["discarded"] is True and pipelined[3]["trees"] == []
    assert not any(r.get("discarded") for r in got)


# ---------------------------------------------------------------------------
# the writer


def _note_script(mod, path, flush_every):
    rec = mod.EventRecorder(str(path), flush_every=flush_every)
    on_disk = []
    for it in range(5):
        rec.note(it, wall_s=0.5 * it, bag_cnt=it)
        rec.note(it, eval={"train": {"l2": float(it)}})
        rec.note(it, eval={"v": {"l1": float("nan")}})
        on_disk.append(len(path.read_text().splitlines()))
    rec.close()
    rec.close()
    return on_disk, path.read_text(), rec.events_written


@pytest.mark.parametrize("flush_every", [1, 3])
def test_recorder_commits_on_advance_like_jax(tmp_path, flush_every):
    want = _note_script(jevents, tmp_path / "jax.jsonl", flush_every)
    got = _note_script(events, tmp_path / "torch.jsonl", flush_every)
    assert got == want
    on_disk, text, written = got
    # record i is written when i + 1 is first noted; a batch of
    # flush_every reaches the file at once
    assert on_disk == ([0, 1, 2, 3, 4] if flush_every == 1
                       else [0, 0, 0, 3, 3])
    assert written == 5
    # dict fields merge key by key; a non-finite value is written null
    first = json.loads(text.splitlines()[0])
    assert first == {"schema": 1, "iter": 0, "wall_s": 0.0, "bag_cnt": 0,
                     "eval": {"train": {"l2": 0.0}, "v": {"l1": None}}}


def test_events_flush_every_must_be_at_least_one(tmp_path):
    msgs = []
    for cfg in (JaxConfig, Config):
        with pytest.raises(ValueError) as ei:
            cfg({"events_flush_every": 0})
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert Config({"events_flush_every": "4"}).events_flush_every == 4
    X, y = _data(n=300)
    with pytest.raises(ValueError, match="events_flush_every"):
        _run(lt, {**BAGGED, "events_flush_every": 0}, X, y, 2,
             tmp_path / "ev.jsonl")


KILLED = r"""
import os, sys
sys.path.insert(0, {repo!r})
from lightgbm_tpu_torch.obs import EventRecorder
rec = EventRecorder({path!r})
for it in range(6):
    rec.note(it, wall_s=0.1 * it)
os._exit(3)
"""


def test_records_committed_before_a_kill_are_on_disk(tmp_path):
    path = tmp_path / "ev.jsonl"
    proc = subprocess.run(
        [sys.executable, "-c", KILLED.format(repo=str(REPO),
                                             path=str(path))],
        capture_output=True, text=True, timeout=60)
    assert proc.returncode == 3, proc.stderr
    got = events.read_events(str(path))
    assert [r["iter"] for r in got] == [0, 1, 2, 3, 4]


def test_full_disk_disables_the_sink_and_training_goes_on(tmp_path,
                                                           capsys):
    X, y = _data(n=400)
    clean = _run(lt, BAGGED, X, y, 6, tmp_path / "clean.jsonl")
    ev = tmp_path / "ev.jsonl"
    obs.reset()
    with faults.disk_full_after(600, str(ev)) as stats:
        b = _run(lt, BAGGED, X, y, 6, ev)
    assert b.num_trees() == 6
    assert b.model_to_string() == clean.model_to_string()
    assert stats["fired"] == 1
    assert obs.get_counter("sink_write_errors_total") == 1
    assert obs.get_counter("sink_write_errors_events") == 1
    assert capsys.readouterr().err.count("sink 'events'") == 1
    got = events.read_events(str(ev))
    assert 1 <= len(got) < 6
    assert [r["iter"] for r in got] == list(range(len(got)))


def test_two_gloo_ranks_write_one_stream_each(tmp_path):
    X, y = _data(n=600, f=8, seed=7)
    np.savez(tmp_path / "xy.npz", X=X, y=y.astype(np.float32))
    ev = tmp_path / "ev.jsonl"
    jobs = {"world": 2, "out": str(tmp_path),
            "mlist": machine_list(str(tmp_path / "mlist.txt"), 2),
            "train": [dict(name="train", data=str(tmp_path / "xy.npz"),
                           rounds=3, params={
                               "objective": "binary", "num_leaves": 7,
                               "verbose": -1, "tree_learner": "data",
                               "num_machines": 2,
                               "events_file": str(ev)})]}
    (tmp_path / "jobs.json").write_text(json.dumps(jobs))
    codes, outs = run_ranks([[sys.executable, WORKER,
                              str(tmp_path / "jobs.json")]] * 2,
                            timeout=60)
    assert codes == [0, 0], outs[0][-3000:]
    assert not ev.exists()
    streams = [events.read_events(str(tmp_path / f"ev.rank{r}.jsonl"))
               for r in range(2)]
    for r, recs in enumerate(streams):
        assert [e["iter"] for e in recs] == [0, 1, 2]
        assert {e["rank"] for e in recs} == {r}
        cum = [e["comm_bytes_cum"] for e in recs]
        assert cum[0] > 0 and cum == sorted(cum)
    strip = [[{k: v for k, v in e.items() if k not in ("rank", "wall_s")}
              for e in recs] for recs in streams]
    assert strip[0] == strip[1]


@pytest.mark.parametrize("grower", ["ordered", "fused"])
def test_host_reads_per_tree_unchanged_by_the_stream(tmp_path, grower):
    X, y = _data(n=800)
    params = {**BAGGED, "serial_grow": grower}
    reads = []
    for events_file in (None, tmp_path / "ev.jsonl"):
        reads0 = obs.get_counter("grower_host_reads")
        ds = lt.Dataset(X, y)
        b = lt.train({**params, **({"events_file": str(events_file)}
                                   if events_file else {})},
                     ds, 4, device="cpu", verbose_eval=False)
        reads.append((obs.get_counter("grower_host_reads") - reads0)
                     / b.num_trees())
    assert reads[0] == reads[1] > 0
    if grower == "fused":
        assert reads[0] == 1
    assert len(events.read_events(str(tmp_path / "ev.jsonl"))) == 4
    # operators read the counter on /metrics
    parsed = prom.parse_text(prom.render(obs.snapshot()))
    assert parsed["types"]["lightgbm_tpu_grower_host_reads"] == "counter"
    assert ("lightgbm_tpu_grower_host_reads", {},
            float(obs.get_counter("grower_host_reads"))) in parsed["samples"]


def test_telemetry_keys_like_jax(tmp_path):
    X, y = _data(n=400)
    snaps = {}
    for name, pkg in (("jax", lgb), ("torch", lt)):
        b = _run(pkg, BAGGED, X, y, 3, tmp_path / f"{name}.jsonl")
        snaps[name] = b.telemetry()
    assert set(snaps["torch"]) == set(snaps["jax"])
    assert snaps["torch"]["comm"] == snaps["jax"]["comm"] == \
        {"bytes_cum": 0, "calls_cum": 0, "per_tree": None}
    assert snaps["torch"]["histograms"][
        "phase_seconds_gbdt_iteration"]["count"] >= 3
    clf = lt.LGBMClassifier(n_estimators=3, num_leaves=7, device="cpu")
    clf.fit(X, y)
    tel = clf.telemetry_
    assert set(tel) == set(snaps["jax"]) and tel["comm"]["bytes_cum"] == 0
