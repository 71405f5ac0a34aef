"""The port's causal tracer (lightgbm_tpu_torch/obs/tracing.py), its
span sites and its readers against the JAX package, on the CPU.

- The same begin/end/link/span script through both packages' ``Tracer``
  gives equal event lists apart from ``ts``, ``dur``, ``pid``, ``tid``.
- A disarmed tracer is inert; ``configure`` is authoritative and the
  environment variable wins; spans end and link across threads; the
  ring buffer evicts the oldest events.
- A 4-round training exports 4 ``GBDT::iteration`` roots, and its
  trace equals the JAX run's on the same data once the span ids are
  renumbered in order of first appearance (the ids come from a
  process-wide counter).
- Each package's ``span_trees``, ``critical_path`` and
  ``summarize_traces`` read the other's export as its own.
- Serving: the micro-batcher's coalesce edges, a shed request's queue
  span, an HTTP round trip whose critical path is request -> queue ->
  batch -> ``Predict::forest``, the fleet's ``Serve::dispatch`` and
  ``Serve::hedge`` around a poisoned replica, the lifecycle's
  ``Serve::verdict`` and ``Serve::shadow``: the same span trees as the
  JAX package's for the same script.
- Every span name in the port is in its ``HOST_PHASES``, which equals
  the JAX package's.
"""

import ast
import json
import pathlib
import threading
import time

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu import obs as jobs
from lightgbm_tpu import serve as jserve
from lightgbm_tpu.obs import phases as jphases
from lightgbm_tpu.obs import tracing as jtracing
from lightgbm_tpu.serve import lifecycle as jlife
from lightgbm_tpu.testing import faults as jfaults

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import obs, serve
from lightgbm_tpu_torch.obs import phases, tracing
from lightgbm_tpu_torch.serve import lifecycle
from lightgbm_tpu_torch.serve.batcher import MicroBatcher
from lightgbm_tpu_torch.serve.server import serve_from_config
from lightgbm_tpu_torch.testing import faults

from test_torch_fleet import (base_url, post, serve_config, stub_fleet,
                              train_and_save)
from test_torch_lifecycle import _controller_script
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch

REPO = pathlib.Path(__file__).resolve().parent.parent
TRACERS = (("jax", jtracing), ("torch", tracing))
IDS = ("span_id", "trace_id", "parent_id", "member_span_ids",
       "member_trace_ids")
TRAIN = {"objective": "binary", "num_leaves": 15, "verbose": -1,
         "min_data_in_leaf": 20, "bagging_fraction": 0.8,
         "bagging_freq": 1}


def _disarm():
    for _, mod in TRACERS:
        mod.TRACER.disable()
        mod.TRACER.reset()
        mod.TRACER.path = None


@pytest.fixture
def armed(tmp_path, monkeypatch):
    """Both packages' process tracers armed on their own paths (the
    environment variable unset: it would arm both)."""
    monkeypatch.delenv(tracing.ENV_PATH, raising=False)
    paths = {}
    for name, mod in TRACERS:
        mod.TRACER.reset()
        paths[name] = tmp_path / f"{name}_trace.json"
        assert mod.TRACER.configure(str(paths[name]))
    yield paths
    _disarm()


def _strip(events):
    return [{k: v for k, v in e.items()
             if k not in ("ts", "dur", "pid", "tid")} for e in events]


def renumbered(events):
    """The events without timing fields, span and flow ids renumbered
    in order of first appearance and trace ids after them."""
    ids, tids = {}, {}

    def num(i):
        return ids.setdefault(int(i), len(ids) + 1)

    def tnum(t):
        return tids.setdefault(str(t), f"t{len(tids) + 1}")

    out = []
    for e in _strip(events):
        if e.get("ph") == "X":
            a = dict(e["args"])
            a["span_id"] = num(a["span_id"])
            a["trace_id"] = tnum(a["trace_id"])
            if "parent_id" in a:
                a["parent_id"] = num(a["parent_id"])
            if "member_span_ids" in a:
                a["member_span_ids"] = [num(m) for m in
                                        a["member_span_ids"]]
                a["member_trace_ids"] = [tnum(t) for t in
                                         a["member_trace_ids"]]
            e["args"] = a
        elif "id" in e:
            e["id"] = str(num(e["id"]))
        out.append(e)
    return out


def canonical(events):
    """Each root's span tree as sorted JSON: names, args without ids,
    children in any order, and the name of the span a member coalesced
    into (thread interleavings order the events differently run to
    run)."""
    tree = tracing.span_trees(events)

    def node(sid):
        e = tree["spans"][sid]
        args = {k: v for k, v in e["args"].items() if k not in IDS}
        kids = sorted(node(k) for k in tree["children"].get(sid, []))
        hop = tree["coalesced_into"].get(sid)
        return json.dumps([e["name"], args, kids,
                           tree["spans"][hop]["name"] if hop else None],
                          sort_keys=True)

    return sorted(node(r) for r in tree["roots"])


def _script(mod, max_events=200_000):
    """One begin/end/link/span sequence through a fresh Tracer of
    ``mod``: nested spans, a span ended in another thread, a coalesce
    link, end args."""
    t = mod.Tracer(max_events=max_events)
    t.configure("unused.json")
    with t.span("Serve::request", args={"request_id": 7}) as req:
        q = t.begin("Serve::queue", args={"rows": 3})
        q2 = t.begin("Serve::queue", parent=req, args={"rows": 1})

        def worker():
            with t.span("Serve::batch") as b:
                t.link(q, b)
                t.link(q2, b)
                t.end(q)
                t.end(q2, args={"shed": False})
                with t.span("Predict::forest", args={"rows": 4}):
                    pass
        th = threading.Thread(target=worker)
        th.start()
        th.join(10)
    with t.span("GBDT::iteration") as it:
        with t.span("Comm::grow", parent=it):
            pass
    return t


# ---------------------------------------------------------------------------
# the tracer


def test_tracer_event_lists_equal_jax():
    jt, tt = _script(jtracing), _script(tracing)
    assert _strip(tt.events()) == _strip(jt.events())
    assert len(tt.events()) == 11          # 7 spans, 2 flow pairs
    # the same script into a 5-event ring buffer: the same survivors
    jt, tt = _script(jtracing, 5), _script(tracing, 5)
    assert _strip(tt.events()) == _strip(jt.events())
    assert tt._dropped == jt._dropped == 6


def test_disarmed_tracer_is_inert(monkeypatch):
    monkeypatch.delenv(tracing.ENV_PATH, raising=False)
    _disarm()
    assert not obs.TRACER.enabled
    with obs.trace_span("GBDT::iteration") as h:
        assert h is None
    assert obs.trace_begin("Serve::queue") is None
    obs.trace_end(None)
    obs.trace_link(None, None)
    with obs.span("GBDT::iteration") as sp:
        assert sp.trace is None
    assert obs.TRACER.events() == [] and obs.TRACER.maybe_export() is None


def test_configure_is_authoritative_and_env_wins(tmp_path, monkeypatch):
    monkeypatch.delenv(tracing.ENV_PATH, raising=False)
    t = tracing.Tracer()
    assert t.configure(str(tmp_path / "a.json")) is True
    assert t.path == str(tmp_path / "a.json")
    assert t.configure(None) is False and not t.enabled
    monkeypatch.setenv(tracing.ENV_PATH, str(tmp_path / "env.json"))
    assert t.configure(str(tmp_path / "b.json")) is True
    assert t.path == str(tmp_path / "env.json")
    assert t.configure(None) is True


def test_cross_thread_end_link_and_eviction(armed):
    q = obs.trace_begin("Serve::queue")

    def worker():
        with obs.trace_span("Serve::batch") as b:
            obs.trace_link(q, b)
            obs.trace_end(q)

    th = threading.Thread(target=worker)
    th.start()
    th.join(10)
    tree = tracing.span_trees(obs.TRACER.events())
    batch, = [s for s, e in tree["spans"].items()
              if e["name"] == "Serve::batch"]
    queue, = [s for s, e in tree["spans"].items()
              if e["name"] == "Serve::queue"]
    assert tree["coalesced_into"][queue] == batch
    assert tree["spans"][batch]["args"]["member_trace_ids"] == \
        [tree["spans"][queue]["args"]["trace_id"]]
    # the ring buffer keeps the newest events and the export says so
    t = tracing.Tracer(max_events=3)
    t.configure(str(armed["torch"]))
    for i in range(5):
        with t.span("GBDT::iteration", args={"i": i}):
            pass
    assert [e["args"]["i"] for e in t.events()] == [2, 3, 4]
    doc = json.loads(pathlib.Path(t.export()).read_text())
    assert doc["otherData"] == {"dropped_oldest_events": 2}


# ---------------------------------------------------------------------------
# training


def _data(n=1500, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 6))
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.normal(size=n) > 0)
    return X, y.astype(np.float64)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """4 rounds in each package with ``trace_events_file``: the
    exported files."""
    out = tmp_path_factory.mktemp("traces")
    X, y = _data()
    paths = {}
    for name, pkg, kw in (("jax", lgb, {}),
                          ("torch", lt, {"device": "cpu"})):
        paths[name] = str(out / f"{name}.json")
        pkg.train({**TRAIN, "trace_events_file": paths[name]},
                  pkg.Dataset(X, y), 4, verbose_eval=False, **kw)
    _disarm()
    return paths


def test_training_rounds_are_traces_like_jax(trained):
    events = tracing.read_trace(trained["torch"])
    tree = tracing.span_trees(events)
    iters = [s for s, e in tree["spans"].items()
             if e["name"] == "GBDT::iteration"]
    assert len(iters) == 4 and all(s in tree["roots"] for s in iters)
    assert len({tree["spans"][s]["args"]["trace_id"]
                for s in iters}) == 4
    # the export cleared the buffer: one export a run
    assert obs.TRACER.events() == []
    jax_events = jtracing.read_trace(trained["jax"])
    assert renumbered(events) == renumbered(jax_events)
    assert [e["name"] for e in events] == \
        ["Bin::bundle"] + ["GBDT::iteration"] * 4


def test_each_reader_reads_the_others_export(trained):
    scripts = {name: str(pathlib.Path(trained[name]).with_name(
        f"script_{name}.json")) for name, _ in TRACERS}
    for name, mod in TRACERS:
        _script(mod).export(scripts[name])
    for src in ("jax", "torch"):
        files = [trained[src], scripts[src]]
        for path in files:
            ev_j, ev_t = (jtracing.read_trace(path),
                          tracing.read_trace(path))
            assert ev_t == ev_j
            tj, tt = jtracing.span_trees(ev_j), tracing.span_trees(ev_t)
            assert tt == tj
            for root in tj["roots"]:
                assert tracing.critical_path(tt, root) == \
                    jtracing.critical_path(tj, root)
        assert tracing.summarize_traces(files, top_k=3) == \
            jtracing.summarize_traces(files, top_k=3)
    rep = tracing.summarize_traces([trained["torch"]], top_k=2)
    assert rep["roots"]["GBDT::iteration"]["count"] == 4
    assert rep["slowest"][0]["critical_path"][0]["name"] in (
        "GBDT::iteration", "Bin::bundle")


# ---------------------------------------------------------------------------
# serving


def test_microbatcher_coalesce_edges(armed):
    release = threading.Event()
    mb = MicroBatcher(lambda rows: np.zeros((1, rows.shape[0]),
                                            np.float32),
                      max_batch=64, max_delay_s=0.15)
    results = []

    def client(i):
        with obs.trace_span("Serve::request", args={"request_id": i}):
            release.wait(5.0)
            results.append(mb.submit(np.ones((2, 3), np.float32)))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.02)
    release.set()
    for t in threads:
        t.join(10)
    mb.close()
    assert len(results) == 3
    tree = tracing.span_trees(obs.TRACER.events())
    spans = tree["spans"]
    reqs = {s for s, e in spans.items() if e["name"] == "Serve::request"}
    queues = {s for s, e in spans.items() if e["name"] == "Serve::queue"}
    batches = {s for s, e in spans.items() if e["name"] == "Serve::batch"}
    assert len(reqs) == len(queues) == 3
    for q in queues:
        parent = spans[q]["args"]["parent_id"]
        assert parent in reqs
        assert spans[q]["args"]["trace_id"] == \
            spans[parent]["args"]["trace_id"]
        assert tree["coalesced_into"][q] in batches
    assert sum(spans[b]["args"]["coalesced"] for b in batches) == 3
    members = set()
    for b in batches:
        assert len(spans[b]["args"]["member_span_ids"]) == \
            spans[b]["args"]["coalesced"]
        members.update(spans[b]["args"]["member_trace_ids"])
    assert members == {spans[r]["args"]["trace_id"] for r in reqs}
    forests = [e for e in spans.values() if e["name"] == "Predict::forest"]
    assert forests and all(e["args"]["parent_id"] in batches
                           for e in forests)


def test_shed_request_closes_its_queue_span(armed):
    gate = threading.Event()

    def slow(rows):
        gate.wait(3.0)
        return np.zeros((1, rows.shape[0]), np.float32)

    mb = MicroBatcher(slow, max_batch=2, max_delay_s=2.0)
    t1 = threading.Thread(
        target=lambda: mb.submit(np.ones((2, 2), np.float32), timeout=5.0))
    t1.start()
    time.sleep(0.05)
    with pytest.raises(TimeoutError):
        mb.submit(np.ones((1, 2), np.float32), timeout=0.05)
    gate.set()
    t1.join(10)
    mb.close()
    queues = [e for e in obs.TRACER.events()
              if e.get("ph") == "X" and e["name"] == "Serve::queue"]
    assert [e["args"].get("shed") for e in queues].count(True) == 1
    # a closed batcher's submit ends its span as closed
    with pytest.raises(RuntimeError):
        mb.submit(np.ones((1, 2), np.float32))
    assert obs.TRACER.events()[-1]["args"]["closed"] is True


def test_http_round_trip_critical_path(tmp_path, monkeypatch):
    """A JAX-trained model served by the port with trace_events_file:
    every request's critical path runs request -> queue -> batch ->
    Predict::forest, and stop() writes the export."""
    monkeypatch.delenv(tracing.ENV_PATH, raising=False)
    path, X = train_and_save(tmp_path, "m.txt", 3)
    trace = tmp_path / "serve_trace.json"
    srv = serve_from_config(serve_config(
        f"input_model={path}", f"trace_events_file={trace}",
        "serve_max_delay_ms=30")).start()
    assert srv._ready.wait(60.0)    # the background warm
    base = base_url(srv)
    try:
        def call():
            r, headers = post(base, "/predict", {"rows": X[:3].tolist()})
            assert r["num_rows"] == 3 and headers.get("X-Request-Id")

        threads = [threading.Thread(target=call) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        srv.stop()
        _disarm()
    tree = tracing.span_trees(tracing.read_trace(str(trace)))
    reqs = [s for s, e in tree["spans"].items()
            if e["name"] == "Serve::request"]
    assert len(reqs) == 2
    for r in reqs:
        args = tree["spans"][r]["args"]
        assert args["request_id"] and args["status"] == 200
        kids = {tree["spans"][k]["name"] for k in tree["children"][r]}
        assert kids == {"Serve::dispatch", "Serve::queue"}
        names = [s["name"] for s in tracing.critical_path(tree, r)]
        assert names[0] == "Serve::request"
        assert names[-3:] == ["Serve::queue", "Serve::batch",
                              "Predict::forest"]


def _hedged(pkg, reg, fault_mod):
    fleet = stub_fleet(pkg, [0.0, 0.0])
    try:
        with fault_mod.poison_predict(fleet, 0):
            with reg.trace_span("Serve::request", args={"request_id": 1}):
                out = fleet.submit(np.ones((2, 4), np.float32),
                                   timeout=10.0)
    finally:
        fleet.close()
    return out


def test_fleet_dispatch_and_hedge_spans_like_jax(armed):
    got = {}
    for name, pkg, reg, fault_mod in (("jax", jserve, jobs, jfaults),
                                      ("torch", serve, obs, faults)):
        res = _hedged(pkg, reg, fault_mod)
        assert res.replica == 1
        mod = dict(TRACERS)[name]
        got[name] = canonical(mod.TRACER.events())
    assert got["torch"] == got["jax"]
    tree = tracing.span_trees(obs.TRACER.events())
    names = sorted(e["name"] for e in tree["spans"].values())
    assert names.count("Serve::hedge") == 1
    assert names.count("Serve::dispatch") == 2
    hedge, = [e for e in tree["spans"].values()
              if e["name"] == "Serve::hedge"]
    assert hedge["args"]["attempt"] == 1
    assert hedge["args"]["failed_replica"] == 0


def test_lifecycle_verdict_and_shadow_spans_like_jax(armed, tmp_path,
                                                     monkeypatch):
    verdicts = {}
    for name, pkg, reg, life in (("jax", jserve, jobs, jlife),
                                 ("torch", serve, obs, lifecycle)):
        trail = _controller_script(pkg, reg, life, tmp_path, monkeypatch)
        monkeypatch.undo()
        monkeypatch.delenv(tracing.ENV_PATH, raising=False)
        mod = dict(TRACERS)[name]
        verdicts[name] = [
            {k: v for k, v in e["args"].items() if k not in IDS}
            for e in mod.TRACER.events()
            if e.get("ph") == "X" and e["name"] == "Serve::verdict"]
        assert len(verdicts[name]) == 4
        assert trail[1][6] == "promote"
        mod.TRACER.reset()
    assert verdicts["torch"] == verdicts["jax"]
    assert verdicts["torch"][0] == {"outcome": "promote",
                                    "candidate": "c1.txt"}
    shadows = {}
    for name, pkg, reg, life in (("jax", jserve, jobs, jlife),
                                 ("torch", serve, obs, lifecycle)):
        reg.reset()
        fleet = stub_fleet(pkg, [0.0], canary_times=[0.0])
        sc = life.ShadowScorer(fleet, fraction=1.0, queue_max=4)
        try:
            assert sc.offer(np.ones((3, 4), np.float32))
            deadline = time.monotonic() + 10
            while reg.get_counter("lifecycle_shadow_total") < 1 \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            sc.close()
            fleet.close()
        shadows[name] = canonical(dict(TRACERS)[name].TRACER.events())
    assert shadows["torch"] == shadows["jax"]
    assert any('"Serve::shadow"' in root for root in shadows["torch"])


# ---------------------------------------------------------------------------
# the taxonomy


def _span_names(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("span", "trace_span", "trace_begin",
                                       "timed")
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "obs" and node.args
                and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_every_span_name_is_a_host_phase_like_jax():
    assert phases.HOST_PHASES == jphases.HOST_PHASES
    assert phases.DEVICE_PHASES == jphases.DEVICE_PHASES
    assert phases.DEVICE_PARENT == jphases.DEVICE_PARENT
    assert phases.TRANSFER_PHASES == jphases.TRANSFER_PHASES
    names = set()
    for path in sorted((REPO / "lightgbm_tpu_torch").rglob("*.py")):
        for name in _span_names(path):
            assert name in phases.HOST_PHASES, (path, name)
            names.add(name)
    assert {"GBDT::iteration", "Bin::bundle", "Comm::grow",
            "Dist::consistency", "Serve::request", "Serve::queue",
            "Serve::batch", "Predict::forest", "Serve::dispatch",
            "Serve::hedge", "Serve::verdict", "Serve::shadow",
            "Serve::reload", "Serve::drain", "Serve::eject",
            "Serve::probe"} <= names
    series = [phases.span_series(n) for n in phases.HOST_PHASES]
    assert len(set(series)) == len(series)
    assert all(s == jphases.span_series(n)
               for n, s in zip(phases.HOST_PHASES, series))
