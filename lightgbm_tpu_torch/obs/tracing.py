"""Causal span trees exported as Chrome trace-event JSON.

The port's copy of the JAX package's obs/tracing.py.  ``obs.span``
histograms say how long each phase takes in aggregate; a span tree says
what one request or one boosting round spent its time on:

- every span gets a ``span_id`` and a ``trace_id``; a span opened while
  another is active in the same context becomes its child and inherits
  the trace id (a context variable), so one HTTP request, or one
  boosting round, is one trace;
- causality across threads is explicit: ``begin()`` takes a parent
  handle, and ``link(src, dst)`` records a many-to-one coalesce edge
  (``serve/batcher.py``: many request queue spans -> one device batch),
  written both as Chrome flow events (``ph: s/f``, which Perfetto draws)
  and as ``member_span_ids`` / ``member_trace_ids`` args on the
  destination span (what ``span_trees`` and ``obs-report --traces``
  read);
- ``export()`` writes ``{"traceEvents": [...]}`` (loadable in
  https://ui.perfetto.dev); ``read_trace`` / ``span_trees`` /
  ``critical_path`` / ``summarize_traces`` parse it back.  The file is
  the contract: each package's reader reads the other's export.

Off by default: ``TRACER.configure(path)`` (the ``trace_events_file``
key; ``LIGHTGBM_TPU_TRACE_EVENTS`` wins) arms it.  While disarmed every
entry point returns None after one attribute read.  No span
synchronizes the device: a span around an asynchronous launch measures
its dispatch.  Span names are ``obs/phases.py`` ``HOST_PHASES``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Dict, List, Mapping, Optional, Sequence

ENV_PATH = "LIGHTGBM_TPU_TRACE_EVENTS"

_current: ContextVar[Optional["SpanHandle"]] = ContextVar(
    "lightgbm_tpu_trace_span", default=None)


class SpanHandle:
    """One open span: identity + start time.  Ended by any thread."""

    __slots__ = ("name", "span_id", "trace_id", "parent_id", "t0_us",
                 "tid", "args")

    def __init__(self, name: str, span_id: int, trace_id: str,
                 parent_id: Optional[int], t0_us: float, tid: int):
        self.name = name
        self.span_id = span_id
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.t0_us = t0_us
        self.tid = tid
        self.args: Dict[str, Any] = {}


class Tracer:
    """Process-wide trace-event collector (``TRACER`` below)."""

    def __init__(self, max_events: int = 200_000):
        self._lock = threading.Lock()
        self.max_events = int(max_events)
        # ring buffer: under sustained load the NEWEST spans are the
        # ones a shutdown export must contain (the slow request the
        # operator is chasing), so overflow evicts the oldest
        self._events: "deque[Dict[str, Any]]" = deque(maxlen=self.max_events)
        self._next_id = 0
        self._dropped = 0
        self.enabled = False
        self.path: Optional[str] = None
        self._epoch = time.perf_counter()

    # -- configuration ---------------------------------------------------
    def configure(self, path: Optional[str] = None) -> bool:
        """Arm the tracer when a path is configured; the
        ``LIGHTGBM_TPU_TRACE_EVENTS`` env var wins over the argument.
        No env and no argument DISARMS — each run's configuration is
        authoritative, so a second ``engine.train`` in the same process
        cannot inherit the previous run's tracing (or its events: an
        armed run's ``maybe_export`` flushes AND clears)."""
        env = os.environ.get(ENV_PATH, "").strip()
        eff = env or (str(path) if path else "")
        if eff:
            self.path = eff
            self.enabled = True
        else:
            self.enabled = False
        return self.enabled

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    # -- span lifecycle --------------------------------------------------
    def _now_us(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e6

    def _new_id(self) -> int:
        with self._lock:
            self._next_id += 1
            return self._next_id

    def begin(self, name: str, parent: Optional[SpanHandle] = None,
              trace_id: Optional[str] = None,
              args: Optional[Mapping[str, Any]] = None
              ) -> Optional[SpanHandle]:
        """Open a span.  ``parent`` defaults to the context's current
        span (None there makes this a ROOT: a fresh trace id — one trace
        per request / per boosting round).  Returns None while the
        tracer is disabled — every other method accepts that None."""
        if not self.enabled:
            return None
        if parent is None:
            parent = _current.get()
        sid = self._new_id()
        tid = (trace_id or (parent.trace_id if parent is not None
                            else f"t{sid}"))
        h = SpanHandle(str(name), sid, tid,
                       parent.span_id if parent is not None else None,
                       self._now_us(), threading.get_ident())
        if args:
            h.args.update(args)
        return h

    def end(self, handle: Optional[SpanHandle],
            args: Optional[Mapping[str, Any]] = None) -> None:
        """Close a span and record its complete ("X") event.  Callable
        from any thread (the batcher worker closes request queue
        spans)."""
        if handle is None or not self.enabled:
            return
        if args:
            handle.args.update(args)
        ev_args: Dict[str, Any] = {"span_id": handle.span_id,
                                   "trace_id": handle.trace_id}
        if handle.parent_id is not None:
            ev_args["parent_id"] = handle.parent_id
        ev_args.update(handle.args)
        self._append({
            "name": handle.name, "ph": "X", "cat": "lightgbm_tpu",
            "ts": round(handle.t0_us, 3),
            "dur": round(self._now_us() - handle.t0_us, 3),
            "pid": os.getpid(), "tid": handle.tid, "args": ev_args,
        })

    def link(self, src: Optional[SpanHandle],
             dst: Optional[SpanHandle]) -> None:
        """Record a causal edge ``src -> dst`` across threads/traces —
        the many-to-one coalesce edge.  Emits a Chrome flow pair for
        Perfetto AND appends src's ids to dst's ``member_span_ids`` /
        ``member_trace_ids`` args (the machine-readable record)."""
        if src is None or dst is None or not self.enabled:
            return
        dst.args.setdefault("member_span_ids", []).append(src.span_id)
        tids = dst.args.setdefault("member_trace_ids", [])
        if src.trace_id not in tids:
            tids.append(src.trace_id)
        fid = self._new_id()
        now = round(self._now_us(), 3)
        pid = os.getpid()
        self._append({"name": "coalesce", "ph": "s", "cat": "coalesce",
                      "id": str(fid), "ts": now, "pid": pid,
                      "tid": src.tid})
        self._append({"name": "coalesce", "ph": "f", "bp": "e",
                      "cat": "coalesce", "id": str(fid), "ts": now,
                      "pid": pid, "tid": dst.tid})

    @contextmanager
    def span(self, name: str, args: Optional[Mapping[str, Any]] = None,
             parent: Optional[SpanHandle] = None):
        """Context-manager span: begins, installs itself as the context's
        current span (children auto-link), ends on exit."""
        h = self.begin(name, parent=parent, args=args)
        token = _current.set(h) if h is not None else None
        try:
            yield h
        finally:
            if token is not None:
                _current.reset(token)
            self.end(h)

    # -- sink ------------------------------------------------------------
    def _append(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) == self.max_events:
                self._dropped += 1          # deque evicts the oldest
            self._events.append(ev)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def export(self, path: Optional[str] = None) -> Optional[str]:
        """Write the collected events as Chrome trace-event JSON; returns
        the path written (None when disabled/empty)."""
        path = path or self.path
        if not path:
            return None
        with self._lock:
            evs = list(self._events)
            dropped = self._dropped
        if not evs:
            return None
        doc: Dict[str, Any] = {"traceEvents": evs,
                               "displayTimeUnit": "ms"}
        if dropped:
            doc["otherData"] = {"dropped_oldest_events": dropped}
        from ..utils import diskguard
        return diskguard.write_text(path, json.dumps(doc),
                                    sink="trace_events")

    def maybe_export(self) -> Optional[str]:
        """Export to the configured path if armed, then CLEAR the event
        buffer (one export per run — a later run's export must not
        re-ship this run's spans).  Failures degrade to a warning:
        losing a trace must never kill the run it observed."""
        if not self.enabled or not self.path:
            return None
        n = len(self._events)
        from ..utils.diskguard import SinkWriteError
        try:
            out = self.export()
        except (SinkWriteError, OSError):
            # classified + counted + warned by diskguard; the tracer
            # DISABLES itself — re-collecting spans for a sink that
            # cannot land them only grows the ring buffer for nothing
            self.enabled = False
            return None
        if out:
            from ..utils import log
            log.info("telemetry: %d trace events written to %s "
                     "(load in https://ui.perfetto.dev)", n, out)
            self.reset()
        return out


TRACER = Tracer()


def current() -> Optional[SpanHandle]:
    """The context's active span (None outside any span / disabled)."""
    return _current.get()


def push(handle: Optional[SpanHandle]):
    """Install ``handle`` as the context's current span; returns the
    reset token for ``pop`` (None handle -> None token)."""
    return _current.set(handle) if handle is not None else None


def pop(token) -> None:
    if token is not None:
        _current.reset(token)


# ---------------------------------------------------------------------------
# parser + summaries (tests, obs-report --traces)


def read_trace(path: str) -> List[Dict[str, Any]]:
    """Load a Chrome trace-event JSON file -> the traceEvents list
    (accepts both the object form and a bare array)."""
    with open(path) as fh:
        doc = json.load(fh)
    return doc["traceEvents"] if isinstance(doc, dict) else list(doc)


def span_trees(events: Sequence[Mapping[str, Any]]) -> Dict[str, Any]:
    """Reassemble the causal structure from a trace-event list:

    returns ``{"spans": {span_id: event}, "children": {span_id: [ids]},
    "roots": [ids], "traces": {trace_id: [ids]},
    "coalesced_into": {member_span_id: batch_span_id}}``."""
    spans: Dict[int, Mapping[str, Any]] = {}
    children: Dict[int, List[int]] = {}
    traces: Dict[str, List[int]] = {}
    roots: List[int] = []
    coalesced: Dict[int, int] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        args = e.get("args") or {}
        sid = args.get("span_id")
        if sid is None:
            continue
        sid = int(sid)
        spans[sid] = e
        tid = str(args.get("trace_id", ""))
        traces.setdefault(tid, []).append(sid)
        parent = args.get("parent_id")
        if parent is None:
            roots.append(sid)
        else:
            children.setdefault(int(parent), []).append(sid)
        for m in args.get("member_span_ids") or []:
            coalesced[int(m)] = sid
    return {"spans": spans, "children": children, "roots": roots,
            "traces": traces, "coalesced_into": coalesced}


def critical_path(tree: Mapping[str, Any], root: int,
                  _seen: Optional[set] = None) -> List[Dict[str, Any]]:
    """Longest-duration chain from ``root`` down: at each span follow
    the slowest child — crossing coalesce edges (a queue span's path
    continues into the batch span that absorbed it)."""
    _seen = _seen if _seen is not None else set()
    if root in _seen:            # defensive: malformed cycles stop here
        return []
    _seen.add(root)
    ev = tree["spans"].get(root)
    if ev is None:
        return []
    step = {"name": ev["name"],
            "dur_s": round(float(ev.get("dur", 0.0)) / 1e6, 6)}
    nexts = list(tree["children"].get(root, []))
    hop = tree["coalesced_into"].get(root)
    if hop is not None:
        nexts.append(hop)
    if not nexts:
        return [step]
    best = max(nexts,
               key=lambda s: float(tree["spans"].get(s, {}).get("dur", 0)))
    return [step] + critical_path(tree, best, _seen)


def summarize_traces(paths: Sequence[str], top_k: int = 5
                     ) -> Dict[str, Any]:
    """Aggregate one or more trace-event files: per-root-name stats,
    coalesce fan-in, and the slowest-k traces with their critical
    paths (the ``obs-report --traces`` payload)."""
    files: Dict[str, int] = {}
    roots_stats: Dict[str, Dict[str, Any]] = {}
    candidates: List[tuple] = []        # (dur_s, ev, tree, root_sid)
    fan_ins: List[int] = []
    n_traces = 0
    for p in paths:
        events = read_trace(str(p))
        files[str(p)] = len(events)
        tree = span_trees(events)
        for sid, ev in tree["spans"].items():
            members = (ev.get("args") or {}).get("member_span_ids")
            if members:
                fan_ins.append(len(members))
        for root in tree["roots"]:
            ev = tree["spans"][root]
            dur = float(ev.get("dur", 0.0)) / 1e6
            st = roots_stats.setdefault(
                ev["name"], {"count": 0, "total_s": 0.0, "max_s": 0.0})
            st["count"] += 1
            st["total_s"] += dur
            st["max_s"] = max(st["max_s"], dur)
            n_traces += 1
            candidates.append((dur, ev, tree, root))
    for st in roots_stats.values():
        st["mean_s"] = round(st["total_s"] / st["count"], 6)
        st["total_s"] = round(st["total_s"], 6)
        st["max_s"] = round(st["max_s"], 6)
    # the critical-path walk is the expensive part: rank roots by
    # duration first and walk only the slowest k, not every trace
    candidates.sort(key=lambda t: -t[0])
    slow = [{
        "trace_id": (ev.get("args") or {}).get("trace_id"),
        "root": ev["name"], "dur_s": round(dur, 6),
        "critical_path": critical_path(tree, root),
    } for dur, ev, tree, root in candidates[: max(int(top_k), 0)]]
    return {
        "files": files,
        "traces": n_traces,
        "roots": roots_stats,
        "coalesce": {
            "batches": len(fan_ins),
            "max_fan_in": max(fan_ins) if fan_ins else 0,
            "mean_fan_in": (round(sum(fan_ins) / len(fan_ins), 3)
                            if fan_ins else 0.0),
        },
        "slowest": slow,
    }
