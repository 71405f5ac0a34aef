"""Serving fault injectors: make the failures the fleet claims to
survive happen, deterministically, in-process.

The port's own copy of the serving half of the JAX package's
testing/faults.py, over the port's ``serve/fleet.py`` ``Replica``.
Each injector is a context manager that patches one seam and restores
it on exit:

- ``wedge_replica``: a replica's predict blocks until release (the hung
  device the watchdog's stall detector is for);
- ``poison_predict``: predict raises on one replica;
- ``slow_replica``: added service latency (the straggler);
- ``skew_predictions``: every replica of one model answers shifted by a
  constant (the silently wrong model only the quality gate can see);
- ``fail_warmup``: ``CompiledForest.warmup`` raises (a hot reload dying
  mid-warm);
- ``corrupt_model_file``: a truncated, footer-less or bit-rotted model
  file (``POST /reload`` must answer 400 and keep serving).

The predict injectors patch the replica's forest as well as its live
batcher, so the watchdog's synthetic probes see the fault the traffic
sees, and a probe succeeds only once the fault is lifted.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator, Optional


class InjectedCrash(RuntimeError):
    """The error an injector raises where the real failure would."""


def _find_replica(fleet, replica_id: int, model: str = "primary"):
    with fleet._cond:
        rs = fleet._primary if model == "primary" else fleet._canary
        if rs is None:
            raise ValueError(f"fleet has no {model!r} replica set")
        for rep in rs.replicas:
            if rep.replica_id == int(replica_id):
                return rep
    raise ValueError(f"no replica {replica_id} in {model!r}")


@contextlib.contextmanager
def _patched_predict(fleet, replica_id: int, wrap,
                     model: str = "primary") -> Iterator[dict]:
    """Shared plumbing: wrap ``replica.forest.batched_fn`` with ``wrap``
    (fault view for future batchers AND the watchdog's probes) and swap
    the live batcher's ``predict_fn`` to the same faulty callable (fault
    view for traffic already flowing).  Restores both on exit — but a
    batcher REPLACED meanwhile (ejection -> re-admission builds a fresh
    one from the forest) is left alone: it was built from the restored
    forest or will be on the next probe."""
    rep = _find_replica(fleet, replica_id, model)
    stats = {"replica": rep, "calls": 0}
    orig_batched_fn = rep.forest.batched_fn

    def faulty_batched_fn():
        inner = orig_batched_fn()

        def fn(rows):
            stats["calls"] += 1
            return wrap(inner, rows)
        return fn

    rep.forest.batched_fn = faulty_batched_fn
    patched_batcher = rep.batcher
    orig_predict_fn = patched_batcher.predict_fn
    patched_batcher.predict_fn = faulty_batched_fn()
    try:
        yield stats
    finally:
        del rep.forest.batched_fn          # instance attr -> class method
        if rep.batcher is patched_batcher:
            patched_batcher.predict_fn = orig_predict_fn


@contextlib.contextmanager
def wedge_replica(fleet, replica_id: int,
                  model: str = "primary") -> Iterator[dict]:
    """Wedge one replica: its device predict (traffic AND probes)
    blocks until the context exits — the hung-device failure the health
    watchdog's stall detector exists for.  On exit the wedge releases,
    so the next probe succeeds and the replica can be re-admitted.
    Yields a stats dict whose ``release`` event can lift the wedge
    early."""
    release = threading.Event()

    def wedged(inner, rows):
        release.wait()
        return inner(rows)

    with _patched_predict(fleet, replica_id, wedged, model) as stats:
        stats["release"] = release
        try:
            yield stats
        finally:
            release.set()


@contextlib.contextmanager
def poison_predict(fleet, replica_id: int, model: str = "primary",
                   error: Optional[BaseException] = None) -> Iterator[dict]:
    """Every predict on one replica raises (a poisoned compile, a
    device in a bad state).  Probes fail too, so the replica stays
    ejected until the context exits."""
    exc = error or InjectedCrash(
        f"injected predict poison on replica {replica_id}")

    def poisoned(inner, rows):
        raise exc

    with _patched_predict(fleet, replica_id, poisoned, model) as stats:
        stats["error"] = exc
        yield stats


@contextlib.contextmanager
def slow_replica(fleet, replica_id: int, delay_s: float,
                 model: str = "primary") -> Iterator[dict]:
    """One replica serves ``delay_s`` slower than it should — the
    straggler the EWMA latency-outlier rule is for.  Results stay
    correct; only time is poisoned."""
    def slowed(inner, rows):
        time.sleep(float(delay_s))
        return inner(rows)

    with _patched_predict(fleet, replica_id, slowed, model) as stats:
        stats["delay_s"] = float(delay_s)
        yield stats


@contextlib.contextmanager
def skew_predictions(fleet, offset: float,
                     model: str = "canary") -> Iterator[dict]:
    """Every prediction from EVERY replica of ``model`` comes back
    shifted by ``offset`` — the silently-wrong model (a mis-exported
    artifact, a feature-pipeline skew) that serves fast, errors never,
    and is purely WORSE.  Latency and error guardrails cannot see it;
    the labeled-feedback quality gate (rolling logloss/AUC,
    serve/lifecycle.py) is the one that must trip.  Results stay
    shaped/typed correctly; only the values are poisoned."""
    import numpy as np

    off = float(offset)

    def skewed(inner, rows):
        raw, out = inner(rows)
        return np.asarray(raw) + off, np.asarray(out) + off

    with fleet._cond:
        rs = fleet._primary if model == "primary" else fleet._canary
        if rs is None:
            raise ValueError(f"fleet has no {model!r} replica set")
        ids = [rep.replica_id for rep in rs.replicas]
    with contextlib.ExitStack() as stack:
        stats = {"offset": off, "replicas": ids, "per_replica": [
            stack.enter_context(_patched_predict(fleet, rid, skewed, model))
            for rid in ids]}
        yield stats


@contextlib.contextmanager
def fail_warmup(times: int = 1) -> Iterator[dict]:
    """The next ``times`` ``CompiledForest.warmup`` calls raise — a hot
    reload crashing mid-warm on a replica device.  The reload contract
    under test: the serving generation and its predictions stay
    untouched (ModelManager.reload rolls back)."""
    from ..serve.forest import CompiledForest

    stats = {"failed": 0}
    orig = CompiledForest.warmup

    def failing_warmup(self, *args, **kwargs):
        if stats["failed"] < int(times):
            stats["failed"] += 1
            raise InjectedCrash(
                f"injected warmup failure ({stats['failed']}/{times})")
        return orig(self, *args, **kwargs)

    CompiledForest.warmup = failing_warmup
    try:
        yield stats
    finally:
        CompiledForest.warmup = orig


def corrupt_model_file(path: str, mode: str = "truncate_tree") -> str:
    """Damage a saved model file the way real storage does:

    - ``"truncate_tree"``: chop the text mid-way through the last tree
      block (half-written upload);
    - ``"chop_footer"``: cut everything from the last ``Tree=`` on —
      whole trees missing AND no ``feature importances`` footer;
    - ``"garbage_field"``: replace the first ``leaf_value`` number with
      a non-numeric token (bit rot under a valid length).

    Returns a short description of what was done.  The loader contract
    under test: ``LightGBMError`` naming the damage — serve ``/reload``
    turns it into a clean 400, never a half-loaded forest."""
    with open(path, "r") as fh:
        text = fh.read()
    if mode == "truncate_tree":
        last = text.rfind("Tree=")
        if last < 0:
            raise ValueError(f"{path} has no Tree= blocks")
        cut = last + (len(text) - last) // 2
        out = text[:cut]
        what = f"truncated mid-tree at byte {cut}"
    elif mode == "chop_footer":
        last = text.rfind("Tree=")
        if last < 0:
            raise ValueError(f"{path} has no Tree= blocks")
        out = text[:last]
        what = f"chopped from last Tree= (byte {last})"
    elif mode == "garbage_field":
        if "leaf_value=" not in text:
            raise ValueError(f"{path} has no leaf_value section")
        out = text.replace("leaf_value=", "leaf_value=@@rot@@ ", 1)
        what = "first leaf_value poisoned with a non-numeric token"
    else:
        raise ValueError(f"corrupt_model_file: unknown mode {mode!r}")
    with open(path, "w") as fh:
        fh.write(out)
    return what
