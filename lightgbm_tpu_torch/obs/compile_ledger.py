"""Process-wide account of every kernel build.

The port's counterpart of the JAX package's obs/compile_ledger.py.  The
port compiles nothing per shape: what it compiles is its CUDA sources,
one ``nvcc`` run per ``csrc/<name>.cu`` at first use (``ops/_build.py``).
Each such build is one event, in the JAX ledger's schema, so each
package's ``read_ledger`` and ``obs-report --compile`` read the other's
file:

- ``program``: the source's name (``leaf_hist``); ``shapes``: the
  architecture and the build's 16-character digest (``sm_90a,<hash>``);
  ``seconds``: nvcc's wall time; ``t`` and ``count``; ``flops``,
  ``bytes_accessed`` and ``output_bytes`` are None (XLA's cost analysis
  has no counterpart);
- a library loaded from ``build/`` is not a compile and records nothing;
- every event feeds the registry: the ``compile_count`` counter, the
  ``compile_seconds`` histogram and ``compile_count_<program>``;
- events append to an in-memory ledger (``events()``, bounded) and, when
  ``compile_ledger_file`` / ``LIGHTGBM_TPU_COMPILE_LEDGER`` names a path
  (the variable wins), to an append-only JSONL written through the
  guarded sink of ``utils/diskguard.py``, one line a build.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from . import phases, registry

ENV_PATH = "LIGHTGBM_TPU_COMPILE_LEDGER"

#: in-memory ledger cap; the JSONL file keeps every event
MAX_EVENTS = 4096

_lock = threading.Lock()
_events: List[Dict[str, Any]] = []
_dropped = 0
_recorded = 0
_path: Optional[str] = os.environ.get(ENV_PATH, "").strip() or None


def configure(path: Optional[str] = None) -> Optional[str]:
    """Set the JSONL sink of a run: ``LIGHTGBM_TPU_COMPILE_LEDGER`` wins
    over ``path``; neither clears the sink (each run's configuration
    holds).  The in-memory ledger is always on.  Returns the path in
    effect (None = in memory only)."""
    global _path
    env = os.environ.get(ENV_PATH, "").strip()
    with _lock:
        _path = env or (str(path) if path else None)
        return _path


def ledger_path() -> Optional[str]:
    with _lock:
        return _path


def reset() -> None:
    """Clear the in-memory ledger (tests).  Registry counters and any
    JSONL already written are left alone."""
    global _dropped
    with _lock:
        _events.clear()
        _dropped = 0


def recorded() -> int:
    """Builds recorded by this process so far (never reset): devprof
    discards a sample during which this grew."""
    return _recorded


def events() -> List[Dict[str, Any]]:
    """Copy of the in-memory events, oldest first."""
    with _lock:
        return [dict(e) for e in _events]


def total_seconds() -> float:
    with _lock:
        return sum(float(e["seconds"]) for e in _events)


def slowest(k: int = 5) -> List[Dict[str, Any]]:
    """The k slowest events."""
    evs = events()
    evs.sort(key=lambda e: -float(e["seconds"]))
    return evs[: max(int(k), 0)]


def summary(k: int = 5) -> Dict[str, Any]:
    """The in-memory account as one JSON-ready block (the JAX
    ``summary``)."""
    return {
        "count": len(events()),
        "seconds_total": round(total_seconds(), 3),
        "slowest": [{"program": e["program"], "shapes": e["shapes"],
                     "seconds": e["seconds"]} for e in slowest(k)],
    }


def record(program: str, shapes: str, seconds: float,
           cost: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Append one build event; feeds the registry series and the JSONL
    sink.  ``cost`` fields are None unless given (one schema)."""
    global _dropped, _recorded
    registry.inc("compile_count")
    registry.inc("compile_count_" + phases.sanitize(program))
    registry.observe("compile_seconds", float(seconds))
    cost = cost or {}
    ev = {
        "program": str(program),
        "shapes": str(shapes),
        "seconds": round(float(seconds), 6),
        "t": round(time.time(), 3),
        "flops": cost.get("flops"),
        "bytes_accessed": cost.get("bytes_accessed"),
        "output_bytes": cost.get("output_bytes"),
    }
    with _lock:
        _recorded += 1
        ev["count"] = registry.get_counter("compile_count")
        if len(_events) < MAX_EVENTS:
            _events.append(ev)
        else:
            _dropped += 1
        path = _path
    if path:
        # guarded append: a full disk degrades the ledger to in-memory
        # with one warning (or raises under sink_error_policy=fatal)
        from ..utils import diskguard
        diskguard.append_line(path, json.dumps(ev), sink="compile_ledger")
    return ev


def read_ledger(path: str) -> List[Dict[str, Any]]:
    """Parse a ledger JSONL back into event dicts (a torn final line from
    a crashed run is dropped, not fatal)."""
    out: List[Dict[str, Any]] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out
