"""Process-wide registry of monotonic counters, gauges and histograms.

The port's own copy of the JAX package's obs/registry.py: counters only
ever increase, gauges record last-written values, histograms hold
fixed-bucket distributions (span wall times, serve latency) that
``obs/prom.py`` renders cumulatively.  Training (spans, the distributed
learners' traffic), the batcher, the fleet, the health watchdog, the
lifecycle controller and the drift collector write here; ``GET /stats``,
both ``GET /metrics`` listeners and ``Booster.telemetry()`` read a
``snapshot()``.  One dict update under a lock per call: cheap enough to
stay on, and nothing here touches the device.
"""

from __future__ import annotations

import bisect
import threading
from collections import defaultdict
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

# Default histogram bucket upper bounds, in SECONDS (the JAX package's:
# prometheus_client's latency buckets extended to minutes).
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)

# Byte-size bucket bounds (the JAX package's): powers of four, 256 B to
# 4 GiB, for the distributed learners' collective payloads.
DEFAULT_BYTE_BUCKETS: Tuple[float, ...] = tuple(
    float(1 << k) for k in range(8, 33, 2))


class _Hist:
    """One fixed-bucket histogram: non-cumulative bucket counts (the
    last slot is the +Inf overflow), running sum and count.  Buckets are
    fixed at first observe; the owning Registry holds the lock."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Sequence[float]):
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError(
                f"histogram buckets must be strictly increasing: {bounds}")
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.sum += value
        self.count += 1

    def to_dict(self) -> Dict[str, Any]:
        return {"buckets": list(self.bounds), "counts": list(self.counts),
                "sum": self.sum, "count": self.count}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "_Hist":
        h = cls(d["buckets"])
        h.counts = [int(c) for c in d["counts"]]
        h.sum = float(d["sum"])
        h.count = int(d["count"])
        return h

    def fold(self, other: Mapping[str, Any]) -> None:
        """Add another histogram's account into this one: equal bounds
        add bucket by bucket; other bounds land each incoming bucket in
        the first local bucket that covers its upper edge."""
        bounds = tuple(float(b) for b in other["buckets"])
        counts = [int(c) for c in other["counts"]]
        if bounds == self.bounds:
            for i, c in enumerate(counts):
                self.counts[i] += c
        else:
            for i, c in enumerate(counts):
                if not c:
                    continue
                j = (bisect.bisect_left(self.bounds, bounds[i])
                     if i < len(bounds) else len(self.bounds))
                self.counts[j] += c
        self.sum += float(other["sum"])
        self.count += int(other["count"])


def histogram_quantile(hist: Optional[Mapping[str, Any]],
                       q: float) -> Optional[float]:
    """Estimate the q-quantile (0..1) of a histogram snapshot dict by
    linear interpolation inside the landing bucket (PromQL's
    ``histogram_quantile``).  None for an empty or missing histogram;
    the overflow bucket clamps to the last finite bound."""
    if not hist or not hist.get("count"):
        return None
    bounds = list(hist["buckets"])
    counts = list(hist["counts"])
    rank = q * hist["count"]
    cum = 0.0
    for i, c in enumerate(counts):
        cum += c
        if cum >= rank and c:
            if i >= len(bounds):                    # +Inf overflow
                return float(bounds[-1]) if bounds else None
            lo = float(bounds[i - 1]) if i else 0.0
            hi = float(bounds[i])
            frac = (rank - (cum - c)) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
    return float(bounds[-1]) if bounds else None


class Registry:
    """Counters + gauges + histograms with snapshot and reset."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = defaultdict(int)
        self._gauges: Dict[str, Any] = {}
        self._histograms: Dict[str, _Hist] = {}

    def inc(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name`` (created at 0)."""
        with self._lock:
            self._counters[name] += int(n)

    def set_gauge(self, name: str, value: Any) -> None:
        """Record the current value of gauge ``name`` (last write wins)."""
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value: float,
                buckets: Optional[Sequence[float]] = None) -> None:
        """Record one sample into histogram ``name``; the first observe
        fixes its bucket bounds (``DEFAULT_TIME_BUCKETS`` by default)."""
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = _Hist(
                    buckets if buckets is not None else DEFAULT_TIME_BUCKETS)
            h.observe(float(value))

    def get_counter(self, name: str) -> int:
        with self._lock:
            return int(self._counters.get(name, 0))

    def get_gauge(self, name: str, default: Any = None) -> Any:
        with self._lock:
            return self._gauges.get(name, default)

    def get_histogram(self, name: str) -> Optional[Dict[str, Any]]:
        """Plain-dict view of one histogram
        (``{"buckets", "counts", "sum", "count"}``) or None."""
        with self._lock:
            h = self._histograms.get(name)
            return h.to_dict() if h is not None else None

    def snapshot(self) -> Dict[str, Any]:
        """``{"counters", "gauges", "histograms"}`` as plain dicts (the
        JAX package's adds its TIMETAG phase timers, not ported)."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: h.to_dict()
                               for k, h in self._histograms.items()},
            }

    def merge(self, snap: Mapping[str, Any]) -> None:
        """Fold another registry's ``snapshot()`` in: counters and
        histogram buckets add, gauges last-write-wins (``obs-report
        --profile`` / ``--drift`` over several snapshot files)."""
        with self._lock:
            for name, v in dict(snap.get("counters", {})).items():
                self._counters[name] += int(v)
            self._gauges.update(dict(snap.get("gauges", {})))
            for name, hd in dict(snap.get("histograms", {})).items():
                h = self._histograms.get(name)
                if h is None:
                    self._histograms[name] = _Hist.from_dict(hd)
                else:
                    h.fold(hd)

    def restore(self, snap: Mapping[str, Any]) -> None:
        """Overwrite this registry's values with a ``snapshot()``'s:
        counters and gauges set, histograms replaced exactly (a resumed
        run continues the interrupted run's account, ``snapshot.py``)."""
        with self._lock:
            for name, v in dict(snap.get("counters", {})).items():
                self._counters[name] = int(v)
            self._gauges.update(dict(snap.get("gauges", {})))
            for name, hd in dict(snap.get("histograms", {})).items():
                self._histograms[name] = _Hist.from_dict(hd)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


REGISTRY = Registry()


def inc(name: str, n: int = 1) -> None:
    REGISTRY.inc(name, n)


def set_gauge(name: str, value: Any) -> None:
    REGISTRY.set_gauge(name, value)


def observe(name: str, value: float,
            buckets: Optional[Sequence[float]] = None) -> None:
    REGISTRY.observe(name, value, buckets)


def get_counter(name: str) -> int:
    return REGISTRY.get_counter(name)


def get_gauge(name: str, default: Any = None) -> Any:
    return REGISTRY.get_gauge(name, default)


def get_histogram(name: str) -> Optional[Dict[str, Any]]:
    return REGISTRY.get_histogram(name)


def snapshot() -> Dict[str, Any]:
    return REGISTRY.snapshot()


def merge(snap: Mapping[str, Any]) -> None:
    REGISTRY.merge(snap)


def restore(snap: Mapping[str, Any]) -> None:
    REGISTRY.restore(snap)


def reset() -> None:
    REGISTRY.reset()
