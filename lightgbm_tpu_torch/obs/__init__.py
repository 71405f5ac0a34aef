"""Serving telemetry: the counter/gauge/histogram registry, its
Prometheus rendering, wall-time spans and the drift observatory.

The port's counterpart of the part of the JAX package's ``obs`` that the
serving fleet writes and ``GET /stats`` / ``GET /metrics`` read:
``registry`` (process-wide counters, gauges, histograms), ``prom``
(exposition text and its parser), ``span(name)`` (one wall-time
histogram observe into ``phase_seconds_<name>``, the JAX package's
``obs.span`` without its trace and TIMETAG sinks) and ``drift``
(``DataFingerprint`` and the serve-side ``DriftCollector``).  The
causal tracer, the event log, device profiling and the compile ledger
are not ported.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

from . import registry
from .prom import labeled_name, sanitize, split_series
from .registry import (DEFAULT_TIME_BUCKETS, REGISTRY, get_counter,
                       get_gauge, get_histogram, histogram_quantile, inc,
                       observe, reset, set_gauge, snapshot)


def span_series(name: str) -> str:
    """Histogram series of a phase's span timer: ``Serve::reload`` ->
    ``phase_seconds_serve_reload`` (the JAX package's naming)."""
    return "phase_seconds_" + sanitize(name)


@contextmanager
def span(name: str):
    """Time the block into the ``span_series(name)`` histogram."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        registry.observe(span_series(name), time.perf_counter() - t0)


__all__ = ["DEFAULT_TIME_BUCKETS", "REGISTRY", "get_counter", "get_gauge",
           "get_histogram", "histogram_quantile", "inc", "labeled_name",
           "observe", "reset", "set_gauge", "snapshot", "span",
           "span_series", "split_series"]
