"""Run telemetry: the registry, its Prometheus rendering, wall-time
spans, causal span trees, the per-iteration event stream, its offline
report, the training ``/metrics`` listener and the drift observatory.

The port's counterpart of the JAX package's ``obs``:

- ``registry`` (process-wide counters, gauges, histograms) and ``prom``
  (exposition text and its parser);
- ``spans``: ``span(name)`` / ``timed(name)``, one wall-time histogram
  observe into ``phase_seconds_<name>`` a span, and a trace span when
  the tracer is armed; ``phases`` is the taxonomy of span names;
- ``tracing``: parent-linked span trees with trace ids, one trace a
  serve request (request -> queue -> coalesced batch -> ``Predict::
  forest``) and one a boosting round, exported as Chrome trace-event
  JSON (``trace_events_file`` / ``LIGHTGBM_TPU_TRACE_EVENTS``);
- ``events``: the per-iteration JSONL stream (``events_file``) that
  ``GBDT.train_one_iter`` and ``callback.log_telemetry`` write;
- ``report``: ``python -m lightgbm_tpu_torch obs-report`` over event
  streams, trace exports, compile ledgers and registry snapshots;
- ``metrics_server``: the training ``GET /metrics`` listener
  (``metrics_port`` / ``LIGHTGBM_TPU_METRICS_PORT``);
- ``drift`` (``DataFingerprint`` and the serve-side ``DriftCollector``)
  and ``memwatch`` (the caching allocator's watermarks, sampled at every
  span exit while ``memwatch`` is on);
- device-time attribution: ``devprof`` (CUDA-event samples of each named
  unit of device work, roofline gauges, transfer accounts), ``devcaps``
  (the capability table, the H100 row among its rows), ``trace``
  (``TraceCapture``, a ``torch.profiler`` window over boosting rounds)
  and ``compile_ledger`` (one event an nvcc build); the TIMETAG sink of
  ``span`` feeds ``utils/timetag.py``.
"""

from __future__ import annotations

from . import compile_ledger, devcaps, devprof, drift, memwatch  # noqa: F401
from . import registry  # noqa: F401
from .events import SCHEMA_VERSION, EventRecorder, read_events
from .phases import (DEVICE_PARENT, DEVICE_PHASES, HOST_PHASES,
                     JITTED_HOST_PHASES, TRANSFER_PHASES, span_series)
from .prom import labeled_name, split_series
from .registry import (DEFAULT_BYTE_BUCKETS, DEFAULT_TIME_BUCKETS, REGISTRY,
                       Registry, get_counter, get_gauge, get_histogram,
                       histogram_quantile, inc, merge, observe, reset,
                       restore, set_gauge, snapshot)
from .spans import span, timed
from .trace import TraceCapture
from .tracing import TRACER


def trace_span(name, args=None, parent=None):
    """Context manager: one causal-tracing span (no histogram observe:
    ``span`` times a phase).  A no-op while the tracer is disarmed."""
    return TRACER.span(name, args=args, parent=parent)


def trace_begin(name, parent=None, args=None):
    """Open a tracing span that ``trace_end`` closes, possibly from
    another thread (the batcher's worker ends each request's queue
    span).  None while the tracer is disarmed."""
    return TRACER.begin(name, parent=parent, args=args)


def trace_end(handle, args=None):
    TRACER.end(handle, args=args)


def trace_link(src, dst):
    """Record a many-to-one coalesce edge ``src -> dst``."""
    TRACER.link(src, dst)


__all__ = ["DEFAULT_BYTE_BUCKETS", "DEFAULT_TIME_BUCKETS", "DEVICE_PARENT",
           "DEVICE_PHASES", "EventRecorder", "HOST_PHASES",
           "JITTED_HOST_PHASES", "REGISTRY", "Registry", "SCHEMA_VERSION",
           "TRACER", "TRANSFER_PHASES", "TraceCapture", "compile_ledger",
           "devcaps", "devprof", "drift", "get_counter", "get_gauge",
           "get_histogram", "histogram_quantile", "inc", "labeled_name",
           "memwatch", "merge", "observe", "read_events", "reset",
           "restore", "set_gauge", "snapshot", "span", "span_series",
           "split_series", "timed", "trace_begin", "trace_end",
           "trace_link", "trace_span"]
