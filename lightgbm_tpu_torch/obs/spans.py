"""Wall-time spans feeding per-phase histograms and the span tree.

The port's counterpart of the JAX package's obs/spans.py.  ``span(name)``
measures host wall clock between enter and exit and lands one
histogram observe in the registry under ``phases.span_series(name)``
(``GBDT::iteration`` -> ``phase_seconds_gbdt_iteration``).  It never
synchronizes the device: around an asynchronous launch it measures the
dispatch.  When the causal tracer is armed (``obs/tracing.py``) the span
also opens a parent-linked trace span, installed as the context's
current span for its body, so ``GBDT::iteration`` and ``Serve::batch``
land in the Chrome trace export with their children; the yielded
handle's ``trace`` is that tracing ``SpanHandle`` (None while the tracer
is disarmed), which the batcher links its requests' queue spans into.

``timed(name)`` wraps a function in a span.

Not here yet, because the device-time attribution they feed is not
ported: the JAX span's TIMETAG sink (its ``sync(x)`` requests and the
timetag accumulator) and the ``memwatch`` sample at span exit.
"""

from __future__ import annotations

import functools
import time
from contextlib import contextmanager
from typing import Callable, Optional, Sequence

from . import phases, registry, tracing

# span names are a small fixed set: memoize the name -> series string
_series_cache: dict = {}


def _series(name: str) -> str:
    s = _series_cache.get(name)
    if s is None:
        s = _series_cache[name] = phases.span_series(name)
    return s


class _SpanHandle:
    """Yielded by ``span``; ``trace`` is the causal-tracing handle (None
    unless the tracer is armed)."""

    __slots__ = ("trace",)

    def __init__(self):
        self.trace = None


@contextmanager
def span(name: str, buckets: Optional[Sequence[float]] = None,
         reg: Optional[registry.Registry] = None):
    """Time this block into the ``span_series(name)`` wall-time
    histogram (and the span tree when the tracer is armed).  An
    exception in the block passes through; the span still ends."""
    r = reg if reg is not None else registry.REGISTRY
    handle = _SpanHandle()
    token = None
    if tracing.TRACER.enabled:
        handle.trace = tracing.TRACER.begin(name)
        token = tracing.push(handle.trace)
    t0 = time.perf_counter()
    try:
        yield handle
    finally:
        r.observe(_series(name), time.perf_counter() - t0, buckets)
        if handle.trace is not None:
            tracing.pop(token)
            tracing.TRACER.end(handle.trace)


def timed(name: str, buckets: Optional[Sequence[float]] = None) -> Callable:
    """Decorator form: every call of the wrapped function is one span."""
    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name, buckets):
                return fn(*args, **kwargs)
        return wrapper
    return deco
