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
Under a recording profiler (any ``torch.profiler`` window on the span's
thread, ``obs/trace.py``) the span is also a ``record_function`` range
of its own name, so one phase boundary feeds the histogram, the span
tree, TIMETAG and the device trace at once; with no profiler on that
costs one call of ``trace.recording``.

``timed(name)`` wraps a function in a span.

Two more instruments ride on the span boundaries, as in the JAX span,
each gated on one module-attribute read:

- TIMETAG (``utils/timetag.py``): while it is on, a span also feeds the
  timetag accumulator for ``name`` and honours ``sync(x)`` requests,
  waiting on ``x`` before its clock stops through the counted
  ``devprof.sync``;
- memwatch (``obs/memwatch.py``): while it is on, every span exit
  samples the allocator's watermarks under the span's name.
"""

from __future__ import annotations

import functools
import time
from contextlib import contextmanager
from typing import Callable, Optional, Sequence

from . import devprof, memwatch, phases, registry, trace, tracing

# span names are a small fixed set: memoize the name -> series string
_series_cache: dict = {}


def _series(name: str) -> str:
    s = _series_cache.get(name)
    if s is None:
        s = _series_cache[name] = phases.span_series(name)
    return s


class _SpanHandle:
    """Yielded by ``span``: ``sync(x)`` registers tensors to wait on
    before the clock stops, honoured only under TIMETAG; ``trace`` is
    the causal-tracing handle (None unless the tracer is armed)."""

    __slots__ = ("value", "trace")

    def __init__(self):
        self.value = None
        self.trace = None

    def sync(self, value) -> None:
        self.value = value


@contextmanager
def span(name: str, buckets: Optional[Sequence[float]] = None,
         reg: Optional[registry.Registry] = None):
    """Time this block into the ``span_series(name)`` wall-time
    histogram (the span tree when the tracer is armed, the timetag
    accumulator under TIMETAG, a ``record_function`` range under a
    recording profiler).  An exception in the block passes through; the
    span still ends."""
    from ..utils import timetag
    r = reg if reg is not None else registry.REGISTRY
    handle = _SpanHandle()
    serialize = timetag.ENABLED
    token = None
    if tracing.TRACER.enabled:
        handle.trace = tracing.TRACER.begin(name)
        token = tracing.push(handle.trace)
    with trace.device_range(name):
        t0 = time.perf_counter()
        try:
            yield handle
        finally:
            if serialize and handle.value is not None:
                # counted: the serializing mode's wait shows in its
                # profile
                devprof.sync(handle.value, source=name)
            dt = time.perf_counter() - t0
            r.observe(_series(name), dt, buckets)
            if serialize:
                timetag.add(name, dt)
            if handle.trace is not None:
                tracing.pop(token)
                tracing.TRACER.end(handle.trace)
            if memwatch.ENABLED:
                memwatch.sample(name, reg=r)


def timed(name: str, buckets: Optional[Sequence[float]] = None) -> Callable:
    """Decorator form: every call of the wrapped function is one span."""
    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name, buckets):
                return fn(*args, **kwargs)
        return wrapper
    return deco
