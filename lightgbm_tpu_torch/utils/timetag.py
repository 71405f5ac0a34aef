"""TIMETAG-style phase profiling.

The port's counterpart of the JAX package's utils/timetag.py.  The
reference compiles scoped wall-clock accumulators under ``#ifdef
TIMETAG`` (serial_tree_learner.cpp:10-37, gbdt.cpp:20-59) and prints
the totals at shutdown; here the same phase taxonomy:

- ``scope(name)`` accumulates host wall clock under ``name`` while
  ``LIGHTGBM_TPU_TIMETAG=1`` (or :func:`enable`); the yielded object's
  ``sync(x)`` registers tensors to wait on before the clock stops
  (``obs/devprof.py`` ``sync``, a counted forced sync), so device time
  is charged to the phase that launched it.  This serializes the round,
  as the reference's TIMETAG builds perturb theirs: a measurement mode,
  not a production mode;
- ``obs.span`` feeds the same accumulator while enabled, and every
  scope mirrors its time into the span's ``phase_seconds_<name>``
  histogram: one account, two sinks;
- the growers carry ``torch.profiler`` ranges with the device phase
  names (``obs/trace.py``), so a trace window breaks device time down
  by phase without a re-run.
"""

from __future__ import annotations

import atexit
import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

from . import log

ENABLED = os.environ.get("LIGHTGBM_TPU_TIMETAG", "") not in ("", "0")


def enable(on: bool = True) -> None:
    """Programmatic switch (the env var only sets the initial state)."""
    global ENABLED
    ENABLED = on


_acc: Dict[str, float] = defaultdict(float)
_cnt: Dict[str, int] = defaultdict(int)


def add(name: str, seconds: float) -> None:
    """Accumulate a duration measured elsewhere under ``name``
    (``obs.span`` while TIMETAG is on)."""
    _acc[name] += seconds
    _cnt[name] += 1


class _Sync:
    """Collects the tensors to wait on when the scope closes."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def sync(self, value) -> None:
        self.value = value


class _NoopSync:
    """Disabled: keeps no reference to what it is given (one would pin
    a gradient or score buffer in device memory)."""

    __slots__ = ()

    def sync(self, value) -> None:
        pass


_NOOP = _NoopSync()


@contextmanager
def scope(name: str):
    """Accumulate wall time under ``name``; the yielded object's
    ``sync(x)`` makes the scope wait on ``x`` before the clock stops."""
    if not ENABLED:
        yield _NOOP
        return
    s = _Sync()
    t0 = time.perf_counter()
    try:
        yield s
    finally:
        if s.value is not None:
            from ..obs import devprof
            devprof.sync(s.value, source=name)
        dt = time.perf_counter() - t0
        _acc[name] += dt
        _cnt[name] += 1
        from ..obs import registry, spans
        registry.observe(spans._series(name), dt)


def get_timings() -> Dict[str, float]:
    return dict(_acc)


def get_counts() -> Dict[str, int]:
    return dict(_cnt)


def reset() -> None:
    _acc.clear()
    _cnt.clear()


def report() -> None:
    """Log the accumulated phase costs (GBDT::~GBDT's 'xxx costs:'
    lines)."""
    for name in sorted(_acc):
        log.info("%s costs: %f (%d calls)", name, _acc[name], _cnt[name])


@atexit.register
def _report_at_exit() -> None:
    if ENABLED and _acc:
        report()
