"""The program's process registry as the per-layer readers see it: its
``snapshot()`` (``counters``, ``gauges``, ``histograms``), taken in the
run's own process after the window.  A context may carry a ``registry``
snapshot of its own (a test's hand-made one); a program that lacks a
counter or gauge leaves its reader with nothing to read."""

from __future__ import annotations

import sys
from typing import Optional


def snapshot(ctx) -> Optional[dict]:
    """``ctx["registry"]`` if given, else the snapshot of the port's
    registry if the run loaded it, else None."""
    snap = (ctx or {}).get("registry")
    if snap is not None:
        return snap
    mod = sys.modules.get("lightgbm_tpu_torch.obs.registry")
    return None if mod is None else mod.snapshot()


def window_ms_per_iter(ctx, phase: str) -> Optional[float]:
    """Device milliseconds a window iteration of ``phase`` (the stem of
    the program's ``trace_window_device_seconds_<phase>`` gauge, set when
    its trace window closes) in a training cell's traced run."""
    if not (ctx or {}).get("train"):
        return None
    snap = snapshot(ctx)
    gauges = (snap or {}).get("gauges", {})
    dev = gauges.get("trace_window_device_seconds_" + phase)
    iters = gauges.get("trace_window_iterations")
    if dev is None or not iters:
        return None
    return 1e3 * float(dev) / float(iters)
