"""Gated device trace capture over a window of boosting iterations, the
program's phase ranges under any profiler, and the window's per-phase
device account.

The port's counterpart of the JAX package's obs/trace.py, on
``torch.profiler``.  ``LIGHTGBM_TPU_TRACE_DIR=/path`` (or the
``trace_dir`` key; the variable wins) arms a one-shot profiler window of
``trace_num_iters`` iterations (default 2) starting at
``trace_start_iter`` (default 5, so the kernels' first builds and
launches stay out of it), counted from where the window actually
started.  The window records CPU and CUDA activity on a card, CPU only
on the CPU, and is written with ``export_chrome_trace`` into
``trace_dir`` as ``trace_iter<start>.json`` (``.rank<r>`` before the
suffix under a process group, as ``obs/events.py`` names its files).
Open it in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.

Ranges follow any recording profiler: :func:`recording` asks the
profiler itself (``torch.autograd._profiler_enabled``, true on the
thread that started a profiler), so this window, a caller's own
``torch.profiler`` or a benchmark's all see the same ranges.  The
growers' ``hist`` / ``find_split`` / ``split`` and the frozen forest's
``bin_lookup`` / ``forest_walk`` / ``transform``
(``phases.DEVICE_PHASES``) are :func:`device_range` sites, where the
JAX package has ``jax.named_scope``; every ``obs.span`` and
``utils/timetag.scope`` opens a range of its own name too.  The ranges
are ``record_function``s on the profiler's clock, so each idle gap of a
trace falls inside the program phase the host was in.  With no profiler
on, a site costs one call of the predicate and returns a shared null
context.

When the window stops it turns its trace into one account a phase
(:func:`window_account`, a pure function over the Chrome trace's
events): the ranges' host seconds, the device seconds of the kernels,
copies and sets launched from inside them, and the count of those
launches, each a registry gauge (``trace_window_host_seconds_<phase>``,
``trace_window_device_seconds_<phase>``,
``trace_window_launches_<phase>``, the phase as ``phases.sanitize``
writes it); ``unranged`` holds the device events launched outside every
range, ``trace_window_iterations`` the iterations the window held and
``trace_window_account_seconds`` what the account cost.  A device event
is tied to the innermost range around its runtime launch
(``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) by the launch's
correlation id, never by overlap in time: the hand-written kernels are
launched through ``ctypes``, so no aten op sits over them and only the
runtime event ties them to their range.

The window never serializes a round: its one wait is on the training
score at the window's close, so the last iteration's device work lands
inside the capture.  The boosting loop opens the window before a
round's ``GBDT::iteration`` span and closes it after one, so every
round in the window is one whole range.  The profiler's first start on
a card initializes CUPTI, which takes seconds, and the close writes the
trace and reads it back for the account, which takes seconds at a
full-size round: both are charged to the caller's round, outside its
span.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import time
import weakref
from collections import defaultdict
from typing import Dict, Iterable, Optional

import torch

from ..utils import log
from . import phases, registry

#: True while a profiler records on the calling thread: the one predicate
#: every range site reads (the profiler's own flag, no Python in between)
recording = torch.autograd._profiler_enabled

_NULL = contextlib.nullcontext()

# one process-wide atexit hook over weakly held captures: never leave a
# profiler running, never pin a booster's capture for the process
_ACTIVE: "weakref.WeakSet[TraceCapture]" = weakref.WeakSet()

# the account's range names: the taxonomy, so its gauges stay a closed set
_PHASES = phases.HOST_PHASES | phases.DEVICE_PHASES
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@atexit.register
def _abort_all() -> None:
    for tc in list(_ACTIVE):
        tc.close()


def device_range(name: str):
    """A ``record_function`` range named ``name`` while a profiler
    records on this thread; a shared null context otherwise."""
    if not recording():
        return _NULL
    return torch.profiler.record_function(name)


def window_account(events: Iterable[dict]) -> Dict[str, Dict[str, float]]:
    """``{phase: {"host_s", "device_s", "launches"}}`` of a Chrome trace's
    events (``traceEvents``): each taxonomy range's summed host seconds,
    and each device event (kernel, copy, set) charged to the innermost
    such range on the thread of its runtime launch, found by the
    launch's ``args.correlation``.  A device event whose launch lies
    outside every range, or is not in the trace, is ``unranged``."""
    ranges, launches, device = defaultdict(list), {}, []
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X" or cat is None:
            continue
        if cat == "user_annotation":
            if e.get("name") in _PHASES:
                t = float(e["ts"])
                ranges[e.get("tid")].append(
                    (t, t + float(e.get("dur", 0.0)), e["name"]))
            continue
        corr = (e.get("args") or {}).get("correlation")
        if corr is None:
            continue
        if cat in _LAUNCH_CATS:
            launches[corr] = (e.get("tid"), float(e["ts"]))
        elif cat in _DEVICE_CATS:
            device.append((corr, float(e.get("dur", 0.0))))
    acct: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"host_s": 0.0, "device_s": 0.0, "launches": 0})
    for rs in ranges.values():
        for a, b, name in rs:
            acct[name]["host_s"] += (b - a) * 1e-6
    # each launch's innermost range, one sweep a thread
    phase_of = {}
    by_tid = defaultdict(list)
    for corr, (tid, t) in launches.items():
        if tid in ranges:
            by_tid[tid].append((t, corr))
    for tid, pts in by_tid.items():
        pts.sort()
        names = _innermost(ranges[tid], [t for t, _ in pts])
        phase_of.update((c, n) for (_, c), n in zip(pts, names) if n)
    for corr, dur in device:
        a = acct[phase_of.get(corr, "unranged")]
        a["device_s"] += dur * 1e-6
        a["launches"] += 1
    return {k: dict(v) for k, v in acct.items()}


def _innermost(spans, points):
    """For each point (sorted), the name of the latest-starting span that
    still covers it (the ranges of one thread nest), or None."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = [], [], 0
    for p in points:
        while i < len(spans) and spans[i][0] <= p:
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def _wait(value) -> None:
    if isinstance(value, torch.Tensor) and value.device.type == "cuda":
        torch.cuda.current_stream(value.device).synchronize()


class TraceCapture:
    """One-shot trace window: ``iter_begin``/``iter_end`` from the
    training loop, ``close()`` when the loop ends (a window the run ended
    inside is written there, not at process exit).  A start or stop
    failure degrades to a one-shot warning."""

    def __init__(self, trace_dir: str, start_iter: int = 5,
                 num_iters: int = 2, device=None):
        self.trace_dir = str(trace_dir)
        self.start_iter = max(int(start_iter), 0)
        self.num_iters = max(int(num_iters), 1)
        self.device = device
        self.path: Optional[str] = None
        self._prof = None
        self._active = False
        self._done = False
        self._started_at = -1
        self._iters = 0
        #: the last window's :func:`window_account` (None before it closes)
        self.account: Optional[Dict[str, Dict[str, float]]] = None
        _ACTIVE.add(self)

    @classmethod
    def from_config(cls, config=None,
                    device=None) -> Optional["TraceCapture"]:
        """Build from LIGHTGBM_TPU_TRACE_DIR (wins) or the keys
        ``trace_dir`` / ``trace_start_iter`` / ``trace_num_iters``; None
        when tracing is not asked for."""
        trace_dir = os.environ.get("LIGHTGBM_TPU_TRACE_DIR", "")
        start, num = 5, 2
        if config is not None:
            trace_dir = trace_dir or str(config.get("trace_dir", "") or "")
            start = int(config.get("trace_start_iter", start))
            num = int(config.get("trace_num_iters", num))
        if not trace_dir:
            return None
        return cls(trace_dir, start, num, device)

    # -- window ----------------------------------------------------------
    def _activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device is not None and \
                getattr(self.device, "type", None) == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def iter_begin(self, it: int) -> None:
        """Open the window at iteration ``start_iter`` or the first one
        past it; inside the window, count the iteration."""
        if self._active:
            self._iters += 1
            return
        if self._done or it < self.start_iter:
            return
        try:
            os.makedirs(self.trace_dir, exist_ok=True)
            prof = torch.profiler.profile(activities=self._activities())
            prof.start()
        except Exception as e:  # pragma: no cover - backend-dependent
            self._done = True
            log.warn_once("obs_trace_start",
                          "device trace capture failed to start: %s", e)
            return
        self._prof = prof
        self._active = True
        self._started_at = it
        self._iters = 1
        log.info("telemetry: device trace started at iteration %d -> %s",
                 it, self.trace_dir)

    def iter_end(self, it: int, sync=None) -> None:
        """Close the window once ``num_iters`` iterations are inside it
        (counted from where it started: continued training may resume
        past ``start_iter``); waits on ``sync`` first so the final
        iteration's device work is captured."""
        if not self._active or it + 1 < self._started_at + self.num_iters:
            return
        if sync is not None:
            try:
                _wait(sync)
            except Exception:  # pragma: no cover
                pass
        self._stop()

    def _file(self) -> str:
        from ..parallel.multihost import process_rank_world
        rank, world = process_rank_world()
        suffix = f".rank{rank}" if world > 1 else ""
        return os.path.join(self.trace_dir,
                            f"trace_iter{self._started_at}{suffix}.json")

    # -- teardown --------------------------------------------------------
    def _stop(self) -> None:
        self._active = False
        self._done = True
        try:
            self._prof.stop()
            path = self._file()
            self._prof.export_chrome_trace(path)
            self.path = path
            log.info("telemetry: device trace written to %s", path)
        except Exception as e:  # pragma: no cover - backend-dependent
            log.warn_once("obs_trace_stop",
                          "device trace capture failed to stop: %s", e)
        self._prof = None
        if self.path is not None:
            self._account()

    def _account(self) -> None:
        """Set the window's per-phase account (:func:`window_account`)
        and its iteration count in the registry."""
        t0 = time.perf_counter()
        try:
            with open(self.path) as fh:
                events = json.load(fh).get("traceEvents", [])
        except (OSError, ValueError) as e:
            log.warn_once("obs_trace_account",
                          "device trace account failed to read %s: %s",
                          self.path, e)
            return
        self.account = window_account(events)
        for phase, a in self.account.items():
            stem = phases.sanitize(phase)
            if phase != "unranged":
                registry.set_gauge("trace_window_host_seconds_" + stem,
                                   a["host_s"])
            registry.set_gauge("trace_window_device_seconds_" + stem,
                               a["device_s"])
            registry.set_gauge("trace_window_launches_" + stem,
                               a["launches"])
        registry.set_gauge("trace_window_iterations", self._iters)
        registry.set_gauge("trace_window_account_seconds",
                           time.perf_counter() - t0)

    def close(self) -> None:
        """Stop recording now if a window is still open and retire the
        capture.  Idempotent."""
        if self._active:
            self._stop()
        self._done = True
