"""Gated device trace capture over a window of boosting iterations.

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

Inside the window the growers' ``hist`` / ``find_split`` / ``split``
and the serving walk's ``forest_walk`` (``phases.DEVICE_PHASES``) are
``torch.profiler.record_function`` ranges (:func:`device_range`), where
the JAX package has ``jax.named_scope``; outside a window a range costs
one flag read.  The hand-written kernels are launched through
``ctypes``, so no aten op sits over them: a kernel event is tied to its
range through the ``cudaLaunchKernel`` runtime event inside it.

The window never serializes a round: its one wait is on the training
score at the window's close, so the last iteration's device work lands
inside the capture.  The profiler's first start on a card initializes
CUPTI, which takes seconds: it is charged to the round the window opens
in.
"""

from __future__ import annotations

import atexit
import contextlib
import os
import weakref
from typing import Optional

from ..utils import log

#: windows recording now; :func:`device_range` reads only this
RECORDING = 0

_NULL = contextlib.nullcontext()

# one process-wide atexit hook over weakly held captures: never leave a
# profiler running, never pin a booster's capture for the process
_ACTIVE: "weakref.WeakSet[TraceCapture]" = weakref.WeakSet()


@atexit.register
def _abort_all() -> None:
    for tc in list(_ACTIVE):
        tc.close()


def device_range(name: str):
    """A ``record_function`` range named ``name`` while a window records;
    a shared null context otherwise."""
    if not RECORDING:
        return _NULL
    import torch
    return torch.profiler.record_function(name)


def _wait(value) -> None:
    import torch
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
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device is not None and \
                getattr(self.device, "type", None) == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def iter_begin(self, it: int) -> None:
        global RECORDING
        if self._done or self._active or it < self.start_iter:
            return
        import torch
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
        RECORDING += 1
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
        global RECORDING
        RECORDING = max(RECORDING - 1, 0)
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

    def close(self) -> None:
        """Stop recording now if a window is still open and retire the
        capture.  Idempotent."""
        if self._active:
            self._stop()
        self._done = True
