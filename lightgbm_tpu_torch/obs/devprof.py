"""Device-time attribution: sampled per-program device timing, roofline
gauges, and host<->device transfer accounting.

The port's counterpart of the JAX package's obs/devprof.py, with its
series names.  A kernel launch returns before the card runs it, so the
wall time around a call measures the enqueue; this module times named
units of device work on the card itself:

- ``devprof`` param / ``LIGHTGBM_TPU_DEVPROF`` env (env wins):
  ``off`` | ``full`` | ``sample:N``.  Off is one module-attribute read a
  dispatch: no ``torch.cuda.Event``, no synchronize, no registry
  traffic.
- the seam is ``utils/resource.py``'s ``oom_guard``, the one place that
  already names each unit of device work of a round and of the serving
  path (``dispatch``).  Each is profiled under the name of the JAX
  program that does the same work (:data:`PROGRAMS`).
- when on, every Nth dispatch of each program (N=1 under ``full``) is a
  sample: a ``torch.cuda.Event(enable_timing=True)`` pair recorded on
  the device's current stream (the stream every kernel wrapper launches
  on) before and after the unit, then ``end.synchronize()``, and
  ``dt = start.elapsed_time(end) / 1e3``.  The measured time lands in
  the ``device_seconds_total`` / ``device_seconds_<program>``
  histograms, and ``dt * N`` in the per-program estimate
  (``devprof_device_seconds_est_<program>``), the sampling correction
  that keeps totals unbiased when durations are stationary.  The start
  event completes only once the work queued ahead of it has run, so the
  pair already excludes that backlog: JAX's drain of the previous
  outputs before a sample (``_drain``, ``_last_out``) has no
  counterpart.  On a CPU tensor a sample is the host clock around the
  unit (``time.perf_counter``, read twice as JAX reads it).
- a unit is a Python loop of launches with host reads between them (the
  ordered grower reads about 64 values a tree), so a sample charges the
  device's idle gaps inside the unit to its program: it is an
  attribution instrument (who the time is charged to), not a measure of
  busy time.  ``obs/trace.py``'s ``torch.profiler`` window is what
  measures busy time.
- a dispatch opened while another of the same thread is open passes
  straight through and counts nothing, so the estimates sum to each
  unit once (JAX passes calls made inside another jit's trace through).
- a sample during which a kernel library was built (the compile ledger
  grew) is discarded and counted in ``devprof_samples_skipped_compile``:
  nvcc's seconds are the ledger's account.
- roofline: XLA's static cost analysis has no counterpart, so each
  kernel wrapper counts the bytes of its launch from its shapes
  (``launch_cost`` beside each wrapper's launch counter, the count
  ``chip_smoke.py``'s ``bound_ms`` reads too) and adds them to the open
  sample (``add_bytes``).  At the sample's end ``note_cost`` sets
  ``devprof_bytes_accessed_<program>`` and the sample sets
  ``devprof_roofline_pct_<program>`` against the ``devcaps`` row.  The
  operation counts depend on the data (non-zero digits, node visits)
  and a device read would synchronize, so ``flops`` stays None.  A unit
  that launches no hand-written kernel has no cost and no roofline
  gauge.
- ``transfer(direction, phase, nbytes)``: always-on counters for the
  H2D/D2H feed points under ``phases.TRANSFER_PHASES``, with the legacy
  ``host_to_device_*`` / ``device_to_host_*`` names beside them.
- ``sync(value, source)``: the one timed wait for instruments that
  serialize on purpose (``obs.span`` under TIMETAG,
  ``utils/timetag.scope``), counted in ``devprof_forced_sync_seconds``
  and ``devprof_forced_syncs_<source>``.

Everything lands in the process registry, so ``/metrics``, ``/stats``
and ``obs-report --profile`` read the same account.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional, Tuple

from . import compile_ledger, devcaps, phases, registry

ENV = "LIGHTGBM_TPU_DEVPROF"

#: the programs the port profiles, each named after the JAX program that
#: does the same work (``instrumented_jit(program=...)`` /
#: ``CountingJit(..., "...")`` in the JAX package; a test holds the list
#: to those sources).  The training round's units keep their OOM-guard
#: names; the valid sets' replay of a round's trees is the binned forest
#: walk (JAX ``predict_forest``); a serving bucket is the fused walk
#: (``predict_forest_walk`` binned on the host, ``serve_forest_walk``
#: binned on the device) or, under ``serve_walk=gather``, the gather walk
#: (``predict_forest`` / ``serve_forest``).
PROGRAMS = ("bag_mask", "train_gradients", "train_step", "linear_fit",
            "score_update", "predict_forest", "predict_forest_walk",
            "serve_forest_walk", "serve_forest")

ENABLED = False
MODE = "off"            # "off" | "full" | "sample:N"
_INTERVAL = 0           # sample every Nth dispatch a program (0 = off)

_lock = threading.Lock()
_dispatches: Dict[str, int] = {}
_samples: Dict[str, int] = {}
_est: Dict[str, float] = {}
_costs: Dict[str, Dict[str, Optional[float]]] = {}
_names: Dict[str, str] = {}
_caps: Optional[Dict[str, Any]] = None

# .bucket: the serving padding bucket; .depth: open dispatches;
# .bytes: the open sample's kernel bytes (None outside a sample)
_tls = threading.local()


def parse_mode(raw: Any) -> Tuple[str, int]:
    """``off | full | sample:N`` -> ``(mode, interval)``; the truthy and
    falsy spellings of an env var are accepted.  Raises ValueError on
    anything else: config validation calls this, so a typo dies when
    the parameters are set."""
    if raw is None:
        return "off", 0
    s = str(raw).strip().lower()
    if s in ("", "off", "0", "false", "no", "none"):
        return "off", 0
    if s in ("full", "1", "true", "yes", "on"):
        return "full", 1
    if s.startswith("sample:"):
        try:
            n = int(s.split(":", 1)[1])
        except ValueError:
            n = 0
        if n >= 1:
            return "sample", n
    raise ValueError(
        f"devprof={raw!r}: expected off | full | sample:N (N >= 1)")


def _apply(mode: str, interval: int) -> None:
    global ENABLED, MODE, _INTERVAL
    if mode == "off":
        ENABLED, MODE, _INTERVAL = False, "off", 0
    else:
        ENABLED = True
        MODE = "full" if mode == "full" else f"sample:{interval}"
        _INTERVAL = int(interval)
    # the mode as a number (0 = off, 1 = full, N = stride): a registry
    # snapshot carries it into obs-report --profile
    registry.set_gauge("devprof_sample_interval", _INTERVAL)


def enable(mode: Any = "full") -> str:
    """Programmatic switch; returns the new MODE."""
    _apply(*parse_mode(mode))
    return MODE


def configure(flag: Any = None) -> str:
    """The mode of a run: ``LIGHTGBM_TPU_DEVPROF`` wins over the
    ``devprof`` param; neither disarms.  A malformed env value warns and
    disarms; a malformed param raises.  Returns the MODE in effect."""
    env = os.environ.get(ENV, "").strip()
    if env:
        try:
            mode, n = parse_mode(env)
        except ValueError:
            from ..utils import log
            log.warning("%s=%r is not off|full|sample:N; devprof disabled",
                        ENV, env)
            mode, n = "off", 0
    else:
        mode, n = parse_mode(flag)
    _apply(mode, n)
    return MODE


def reset() -> None:
    """Clear the per-program accumulators (tests).  Registry series
    already written are left alone."""
    global _caps
    with _lock:
        _dispatches.clear()
        _samples.clear()
        _est.clear()
        _costs.clear()
        _names.clear()
        _caps = None


def _prog(program: str) -> str:
    s = _names.get(program)
    if s is None:
        s = _names[program] = phases.sanitize(program)
    return s


def _capabilities(device=None) -> Dict[str, Any]:
    global _caps
    caps = _caps
    if caps is None:
        caps = _caps = devcaps.capabilities(device)
    return caps


# -- sampled dispatch timing (the oom_guard seam) ------------------------

def add_bytes(nbytes: int) -> None:
    """A kernel wrapper's launch adds its bytes (``launch_cost``) to the
    sample open on this thread, if one is."""
    acc = getattr(_tls, "bytes", None)
    if acc is not None:
        _tls.bytes = acc + int(nbytes)


class _HostSample:
    """A sample of a unit on the CPU: the host clock around it."""

    __slots__ = ("t0",)

    def __init__(self):
        self.t0 = time.perf_counter()

    def seconds(self) -> float:
        return time.perf_counter() - self.t0


class _EventSample:
    """A sample of a unit on a card: a timing event pair on the
    device's current stream; ``seconds`` waits for the end event."""

    __slots__ = ("start", "end", "stream")

    def __init__(self, device):
        import torch
        self.stream = torch.cuda.current_stream(device)
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.start.record(self.stream)

    def seconds(self) -> float:
        self.end.record(self.stream)
        self.end.synchronize()
        return self.start.elapsed_time(self.end) / 1e3


def _on_card(device) -> bool:
    return device is not None and getattr(device, "type", None) == "cuda"


@contextmanager
def dispatch(program: str, device=None):
    """One profiled unit of device work on ``device`` (a torch device;
    None or the CPU: the host clock).  Callers check ``ENABLED`` first,
    so off never gets here.  A dispatch opened inside another of this
    thread passes through."""
    depth = getattr(_tls, "depth", 0)
    if depth:
        yield
        return
    prog = _prog(program)
    with _lock:
        n = _dispatches.get(prog, 0) + 1
        _dispatches[prog] = n
        interval = _INTERVAL
    registry.inc("devprof_dispatches_total")
    registry.inc("devprof_dispatches_" + prog)
    _tls.depth = 1
    try:
        if interval <= 0 or n % interval:
            yield
            return
        built = compile_ledger.recorded()
        _tls.bytes = 0
        sample = (_EventSample(device) if _on_card(device)
                  else _HostSample())
        yield
        dt = sample.seconds()
        nbytes = _tls.bytes
    finally:
        _tls.depth = 0
        _tls.bytes = None
    if compile_ledger.recorded() > built:
        registry.inc("devprof_samples_skipped_compile")
        return
    if nbytes:
        note_cost(program, {"flops": None, "bytes_accessed": nbytes,
                            "output_bytes": None})
    _record_sample(prog, dt, interval, device)


def timed_dispatch(program: str, fn, args: tuple = (),
                   kwargs: Optional[dict] = None, device=None):
    """``fn(*args, **kwargs)`` as one profiled unit (the JAX entry's
    call form); returns its result.  Off: the plain call."""
    if not ENABLED:
        return fn(*args, **(kwargs or {}))
    with dispatch(program, device):
        return fn(*args, **(kwargs or {}))


def _record_sample(prog: str, dt: float, interval: int,
                   device=None) -> None:
    registry.observe("device_seconds_total", dt)
    registry.observe("device_seconds_" + prog, dt)
    bucket = getattr(_tls, "bucket", None)
    if bucket is not None:
        registry.observe(f"device_seconds_{prog}_bucket_{bucket}", dt)
    registry.inc("devprof_samples_total")
    registry.inc("devprof_samples_" + prog)
    with _lock:
        _samples[prog] = _samples.get(prog, 0) + 1
        _est[prog] = _est.get(prog, 0.0) + dt * interval
        est = _est[prog]
        total = sum(_est.values())
        cost = _costs.get(prog)
    registry.set_gauge("devprof_device_seconds_est_" + prog, round(est, 6))
    registry.set_gauge("devprof_device_seconds_est_total", round(total, 6))
    if cost:
        rl = devcaps.roofline(cost.get("flops"), cost.get("bytes_accessed"),
                              dt, _capabilities(device))
        if rl["achieved_flops"] is not None:
            registry.set_gauge("devprof_achieved_flops_" + prog,
                               round(rl["achieved_flops"], 1))
        if rl["roofline_pct"] is not None:
            registry.set_gauge("devprof_roofline_pct_" + prog,
                               round(rl["roofline_pct"], 3))


def note_cost(program: str, cost: Dict[str, Optional[float]]) -> None:
    """Keep a program's cost row (its sampled launches' bytes) and
    expose the counts as gauges so snapshots carry them into reports."""
    prog = _prog(program)
    with _lock:
        _costs[prog] = dict(cost)
    for key in ("flops", "bytes_accessed", "output_bytes"):
        v = cost.get(key)
        if v is not None:
            registry.set_gauge(f"devprof_{key}_{prog}", float(v))


# -- counted forced syncs --------------------------------------------------

def _wait(value: Any) -> None:
    """Wait until the device work producing ``value`` (a tensor or a
    nest of lists, tuples and dicts of them) has run; nothing on the
    CPU."""
    import torch
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            torch.cuda.current_stream(value.device).synchronize()
        return
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        for v in value:
            _wait(v)


def sync(value: Any, source: str = "span") -> float:
    """Timed wait for instruments that serialize on purpose (obs.span
    under TIMETAG, timetag.scope): the wait lands in
    ``devprof_forced_sync_seconds`` / ``devprof_forced_syncs_total`` /
    ``devprof_forced_syncs_<source>``.  Returns the wait seconds."""
    t0 = time.perf_counter()
    try:
        _wait(value)
    finally:
        dt = time.perf_counter() - t0
        registry.observe("devprof_forced_sync_seconds", dt)
        registry.inc("devprof_forced_syncs_total")
        registry.inc("devprof_forced_syncs_" + phases.sanitize(source))
    return dt


# -- transfer accounting -------------------------------------------------

def transfer(direction: str, phase: str, nbytes: int,
             transfers: int = 1) -> None:
    """Account one host<->device transfer batch under a
    ``phases.TRANSFER_PHASES`` phase; counter bumps only, always on."""
    nbytes = int(nbytes)
    transfers = int(transfers)
    if direction == "h2d":
        legacy, short = "host_to_device", "h2d"
    elif direction == "d2h":
        legacy, short = "device_to_host", "d2h"
    else:
        raise ValueError(f"transfer direction {direction!r}: h2d or d2h")
    registry.inc(legacy + "_transfers", transfers)
    registry.inc(legacy + "_bytes", nbytes)
    registry.inc(short + "_transfers_total", transfers)
    registry.inc(short + "_bytes_total", nbytes)
    registry.inc(f"{short}_bytes_{phases.sanitize(phase)}", nbytes)


# -- scopes --------------------------------------------------------------

@contextmanager
def bucket_scope(bucket: Optional[int]):
    """Serving context: samples taken inside also land in
    ``device_seconds_<program>_bucket_<B>`` (None: outside a bucket).
    Thread-local: the batcher's workers dispatch.  The forest enters it
    for each padded bucket it dispatches (the JAX ``CountingJit``
    call's)."""
    prev = getattr(_tls, "bucket", None)
    _tls.bucket = None if bucket is None else int(bucket)
    try:
        yield
    finally:
        _tls.bucket = prev


@contextmanager
def round_scope():
    """Host-vs-device split of one boosting round: the wall time around
    the block less the device-seconds estimate accumulated inside it is
    the host share.  No-op (no clock read) while disabled."""
    if not ENABLED:
        yield
        return
    t0 = time.perf_counter()
    with _lock:
        d0 = sum(_est.values())
    try:
        yield
    finally:
        wall = time.perf_counter() - t0
        with _lock:
            dev = sum(_est.values()) - d0
        # a round's corrected estimate can overshoot its wall clock:
        # clamp so the split stays a partition of the round
        dev = min(max(dev, 0.0), wall)
        registry.observe("devprof_round_device_seconds", dev)
        registry.observe("devprof_round_host_seconds", wall - dev)
        registry.inc("devprof_rounds_total")


# -- snapshots -----------------------------------------------------------

def estimates() -> Dict[str, Dict[str, Any]]:
    """Per-program account: ``{prog: {device_seconds_est, samples,
    dispatches, flops, bytes_accessed, output_bytes}}``."""
    with _lock:
        out: Dict[str, Dict[str, Any]] = {}
        for prog, est in _est.items():
            cost = _costs.get(prog) or {}
            out[prog] = {
                "device_seconds_est": round(est, 6),
                "samples": _samples.get(prog, 0),
                "dispatches": _dispatches.get(prog, 0),
                "flops": cost.get("flops"),
                "bytes_accessed": cost.get("bytes_accessed"),
                "output_bytes": cost.get("output_bytes"),
            }
        return out
