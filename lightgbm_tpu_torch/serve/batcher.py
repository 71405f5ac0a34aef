"""Batch-size ladder + request micro-batcher.

Port of the JAX package's serve/batcher.py.  Rows are padded up a small
ladder of power-of-two bucket sizes with a validity mask, which bounds
the shapes the device sees.  Nothing here compiles per bucket (the
kernels are built once), so the JAX package's ``CountingJit`` has no
counterpart: the forest-walk wrappers count their own launches
(``ops/forest_walk.launch_counts``).

``MicroBatcher`` coalesces concurrent ``submit()`` calls into one device
batch under a max-latency deadline: one worker thread waits up to
``max_delay_s`` from the oldest queued request, closes the batch at
``max_batch`` rows, runs ``predict_fn`` once on the concatenated rows
and splits the result back per request.  The worker enters
``torch.cuda.device(device)`` so its launches go to the forest's card.
It writes the JAX batcher's registry series (``obs/registry.py``):
``serve_requests`` / ``serve_rows`` at submit, ``serve_batches`` /
``serve_batch_rows`` a batch, ``serve_deadline_expired_total``,
``serve_timeouts_shed`` and one ``serve_latency_seconds`` sample a
request, each mirrored into a ``{model=...}`` series when the batcher
carries ``metric_labels`` (the fleet's replicas do).  ``max_queue``
bounds the pending queue (:class:`QueueFull`, the fleet's 429);
``abort()`` fails every queued and in-flight request at once (replica
ejection), and ``stalled_for_s()`` is the health watchdog's wedge
signal.  With the tracer armed a request's ``Serve::queue`` span opens
at enqueue under the submitting thread's span and ends when its batch
starts (or with ``closed`` / ``shed`` / ``expired`` / ``failed``); the
``Serve::batch`` span links each request into it, records
``coalesced`` and holds the ``Predict::forest`` span.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import (Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from .. import obs
from ..obs import tracing


class QueueFull(RuntimeError):
    """``submit()`` refused: the bounded queue holds ``max_queue``
    pending requests."""


class BatcherClosed(RuntimeError):
    """``submit()`` against a closed batcher, or a request failed by
    shutdown."""


class DeadlineExpired(RuntimeError):
    """The request's deadline passed before it could be served; expired
    work is shed before it takes device time."""


def device_scope(device):
    """``torch.cuda.device(device)`` for a card, else a no-op: a serving
    thread's launches go to its forest's card."""
    if device is not None and getattr(device, "type", None) == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def default_ladder(lo: int = 16, hi: int = 65536) -> List[int]:
    """Power-of-two bucket sizes from ``lo`` to ``hi`` inclusive."""
    lo = max(int(lo), 1)
    hi = max(int(hi), lo)
    sizes = []
    b = lo
    while b < hi:
        sizes.append(b)
        b <<= 1
    sizes.append(hi)
    return sizes


class BucketLadder:
    """A sorted set of batch sizes every request is padded up to."""

    def __init__(self, sizes: Optional[Sequence[int]] = None):
        sizes = list(sizes) if sizes else default_ladder()
        self.sizes = sorted({int(s) for s in sizes})
        if not self.sizes or self.sizes[0] <= 0:
            raise ValueError(f"bucket sizes must be positive: {sizes}")

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (the largest bucket for oversize n)."""
        for s in self.sizes:
            if s >= n:
                return s
        return self.sizes[-1]

    def chunks(self, n: int) -> List[Tuple[int, int, int]]:
        """Split ``n`` rows into ``(offset, rows, bucket)`` chunks:
        oversize inputs stream through the largest bucket and the
        remainder drops back down the ladder."""
        out: List[Tuple[int, int, int]] = []
        hi = self.sizes[-1]
        off = 0
        while n - off > hi:
            out.append((off, hi, hi))
            off += hi
        out.append((off, n - off, self.bucket_for(n - off)))
        return out


def pad_rows(X: np.ndarray, bucket: int):
    """Pad ``X`` ([n, F]) with zero rows up to ``bucket``; return
    ``(padded, mask)`` where mask marks the real rows."""
    n = X.shape[0]
    mask = np.zeros(bucket, dtype=bool)
    mask[:n] = True
    if n == bucket:
        return X, mask
    pad = np.zeros((bucket - n,) + X.shape[1:], dtype=X.dtype)
    return np.concatenate([X, pad], axis=0), mask


class _Pending:
    __slots__ = ("rows", "done", "result", "error", "t0", "deadline",
                 "tspan")

    def __init__(self, rows: np.ndarray, deadline: Optional[float] = None):
        self.rows = rows
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.t0 = time.perf_counter()
        self.deadline = deadline      # absolute time.monotonic() instant
        # the queue-wait span (enqueue -> batch pickup), a child of the
        # submitting thread's current span (the request's, or its
        # hedge's); the worker thread, which inherits no context, ends
        # it at pickup.  None while the tracer is disarmed.
        self.tspan = obs.trace_begin("Serve::queue",
                                     parent=tracing.current(),
                                     args={"rows": int(rows.shape[0])})


class MicroBatcher:
    """Coalesce concurrent predict requests into device batches (the
    registry series of the module docstring).  A submit against a full
    ``max_queue`` (0 = unbounded) raises :class:`QueueFull`."""

    def __init__(self, predict_fn: Callable[[np.ndarray], object],
                 max_batch: int = 8192, max_delay_s: float = 0.005,
                 max_queue: int = 0,
                 metric_labels: Optional[Mapping[str, str]] = None,
                 device: Optional[torch.device] = None):
        self.predict_fn = predict_fn
        self.max_batch = max(int(max_batch), 1)
        self.max_delay_s = max(float(max_delay_s), 0.0)
        self.max_queue = max(int(max_queue), 0)
        self.device = device
        self._labels = dict(metric_labels or {})
        self._labeled_keys: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: List[_Pending] = []
        # the batch on the device: close()/abort() fail its requests if
        # the worker is wedged in predict_fn, and its start time is the
        # watchdog's wedge signal
        self._active: List[_Pending] = []
        self._active_since: Optional[float] = None
        self._closed = False
        self._aborted = False
        self._lat_seq = 0
        self._worker = threading.Thread(target=self._run,
                                        name="lgbt-torch-batcher",
                                        daemon=True)
        self._worker.start()

    def _labeled(self, name: str) -> str:
        key = self._labeled_keys.get(name)
        if key is None:
            key = self._labeled_keys[name] = obs.labeled_name(
                name, self._labels)
        return key

    def _inc(self, name: str, n: int = 1) -> None:
        """One registry series, and its labeled twin."""
        obs.inc(name, n)
        if self._labels:
            obs.inc(self._labeled(name), n)

    def queue_depth(self) -> int:
        """Pending (not yet picked up) requests."""
        with self._cond:
            return len(self._queue)

    def stalled_for_s(self) -> Optional[float]:
        """Seconds the worker has been inside the current device batch
        (None when idle): it grows only while one batch does not
        return, never under plain queueing load."""
        with self._cond:
            since = self._active_since
        return None if since is None else time.monotonic() - since

    # -- client side -----------------------------------------------------
    def submit(self, rows: np.ndarray, timeout: Optional[float] = None,
               deadline: Optional[float] = None):
        """Block until the batch holding ``rows`` is served; returns what
        ``predict_fn`` produced for this request's rows.  Raises
        :class:`QueueFull`, :class:`BatcherClosed` or
        :class:`DeadlineExpired` (``deadline`` is an absolute
        ``time.monotonic()`` instant); expired work is shed before it
        takes device time."""
        rows = np.ascontiguousarray(rows)
        if deadline is not None and time.monotonic() >= deadline:
            self._inc("serve_deadline_expired_total")
            raise DeadlineExpired("deadline expired before enqueue")
        req = _Pending(rows, deadline=deadline)
        with self._cond:
            if self._closed:
                obs.trace_end(req.tspan, args={"closed": True})
                raise BatcherClosed("MicroBatcher is closed")
            if self.max_queue and len(self._queue) >= self.max_queue:
                obs.trace_end(req.tspan, args={"shed": True})
                raise QueueFull(
                    f"queue at max_queue={self.max_queue} pending requests")
            self._queue.append(req)
            self._cond.notify_all()
        self._inc("serve_requests")
        self._inc("serve_rows", int(rows.shape[0]))
        wait_s = timeout
        if deadline is not None:
            left = deadline - time.monotonic()
            wait_s = left if wait_s is None else min(wait_s, left)
        if not req.done.wait(wait_s):
            # a timed-out request still queued is taken out: it would
            # hold batch capacity ahead of live requests
            with self._cond:
                settled = req.done.is_set()
                shed = not settled and req in self._queue
                if shed:
                    self._queue.remove(req)
            if not settled:
                expired = (deadline is not None
                           and time.monotonic() >= deadline)
                if shed:
                    # never picked up: the worker will not end its queue
                    # span (a picked-up request's ended at batch start)
                    obs.trace_end(
                        req.tspan,
                        args={"expired" if expired else "shed": True})
                if expired:
                    self._inc("serve_deadline_expired_total")
                    raise DeadlineExpired("deadline expired in queue")
                self._inc("serve_timeouts_shed")
                raise TimeoutError("predict request timed out")
        if req.error is not None:
            raise req.error
        self._note_latency((time.perf_counter() - req.t0) * 1000.0)
        return req.result

    def _fail_pending_locked(self) -> List[Tuple[_Pending, bool]]:
        """Detach every queued and in-flight request (cond held), as
        ``(request, still queued)``: only a still-queued request owns
        its queue span (the worker ended a picked-up one's)."""
        doomed = [(r, True) for r in self._queue if not r.done.is_set()]
        doomed += [(r, False) for r in self._active if not r.done.is_set()]
        self._queue.clear()
        return doomed

    @staticmethod
    def _complete_failed(doomed: Sequence[Tuple[_Pending, bool]],
                         error: BaseException) -> None:
        for req, still_queued in doomed:
            if still_queued:
                obs.trace_end(req.tspan, args={"failed": True})
            req.error = error
            req.done.set()

    def abort(self, error: Optional[BaseException] = None) -> None:
        """Fail every queued and in-flight request with ``error`` at
        once, without waiting for the worker (which may be wedged in
        ``predict_fn``); a re-admitted replica gets a fresh batcher."""
        error = error or BatcherClosed("MicroBatcher aborted")
        with self._cond:
            self._closed = True
            self._aborted = True
            doomed = self._fail_pending_locked()
            self._cond.notify_all()
        self._complete_failed(doomed, error)

    def close(self, drain: bool = True, join_timeout_s: float = 30.0) -> None:
        """Stop the worker; with ``drain`` queued requests are served
        first, otherwise they fail with :class:`BatcherClosed`.  A
        request left behind by a stalled worker is failed, never left
        hanging."""
        with self._cond:
            already_aborted = self._aborted
            self._closed = True
            if not drain:
                doomed = [(r, True) for r in self._queue
                          if not r.done.is_set()]
                self._queue.clear()
                self._complete_failed(doomed,
                                      BatcherClosed("MicroBatcher closed"))
            self._cond.notify_all()
        if already_aborted:
            return
        self._worker.join(timeout=join_timeout_s)
        if self._worker.is_alive():
            with self._cond:
                self._aborted = True
                doomed = self._fail_pending_locked()
            self._complete_failed(doomed, BatcherClosed(
                "MicroBatcher closed with a stalled worker"))

    # -- worker side -----------------------------------------------------
    def _shed_expired_locked(self) -> None:
        now = time.monotonic()
        expired = [r for r in self._queue
                   if r.deadline is not None and now >= r.deadline]
        if not expired:
            return
        self._queue[:] = [r for r in self._queue if r not in expired]
        for req in expired:
            obs.trace_end(req.tspan, args={"expired": True})
            req.error = DeadlineExpired("deadline expired in queue")
            req.done.set()
        self._inc("serve_deadline_expired_total", len(expired))

    def _take_batch(self) -> Optional[List[_Pending]]:
        """Wait for work, then gather until ``max_batch`` rows or the
        oldest request's coalescing deadline.  None on shutdown."""
        with self._cond:
            while True:
                self._shed_expired_locked()
                if self._queue:
                    break
                if self._closed:
                    return None
                self._cond.wait(timeout=0.1)
            deadline = self._queue[0].t0 + self.max_delay_s
            while not self._closed:
                rows = sum(r.rows.shape[0] for r in self._queue)
                left = deadline - time.perf_counter()
                if rows >= self.max_batch or left <= 0:
                    break
                self._cond.wait(timeout=left)
            self._shed_expired_locked()
            batch: List[_Pending] = []
            total = 0
            while self._queue:
                nxt = self._queue[0].rows.shape[0]
                if batch and total + nxt > self.max_batch:
                    break
                batch.append(self._queue.pop(0))
                total += nxt
            self._active = batch
            self._active_since = time.monotonic() if batch else None
            return batch

    def _run(self) -> None:
        with device_scope(self.device):
            while True:
                batch = self._take_batch()
                if batch is None:
                    return
                if batch:
                    self._serve(batch)

    def _serve(self, batch: List[_Pending]) -> None:
        try:
            with obs.span("Serve::batch") as sp:
                if sp.trace is not None:
                    # the many-to-one coalesce edges: each request's
                    # queue span ends here, linked into this batch
                    for req in batch:
                        obs.trace_link(req.tspan, sp.trace)
                        obs.trace_end(req.tspan)
                    sp.trace.args["coalesced"] = len(batch)
                rows = (batch[0].rows if len(batch) == 1 else
                        np.concatenate([r.rows for r in batch], axis=0))
                # the forest call: the walk kernel K4 on a card
                with obs.trace_span("Predict::forest",
                                    args={"rows": int(rows.shape[0])}):
                    out = self.predict_fn(rows)
            self._inc("serve_batches")
            self._inc("serve_batch_rows", int(rows.shape[0]))
            obs.set_gauge("serve_last_batch_rows", int(rows.shape[0]))
            off = 0
            for req in batch:
                n = req.rows.shape[0]
                req.result = _slice_rows(out, off, n)
                off += n
                req.done.set()
        except BaseException as exc:       # propagate to every waiter
            for req in batch:
                req.error = exc
                req.done.set()
        finally:
            with self._cond:
                self._active = []
                self._active_since = None

    _GAUGE_EVERY = 32

    def _note_latency(self, ms: float) -> None:
        """One ``serve_latency_seconds`` sample (and its labeled twin);
        the p50/p99 gauges are refreshed from the histogram on the first
        request and every ``_GAUGE_EVERY`` after."""
        obs.observe("serve_latency_seconds", ms / 1000.0)
        if self._labels:
            obs.observe(self._labeled("serve_latency_seconds"), ms / 1000.0)
        with self._lock:
            self._lat_seq += 1
            if self._lat_seq % self._GAUGE_EVERY != 1:
                return
        hist = obs.get_histogram("serve_latency_seconds")
        p50 = obs.histogram_quantile(hist, 0.50)
        p99 = obs.histogram_quantile(hist, 0.99)
        if p50 is not None and p99 is not None:
            obs.set_gauge("serve_latency_p50_ms", round(p50 * 1000.0, 3))
            obs.set_gauge("serve_latency_p99_ms", round(p99 * 1000.0, 3))


def _slice_rows(out, off: int, n: int):
    """One request's rows of a batched ``[K, N]`` result (or a tuple of
    them); rows are the last axis."""
    if isinstance(out, tuple):
        return tuple(_slice_rows(o, off, n) for o in out)
    return out[..., off:off + n]
