"""Batch-size ladder + request micro-batcher.

Port of the JAX package's serve/batcher.py.  Rows are padded up a small
ladder of power-of-two bucket sizes with a validity mask, which bounds
the shapes the device sees.  Nothing here compiles per bucket (the
kernels are built once), so the JAX package's ``CountingJit`` has no
counterpart.

``MicroBatcher`` coalesces concurrent ``submit()`` calls into one device
batch under a max-latency deadline: one worker thread waits up to
``max_delay_s`` from the oldest queued request, closes the batch at
``max_batch`` rows, runs ``predict_fn`` once on the concatenated rows
and splits the result back per request.  The worker enters
``torch.cuda.device(device)`` so its launches go to the forest's card.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class QueueFull(RuntimeError):
    """``submit()`` refused: the bounded queue holds ``max_queue``
    pending requests."""


class BatcherClosed(RuntimeError):
    """``submit()`` against a closed batcher, or a request failed by
    shutdown."""


class DeadlineExpired(RuntimeError):
    """The request's deadline passed before it could be served; expired
    work is shed before it takes device time."""


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
    __slots__ = ("rows", "done", "result", "error", "t0", "deadline")

    def __init__(self, rows: np.ndarray, deadline: Optional[float] = None):
        self.rows = rows
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.t0 = time.perf_counter()
        self.deadline = deadline      # absolute time.monotonic() instant


class MicroBatcher:
    """Coalesce concurrent predict requests into device batches.

    Counters (``stats()``): ``requests``/``rows`` at submit,
    ``batches``/``batch_rows`` per device batch, ``deadline_expired``
    and ``timeouts_shed``.  ``max_queue`` bounds the pending queue
    (0 = unbounded); a submit against a full queue raises
    :class:`QueueFull`."""

    def __init__(self, predict_fn: Callable[[np.ndarray], object],
                 max_batch: int = 8192, max_delay_s: float = 0.005,
                 max_queue: int = 0,
                 device: Optional[torch.device] = None):
        self.predict_fn = predict_fn
        self.max_batch = max(int(max_batch), 1)
        self.max_delay_s = max(float(max_delay_s), 0.0)
        self.max_queue = max(int(max_queue), 0)
        self.device = device
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: List[_Pending] = []
        self._active: List[_Pending] = []
        self._closed = False
        self._counts: Dict[str, int] = {
            "requests": 0, "rows": 0, "batches": 0, "batch_rows": 0,
            "deadline_expired": 0, "timeouts_shed": 0}
        self._worker = threading.Thread(target=self._run,
                                        name="lgbt-torch-batcher",
                                        daemon=True)
        self._worker.start()

    def _inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] += n

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {**self._counts, "queue_depth": len(self._queue)}

    # -- client side -----------------------------------------------------
    def submit(self, rows: np.ndarray, timeout: Optional[float] = None,
               deadline: Optional[float] = None):
        """Block until the batch holding ``rows`` is served; returns what
        ``predict_fn`` produced for this request's rows.  Raises
        :class:`QueueFull`, :class:`BatcherClosed` or
        :class:`DeadlineExpired` (``deadline`` is an absolute
        ``time.monotonic()`` instant)."""
        rows = np.ascontiguousarray(rows)
        if deadline is not None and time.monotonic() >= deadline:
            self._inc("deadline_expired")
            raise DeadlineExpired("deadline expired before enqueue")
        req = _Pending(rows, deadline=deadline)
        with self._cond:
            if self._closed:
                raise BatcherClosed("MicroBatcher is closed")
            if self.max_queue and len(self._queue) >= self.max_queue:
                raise QueueFull(
                    f"queue at max_queue={self.max_queue} pending requests")
            self._queue.append(req)
            self._counts["requests"] += 1
            self._counts["rows"] += int(rows.shape[0])
            self._cond.notify_all()
        wait_s = timeout
        if deadline is not None:
            left = deadline - time.monotonic()
            wait_s = left if wait_s is None else min(wait_s, left)
        if not req.done.wait(wait_s):
            with self._cond:
                settled = req.done.is_set()
                if not settled and req in self._queue:
                    self._queue.remove(req)
            if not settled:
                if deadline is not None and time.monotonic() >= deadline:
                    self._inc("deadline_expired")
                    raise DeadlineExpired("deadline expired in queue")
                self._inc("timeouts_shed")
                raise TimeoutError("predict request timed out")
        if req.error is not None:
            raise req.error
        return req.result

    def close(self, drain: bool = True, join_timeout_s: float = 30.0) -> None:
        """Stop the worker; with ``drain`` queued requests are served
        first, otherwise they fail with :class:`BatcherClosed`.  A
        request left behind by a stalled worker is failed, never left
        hanging."""
        with self._cond:
            self._closed = True
            if not drain:
                doomed, self._queue = self._queue, []
                for req in doomed:
                    req.error = BatcherClosed("MicroBatcher closed")
                    req.done.set()
            self._cond.notify_all()
        self._worker.join(timeout=join_timeout_s)
        if self._worker.is_alive():
            with self._cond:
                doomed = self._queue + self._active
                self._queue = []
            for req in doomed:
                if not req.done.is_set():
                    req.error = BatcherClosed(
                        "MicroBatcher closed with a stalled worker")
                    req.done.set()

    # -- worker side -----------------------------------------------------
    def _shed_expired_locked(self) -> None:
        now = time.monotonic()
        expired = [r for r in self._queue
                   if r.deadline is not None and now >= r.deadline]
        if not expired:
            return
        self._queue[:] = [r for r in self._queue if r not in expired]
        for req in expired:
            req.error = DeadlineExpired("deadline expired in queue")
            req.done.set()
        self._counts["deadline_expired"] += len(expired)

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
            return batch

    def _run(self) -> None:
        on_card = self.device is not None and self.device.type == "cuda"
        ctx = torch.cuda.device(self.device) if on_card \
            else contextlib.nullcontext()
        with ctx:
            while True:
                batch = self._take_batch()
                if batch is None:
                    return
                if batch:
                    self._serve(batch)

    def _serve(self, batch: List[_Pending]) -> None:
        try:
            rows = (batch[0].rows if len(batch) == 1 else
                    np.concatenate([r.rows for r in batch], axis=0))
            out = self.predict_fn(rows)
            self._inc("batches")
            self._inc("batch_rows", int(rows.shape[0]))
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


def _slice_rows(out, off: int, n: int):
    """One request's rows of a batched ``[K, N]`` result (or a tuple of
    them); rows are the last axis."""
    if isinstance(out, tuple):
        return tuple(_slice_rows(o, off, n) for o in out)
    return out[..., off:off + n]
