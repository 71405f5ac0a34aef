"""Serving fleet: per-device replicas, admission control, hot reload.

Port of the JAX package's serve/fleet.py over the port's
``CompiledForest`` (each replica serves through the forest-walk kernel
K4 on its own card):

- :class:`Replica` / :class:`ReplicaSet`: one frozen, warmed forest per
  device (:func:`fleet_devices`: the visible cards, capped by
  ``serve_replicas``; on the CPU ``serve_replicas`` copies, the test
  seam), each with its own micro-batcher whose worker launches on that
  device.
- **least-loaded dispatch**: :meth:`Fleet.submit` routes each request
  to the replica with the lowest outstanding work x EWMA service time.
- **admission control**: bounded per-replica queues
  (``serve_queue_depth``) and a fleet-wide in-flight cap
  (``serve_max_inflight``); past either a request is shed with
  :class:`Overloaded`, whose ``retry_after_s`` (the observed p50
  service time) the HTTP layer sends as ``429`` + ``Retry-After``
  (``serve_shed_total``).
- **zero-downtime hot reload**: :meth:`ModelManager.reload` builds and
  warms a new generation off the serving path, swaps it in under the
  fleet lock, then drains the old one (in-flight requests finish on the
  forest they started on) and closes its batchers.  Every response names
  the generation that served it.
- **canary routing**: an optional second :class:`ReplicaSet` takes
  ``serve_canary_weight`` of traffic through a deterministic
  weight-accumulator rotation (an exact split, no RNG); every serve
  series carries a ``model=`` label.
- **fault tolerance** (``serve/health.py``): per-replica health, a
  watchdog that ejects and probes, request deadlines (504 before any
  device time), hedged retries onto another replica up to
  ``serve_retry_limit``, and :class:`~.health.NoHealthyReplicas` (503)
  at zero dispatchable replicas.

Spans as in the JAX fleet: the timed ones (``Serve::reload``,
``Serve::drain``, ``Serve::eject``, ``Serve::probe``) land in the
``phase_seconds_*`` histograms; with the tracer armed each dispatch
attempt is a ``Serve::dispatch`` span and each retried attempt runs
under a ``Serve::hedge`` span, in the request's trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..device import DeviceLike, resolve_device
from ..utils import log
from ..utils.log import LightGBMError
from . import health as health_mod
from .batcher import DeadlineExpired, MicroBatcher, QueueFull
from .health import (EJECTED, HEALTHY, PROBATION, NoHealthyReplicas,
                     Watchdog)

# EWMA smoothing for per-replica service time: ~the last 10 requests
# dominate, old incidents decay instead of haunting the dispatch forever
_EWMA_ALPHA = 0.2

# a replica that has never served anything scores with this service time
# (seconds) so the comparison stays outstanding-count-driven until real
# measurements exist
_EWMA_FLOOR = 1e-4


class Overloaded(RuntimeError):
    """Admission control shed this request.  ``retry_after_s`` is the
    backoff hint (from the observed p50 service time) the HTTP layer
    renders as the ``Retry-After`` header."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class _ReplicaFault(Exception):
    """Internal: one dispatch attempt failed for a reason attributable
    to the chosen replica (predict raised, ejected mid-request, batcher
    closed).  Carries the original error for the hedging loop in
    :meth:`Fleet.submit`; never escapes it."""

    def __init__(self, replica_id: int, error: BaseException):
        super().__init__(f"replica {replica_id}: {error!r}")
        self.replica_id = int(replica_id)
        self.error = error


class FleetResult:
    """One served request: the prediction pair plus WHERE it ran —
    model / generation / replica are echoed in the HTTP response so a
    client (and the hot-reload test) can pin predictions to the forest
    that produced them."""

    __slots__ = ("raw", "out", "model", "generation", "replica")

    def __init__(self, raw, out, model: str, generation: int, replica: int):
        self.raw = raw
        self.out = out
        self.model = model
        self.generation = generation
        self.replica = replica


class Replica:
    """One forest pinned to one device, behind its own micro-batcher.

    ``inflight`` (dispatched, not yet answered — queued requests
    included) and ``ewma_service_s`` are the dispatcher's load signal;
    both are guarded by the owning Fleet's lock, not a lock of their
    own, so the pick-and-increment is one atomic step."""

    def __init__(self, forest, replica_id: int, model: str,
                 generation: int, *, max_batch: int, max_delay_s: float,
                 max_queue: int):
        self.forest = forest
        self.replica_id = int(replica_id)
        self.model = str(model)
        self.generation = int(generation)
        self.device = getattr(forest, "device", None)
        # batcher construction knobs, kept so a re-admitted replica can
        # build a FRESH batcher (the ejected one's worker may be wedged)
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_s)
        self.max_queue = int(max_queue)
        self.batcher = self.make_batcher()
        self.inflight = 0
        self.requests = 0
        self.ewma_service_s = 0.0
        # health state machine (serve/health.py; transitions under the
        # owning fleet's lock)
        self.health = HEALTHY
        self.consecutive_errors = 0
        self.errors = 0
        self.ejections = 0
        self.probation_left = 0
        self.probation_failed = False
        self.outlier_ticks = 0
        self.probe: Optional[Dict[str, Any]] = None
        self.probe_failures = 0
        self.next_probe_t = 0.0

    def make_batcher(self) -> MicroBatcher:
        return MicroBatcher(self.forest.batched_fn(),
                            max_batch=self.max_batch,
                            max_delay_s=self.max_delay_s,
                            max_queue=self.max_queue,
                            metric_labels={"model": self.model},
                            device=self.device)

    def eligible(self) -> bool:
        """Visible to dispatch (everything but ejected — suspect and
        probation replicas keep serving while the watchdog deliberates)."""
        return self.health != EJECTED

    def note_done(self, seconds: float) -> None:
        """Fold one completed request's service time into the EWMA
        (called under the fleet lock)."""
        self.requests += 1
        if self.ewma_service_s <= 0.0:
            self.ewma_service_s = float(seconds)
        else:
            self.ewma_service_s += _EWMA_ALPHA * (float(seconds)
                                                  - self.ewma_service_s)

    def load_score(self) -> float:
        """Expected wait behind this replica: outstanding requests
        (its own + one) times its smoothed service time.  A slow replica
        with the same backlog scores worse than a fast one."""
        return (self.inflight + 1) * max(self.ewma_service_s, _EWMA_FLOOR)

    def stats(self) -> Dict[str, Any]:
        return {
            "replica": self.replica_id,
            "model": self.model,
            "generation": self.generation,
            "device": str(self.device) if self.device is not None else None,
            "queue_depth": self.batcher.queue_depth(),
            "inflight": self.inflight,
            "requests": self.requests,
            "ewma_service_ms": round(self.ewma_service_s * 1000.0, 3),
            "health": self.health,
            "consecutive_errors": self.consecutive_errors,
            "errors": self.errors,
            "ejections": self.ejections,
        }


class ReplicaSet:
    """One model generation spread over the fleet's devices.

    ``outstanding`` counts dispatches currently holding a reference to
    this set (fleet-lock guarded); the drain after a hot swap waits for
    it to reach zero before closing the batchers, which is what makes
    "in-flight requests finish on the forest they started on" true
    rather than aspirational."""

    def __init__(self, replicas: Sequence[Replica], model: str,
                 generation: int, model_path: str = ""):
        if not replicas:
            raise ValueError("a ReplicaSet needs at least one replica")
        self.replicas = list(replicas)
        self.model = str(model)
        self.generation = int(generation)
        self.model_path = str(model_path)
        self.outstanding = 0

    @classmethod
    def build(cls, forest, devices: Sequence, model: str, generation: int,
              *, max_batch: int, max_delay_s: float, max_queue: int,
              warm: bool = True, model_path: str = "") -> "ReplicaSet":
        """Freeze one forest into a replica per device.  A ``None``
        device, and the first replica on ``forest``'s own device, reuse
        ``forest`` as it is; every other replica gets a ``to_device``
        copy (its own tables, so a fault injected into one replica stays
        there), warmed before the set takes traffic.

        Crash-safe: a failure mid-build (warmup OOM, a bad device)
        closes the batchers of every replica already built before
        re-raising, so an aborted hot reload leaks no worker threads and
        the serving generation is left exactly as it was."""
        replicas = []
        try:
            for i, dev in enumerate(devices):
                reuse = dev is None or (
                    i == 0 and str(dev) == str(getattr(forest, "device",
                                                       None)))
                f = forest if reuse else forest.to_device(dev)
                if warm:
                    f.warmup(max_bucket=max_batch)
                replicas.append(Replica(f, i, model, generation,
                                        max_batch=max_batch,
                                        max_delay_s=max_delay_s,
                                        max_queue=max_queue))
        except BaseException:
            for rep in replicas:
                rep.batcher.close(drain=False)
            raise
        return cls(replicas, model, generation, model_path=model_path)

    @property
    def num_features(self) -> int:
        return int(self.replicas[0].forest.num_features)

    def close(self, drain: bool = True) -> None:
        for rep in self.replicas:
            rep.batcher.close(drain=drain)


def fleet_devices(replicas: int = 0, device: DeviceLike = None) -> List:
    """The devices the fleet spreads over.  On a card: every visible
    card (``torch.cuda.device_count()``), capped by ``serve_replicas``
    when positive.  On the CPU (``device="cpu"``): ``serve_replicas``
    replicas there, one for 0 (the test seam: the JAX package's tests
    get theirs from forced CPU devices)."""
    dev = resolve_device(device)
    n = int(replicas)
    if dev.type == "cpu":
        return [dev] * max(n, 1)
    devs = [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]
    return devs[:n] if n > 0 else devs


class Fleet:
    """Replica dispatcher + admission controller + generation holder.

    Thread-safe: ``submit()`` is called from every HTTP handler thread;
    the routing decision, the in-flight accounting and generation swaps
    all happen under one condition variable (``_cond``), while the
    actual prediction wait happens inside the chosen replica's batcher
    with no fleet lock held."""

    def __init__(self, primary: ReplicaSet,
                 canary: Optional[ReplicaSet] = None,
                 canary_weight: float = 0.0, max_inflight: int = 0,
                 devices: Optional[Sequence] = None,
                 max_batch: int = 8192, max_delay_s: float = 0.005,
                 max_queue: int = 0, retry_limit: int = 2,
                 error_threshold: int = 3,
                 watchdog_interval_s: float = 0.0,
                 stall_s: float = 5.0, latency_outlier: float = 8.0):
        self._cond = threading.Condition()
        self._primary = primary
        self._canary = canary
        self.canary_weight = float(canary_weight)
        if not (0.0 <= self.canary_weight < 1.0):
            raise ValueError("canary_weight must be in [0, 1)")
        if canary is not None and canary.num_features != primary.num_features:
            raise LightGBMError(
                f"canary model takes {canary.num_features} features, the "
                f"primary takes {primary.num_features} — A/B routing needs "
                f"one request schema")
        self.max_inflight = max(int(max_inflight), 0)
        # generation-build knobs, reused by every later promote()
        self.devices = (list(devices) if devices is not None
                        else [r.device for r in primary.replicas])
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_s)
        self.max_queue = int(max_queue)
        # fault tolerance (serve/health.py):
        # hedged-retry budget per request + the health policy knobs
        self.retry_limit = max(int(retry_limit), 0)
        self.error_threshold = max(int(error_threshold), 1)
        self._inflight = 0
        self._canary_acc = 0.0
        self._gen_seq = max(primary.generation,
                            canary.generation if canary else 0)
        self._closed = False
        obs.set_gauge("serve_generation", primary.generation)
        obs.set_gauge("serve_replicas", len(primary.replicas))
        with self._cond:
            self._update_health_gauge_locked()
        self.watchdog: Optional[Watchdog] = None
        if watchdog_interval_s > 0:
            self.watchdog = Watchdog(self, interval_s=watchdog_interval_s,
                                     stall_s=stall_s,
                                     latency_outlier=latency_outlier)

    # -- construction ----------------------------------------------------
    @classmethod
    def build(cls, forest, devices: Optional[Sequence] = None,
              replicas: int = 0, model: str = "primary",
              canary_forest=None, canary_weight: float = 0.0,
              max_batch: int = 8192, max_delay_s: float = 0.005,
              max_queue: int = 0, max_inflight: int = 0,
              warm: bool = True, retry_limit: int = 2,
              error_threshold: int = 3,
              watchdog_interval_s: float = 0.0,
              stall_s: float = 5.0,
              latency_outlier: float = 8.0) -> "Fleet":
        """Spread ``forest`` over ``devices`` (default: the local
        devices, capped by ``replicas``) and front it with a dispatcher;
        ``canary_forest`` adds a second model at ``canary_weight``
        traffic share on the same devices."""
        if devices is None:
            devices = fleet_devices(replicas, getattr(forest, "device",
                                                      None))
        primary = ReplicaSet.build(forest, devices, model, 1,
                                   max_batch=max_batch,
                                   max_delay_s=max_delay_s,
                                   max_queue=max_queue, warm=warm)
        canary = None
        if canary_forest is not None:
            canary = ReplicaSet.build(canary_forest, devices, "canary", 2,
                                      max_batch=max_batch,
                                      max_delay_s=max_delay_s,
                                      max_queue=max_queue, warm=warm)
        return cls(primary, canary, canary_weight=canary_weight,
                   max_inflight=max_inflight, devices=devices,
                   max_batch=max_batch, max_delay_s=max_delay_s,
                   max_queue=max_queue, retry_limit=retry_limit,
                   error_threshold=error_threshold,
                   watchdog_interval_s=watchdog_interval_s,
                   stall_s=stall_s, latency_outlier=latency_outlier)

    @classmethod
    def from_forest(cls, forest, max_batch: int = 8192,
                    max_delay_s: float = 0.005) -> "Fleet":
        """Single-replica compatibility wrapper: the forest serves
        as-is on its current device, unbounded queue, no in-flight cap —
        exactly the pre-fleet ``PredictServer(forest)`` behavior."""
        return cls.build(forest, devices=[None], max_batch=max_batch,
                         max_delay_s=max_delay_s, warm=False)

    # -- introspection ---------------------------------------------------
    @property
    def primary_forest(self):
        with self._cond:
            return self._primary.replicas[0].forest

    @property
    def num_features(self) -> int:
        with self._cond:
            return self._primary.num_features

    @property
    def generation(self) -> int:
        with self._cond:
            return self._primary.generation

    def _live_sets(self) -> List[ReplicaSet]:
        """The replica sets currently taking traffic (caller holds the
        fleet lock) — what the watchdog evaluates and stats() reports."""
        return [s for s in (self._primary, self._canary) if s is not None]

    def _update_health_gauge_locked(self) -> None:
        obs.set_gauge("serve_healthy_replicas",
                      health_mod.healthy_count(self._live_sets()))

    def warm_all(self, should_abort: Optional[Callable[[], bool]] = None
                 ) -> bool:
        """Warm every live replica's forest on its own device, bucket by
        bucket up to the one a ``max_batch``-row request dispatches to
        (the HTTP server's background warm: readiness comes up only after
        this returns True).  ``should_abort`` is polled between buckets,
        so a shutdown mid-warm stops after the current bucket's build
        and launches.  Returns False when aborted."""
        with self._cond:
            reps = [rep for s in self._live_sets() for rep in s.replicas]
        for rep in reps:
            ladder = rep.forest.ladder
            # bucket_for rounds up: a max_batch between two rungs sends
            # its largest requests to the rung above, which must be warm
            cap = ladder.bucket_for(self.max_batch)
            sizes = [s for s in ladder.sizes if s <= cap] \
                or list(ladder.sizes)[:1]
            for s in sizes:
                if should_abort is not None and should_abort():
                    return False
                rep.forest.warmup(buckets=[s])
        return True

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            sets = self._live_sets()
            return {
                "generation": self._primary.generation,
                "inflight": self._inflight,
                "max_inflight": self.max_inflight,
                "canary_weight": self.canary_weight,
                "retry_limit": self.retry_limit,
                "healthy_replicas": health_mod.healthy_count(sets),
                "models": {
                    s.model: {"generation": s.generation,
                              "model_path": s.model_path,
                              "replicas": len(s.replicas)}
                    for s in sets},
                "replicas": [rep.stats() for s in sets
                             for rep in s.replicas],
            }

    # -- dispatch --------------------------------------------------------
    def _route(self) -> ReplicaSet:
        """Primary vs canary: a deterministic weight accumulator — the
        canary takes exactly its share (every 1/w-th request at weight
        w), no RNG, so the split test is exact and replayable."""
        if self._canary is None or self.canary_weight <= 0.0:
            return self._primary
        self._canary_acc += self.canary_weight
        if self._canary_acc >= 1.0:
            self._canary_acc -= 1.0
            return self._canary
        return self._primary

    def _retry_after_s(self) -> float:
        """Backoff hint for shed requests: one observed p50 service
        time — by then at least half the in-flight work has drained, so
        a retry has a real slot to land in."""
        p50 = obs.histogram_quantile(
            obs.get_histogram("serve_latency_seconds"), 0.50)
        return max(float(p50 or 0.0), 0.05)

    def _shed(self, model: str, reason: str) -> Overloaded:
        obs.inc("serve_shed_total")
        obs.inc(obs.labeled_name("serve_shed_total", model=model))
        return Overloaded(reason, self._retry_after_s())

    def _note_error_locked(self, rep: Replica) -> None:
        """One replica-attributable request failure (fleet lock held):
        enough consecutive errors — or ANY error on probation — marks
        the replica suspect; the watchdog does the ejecting."""
        rep.consecutive_errors += 1
        rep.errors += 1
        obs.inc("serve_request_errors_total")
        obs.inc(obs.labeled_name("serve_request_errors_total",
                                 model=rep.model))
        if rep.health == EJECTED:
            return
        if rep.health == PROBATION:
            # one strike on probation: the sticky flag survives the
            # SUSPECT transition so the watchdog ejects it even if a
            # later success resets consecutive_errors
            rep.probation_failed = True
            rep.health = health_mod.SUSPECT
        elif rep.consecutive_errors >= self.error_threshold:
            rep.health = health_mod.SUSPECT

    def _note_ok_locked(self, rep: Replica, dt: float) -> None:
        rep.note_done(dt)
        rep.consecutive_errors = 0
        if rep.health == PROBATION:
            rep.probation_left -= 1
            if rep.probation_left <= 0:
                rep.health = HEALTHY
                self._update_health_gauge_locked()

    def submit(self, rows: np.ndarray, timeout: Optional[float] = None,
               deadline_s: Optional[float] = None) -> FleetResult:
        """Route one request: canary split, least-loaded replica pick
        among NON-EJECTED replicas, admission check — then block in that
        replica's batcher.  Raises :class:`Overloaded` on shed (never
        queues past the bounds), :class:`DeadlineExpired` when
        ``deadline_s`` (absolute ``time.monotonic()``) has passed —
        checked BEFORE any device time is spent — and
        :class:`~.health.NoHealthyReplicas` when the routed model has
        zero dispatchable replicas (503, never a hang).

        A replica-attributable failure (predict raised, replica ejected
        mid-request, batcher closed under it) is HEDGED: retried on a
        different replica up to ``retry_limit`` times, each retry under
        a ``Serve::hedge`` span and counted in ``serve_retries_total``."""
        tried: set = set()
        rs_holder: List[Optional[ReplicaSet]] = [None]
        attempt = 0
        last_fault: Optional[_ReplicaFault] = None
        while True:
            # no explicit expiry check here: the chosen replica's
            # batcher pre-checks the deadline before enqueue (and counts
            # the shed ONCE, base + model= labeled series), so an
            # expired request — fresh or mid-hedge — still never
            # reaches the device
            hedge = (obs.trace_span(
                "Serve::hedge",
                args={"attempt": attempt,
                      "failed_replica": last_fault.replica_id})
                if attempt else contextlib.nullcontext())
            try:
                with hedge:
                    return self._submit_once(rows, timeout, deadline_s,
                                             tried, rs_holder)
            except _ReplicaFault as fault:
                last_fault = fault
                attempt += 1
                rs = rs_holder[0]
                with self._cond:
                    has_fresh = rs is not None and any(
                        r.eligible() and r.replica_id not in tried
                        for r in rs.replicas)
                if attempt > self.retry_limit or not has_fresh:
                    # no budget left, or no replica this request hasn't
                    # already failed on — re-running the identical
                    # predict on a known-bad replica only multiplies
                    # error latency and inflates its error count
                    raise fault.error
                obs.inc("serve_retries_total")
                if rs is not None:
                    obs.inc(obs.labeled_name("serve_retries_total",
                                             model=rs.model))
                log.debug("serve: hedging request off replica %d "
                          "(attempt %d/%d): %r", fault.replica_id,
                          attempt, self.retry_limit, fault.error)

    def _submit_once(self, rows: np.ndarray, timeout: Optional[float],
                     deadline_s: Optional[float], tried: set,
                     rs_holder: List[Optional[ReplicaSet]]) -> FleetResult:
        """One dispatch attempt.  Replica-attributable failures are
        wrapped in :class:`_ReplicaFault` for the hedging loop; shed
        conditions (Overloaded / QueueFull / deadline / client timeout)
        propagate unwrapped — retrying those on another replica would
        amplify the very overload they signal."""
        # the routing decision, a child of the request's (or hedge's)
        # span; the batcher's queue wait is its sibling
        with obs.trace_span("Serve::dispatch") as d:
            with self._cond:
                if self._closed:
                    raise RuntimeError("fleet is closed")
                rs = rs_holder[0]
                if rs is None:
                    rs = self._route()
                else:
                    # hedges stay on the model the request was routed
                    # to, but a concurrent reload may have swapped the
                    # set: re-resolve by slot so the retry lands on the
                    # LIVE generation
                    live = (self._canary if rs.model == "canary"
                            else self._primary)
                    rs = live if live is not None else rs
                rs_holder[0] = rs
                if self.max_inflight and self._inflight >= self.max_inflight:
                    raise self._shed(
                        rs.model,
                        f"fleet at max in-flight ({self.max_inflight})")
                cands = [r for r in rs.replicas if r.eligible()]
                if not cands and rs is self._canary:
                    # the canary slice must not become a hard 503 share
                    # while healthy PRIMARY capacity sits idle: canary
                    # traffic is best-effort A/B, so it falls back (the
                    # reverse never happens — primary traffic is not
                    # silently routed to an unvetted canary)
                    fallback = [r for r in self._primary.replicas
                                if r.eligible()]
                    if fallback:
                        obs.inc("serve_canary_fallback_total")
                        log.warn_once(
                            "serve_canary_fallback",
                            "serve: canary has 0 dispatchable replicas; "
                            "its traffic share falls back to the primary "
                            "until a probe re-admits one")
                        rs = rs_holder[0] = self._primary
                        cands = fallback
                if not cands:
                    obs.inc("serve_unavailable_total")
                    raise NoHealthyReplicas(
                        f"model {rs.model!r}: 0 of {len(rs.replicas)} "
                        f"replicas dispatchable")
                fresh = [r for r in cands if r.replica_id not in tried]
                rep = min(fresh or cands, key=Replica.load_score)
                rs.outstanding += 1
                rep.inflight += 1
                self._inflight += 1
            if d is not None:
                d.args.update(model=rs.model, generation=rs.generation,
                              replica=rep.replica_id)
        t0 = time.perf_counter()
        served = False
        failed = None
        try:
            raw, out = rep.batcher.submit(rows, timeout=timeout,
                                          deadline=deadline_s)
            served = True
            return FleetResult(raw, out, rs.model, rs.generation,
                               rep.replica_id)
        except QueueFull as exc:
            raise self._shed(
                rs.model, f"replica {rep.replica_id}: {exc}") from exc
        except (DeadlineExpired, Overloaded):
            raise
        except TimeoutError:
            # the client's patience ran out — NOT a replica indictment:
            # under fleet-wide overload every replica times out, and
            # counting those as errors would eject the whole (healthy)
            # fleet one replica at a time.  Genuine stragglers are the
            # latency-outlier and stall detectors' job.
            raise
        except Exception as exc:
            # predict raised / replica ejected mid-request / batcher
            # closed under us: hedge-able
            failed = True
            tried.add(rep.replica_id)
            raise _ReplicaFault(rep.replica_id, exc) from exc
        finally:
            dt = time.perf_counter() - t0
            with self._cond:
                rs.outstanding -= 1
                rep.inflight -= 1
                self._inflight -= 1
                if served:
                    # sheds/timeouts return in ~0s; folding them into
                    # the EWMA would make an overloaded replica look
                    # fast and attract MORE traffic
                    self._note_ok_locked(rep, dt)
                elif failed:
                    self._note_error_locked(rep)
                self._cond.notify_all()

    # -- generations -----------------------------------------------------
    def promote(self, forest, target: str = "primary",
                model_path: str = "") -> ReplicaSet:
        """Swap a new generation in for ``target`` (``primary`` or
        ``canary``).  Build + warmup happen OFF the serving path (the
        live set keeps taking traffic), the pointer swap is atomic under
        the fleet lock, and the old set drains before its batchers
        close — zero requests fail across the swap."""
        if target not in ("primary", "canary"):
            raise ValueError(f"unknown reload target {target!r}")
        current = self._primary if target == "primary" else self._canary
        if (target == "canary" and current is None
                and self.canary_weight <= 0.0):
            raise LightGBMError(
                "no canary slot: start the server with serve_canary_weight "
                "> 0 to route traffic to one")
        with self._cond:
            # the surviving OTHER set (if any) pins the request schema:
            # both live models must take the same feature width
            other = self._canary if target == "primary" else self._primary
            if other is not None \
                    and int(forest.num_features) != other.num_features:
                raise LightGBMError(
                    f"reloaded {target} takes {forest.num_features} "
                    f"features, the live {other.model} takes "
                    f"{other.num_features} — A/B routing needs one "
                    f"request schema")
            # provisional id: committed only at swap time, so a build
            # that fails (warmup OOM, bad device) leaves no gap in the
            # generation sequence
            gen = self._gen_seq + 1
        model = "primary" if target == "primary" else "canary"
        new_set = ReplicaSet.build(
            forest, self.devices, model, gen, max_batch=self.max_batch,
            max_delay_s=self.max_delay_s, max_queue=self.max_queue,
            warm=True, model_path=model_path)
        with self._cond:
            if gen <= self._gen_seq:
                # a concurrent promote landed first (ModelManager
                # serializes reloads, but promote() is public API):
                # renumber before installing — generation is metadata on
                # the set/replicas, nothing compiled depends on it
                gen = self._gen_seq + 1
                new_set.generation = gen
                for rep in new_set.replicas:
                    rep.generation = gen
            self._gen_seq = gen
            if target == "primary":
                old, self._primary = self._primary, new_set
                obs.set_gauge("serve_generation", gen)
            else:
                old, self._canary = self._canary, new_set
            self._update_health_gauge_locked()
        log.info("serve: generation %d (%s) live on %d replica(s); "
                 "draining generation %s", gen, model,
                 len(new_set.replicas),
                 old.generation if old is not None else "-")
        with obs.span("Serve::drain"):
            self._drain(old)
        obs.inc("serve_reloads")
        return new_set

    def drop_canary(self) -> bool:
        """Detach the canary set from routing (atomic under the fleet
        lock) and drain it off-path — the rollback half of the guarded
        lifecycle (serve/lifecycle.py), also run after a promote so the
        old canary batchers close.  In-flight canary requests finish on
        the forest they started on; new traffic routes 100% primary from
        the instant the pointer clears.  Returns False when no canary
        was live."""
        with self._cond:
            old, self._canary = self._canary, None
            self._canary_acc = 0.0
            if old is not None:
                self._update_health_gauge_locked()
        if old is None:
            return False
        log.info("serve: canary generation %d detached from routing; "
                 "draining", old.generation)
        with obs.span("Serve::drain"):
            self._drain(old)
        obs.inc("serve_canary_dropped_total")
        return True

    def canary_snapshot(self) -> Optional[Tuple[Any, str, int]]:
        """``(forest, model_path, generation)`` of the live canary set,
        or None — what the lifecycle controller promotes."""
        with self._cond:
            rs = self._canary
            if rs is None:
                return None
            return (rs.replicas[0].forest, rs.model_path, rs.generation)

    def has_canary(self) -> bool:
        with self._cond:
            return self._canary is not None

    def _drain(self, rs: Optional[ReplicaSet],
               timeout_s: float = 120.0) -> None:
        """Wait out every dispatch still holding ``rs`` (they finish on
        the forest they started on), then close its batchers."""
        if rs is None:
            return
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while rs.outstanding > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    log.warning(
                        "serve: drain of generation %d timed out with %d "
                        "request(s) still in flight", rs.generation,
                        rs.outstanding)
                    break
                self._cond.wait(timeout=min(left, 1.0))
        rs.close(drain=True)
        obs.inc("serve_generations_drained")

    def close(self, drain: bool = True) -> None:
        """Stop dispatching, stop the health watchdog, and close every
        batcher (with ``drain``, queued requests are served first)."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            sets = self._live_sets()
        if self.watchdog is not None:
            self.watchdog.close()
        for s in sets:
            s.close(drain=drain)


class ModelManager:
    """Zero-downtime model swaps for one Fleet.

    ``reload(path)`` loads the model file, freezes a CompiledForest with
    the fleet's bucket ladder on the fleet's first device, and promotes
    it, serialized under one lock so two concurrent ``POST /reload``s
    cannot interleave.  ``loader`` is injectable (tests, callers that
    hold a booster).

    Crash-safe both ways: a reload that fails before the swap (an
    unreadable or corrupt file, a width mismatch against the other live
    model, a warmup that raises) leaves the serving generation as it was
    (``ReplicaSet.build`` closes half-built replicas); with a
    ``state_file`` every successful swap records the model path now
    serving, atomically (tmp file + ``os.replace``), and a restarted
    server re-serves that last-good model (``restore_path``).
    """

    def __init__(self, fleet: Fleet,
                 loader: Optional[Callable[[str], Any]] = None,
                 params: Optional[Dict[str, Any]] = None,
                 buckets: Optional[Sequence[int]] = None,
                 state_file: Optional[str] = None):
        self.fleet = fleet
        self._loader = loader or self._load_model_file
        self._params = dict(params or {})
        self._buckets = list(buckets) if buckets else None
        self.state_file = str(state_file) if state_file else None
        self._reload_lock = threading.Lock()
        # serializes every read-modify-write of the state file (reloads
        # and the lifecycle controller's records run on other threads)
        self._state_lock = threading.Lock()

    def _load_model_file(self, path: str):
        from ..basic import Booster
        from .forest import CompiledForest

        live = self.fleet.primary_forest
        booster = Booster(params=dict(self._params), model_file=path,
                          device=live.device)
        buckets = self._buckets
        if buckets is None:
            # the live ladder: the new generation warms exactly the
            # buckets requests route to
            buckets = list(live.ladder.sizes)
        return CompiledForest.from_booster(
            booster, buckets=buckets,
            serve_walk=self._params.get("serve_walk"),
            quantize_leaves=self._params.get("serve_quantize_leaves"))

    def reload(self, model_path: str, target: str = "primary") -> int:
        """Hot-swap ``target`` to the model at ``model_path``; returns
        the new generation id once the old generation has drained.  Any
        failure before the atomic swap leaves the old generation
        serving, untouched."""
        with self._reload_lock:
            with obs.span("Serve::reload"):
                t0 = time.perf_counter()
                forest = self._loader(model_path)
                # the reload lock holds one build+warm+swap at a time;
                # nothing on the serving path takes it
                new_set = self.fleet.promote(
                    forest, target=target, model_path=str(model_path))
                log.info("serve: reload of %s -> generation %d took %.2fs",
                         model_path, new_set.generation,
                         time.perf_counter() - t0)
            self.note_good(str(model_path), target=target,
                           generation=new_set.generation)
            return new_set.generation

    # -- last-good model state (crash restore) ---------------------------
    def note_good(self, model_path: str, target: str = "primary",
                  generation: int = 0) -> None:
        """Record ``model_path`` as the last model that successfully
        served ``target``.  Atomic (tmp + ``os.replace``) and
        best-effort: a state write failure warns, it never fails the
        reload that already succeeded."""
        def mutate(state: Dict[str, Any]) -> None:
            state[str(target)] = {"model": str(model_path),
                                  "generation": int(generation),
                                  "t": round(time.time(), 3)}
        self._write_state(mutate)

    def update_state(self, key: str, value: Any) -> None:
        """Record an arbitrary slot in the state file (the lifecycle
        controller persists its phase/cooldown under ``"lifecycle"``)."""
        self._write_state(lambda state: state.__setitem__(str(key), value))

    def clear_slot(self, target: str) -> None:
        """Forget a slot.  Rollback and post-promote both clear the
        ``canary`` entry so a restart can never resurrect an unvetted
        model."""
        self._write_state(lambda state: state.pop(str(target), None))

    def _write_state(self, mutate: Callable[[Dict[str, Any]], None]) -> None:
        """One serialized read-modify-write of the state file, written
        atomically (``utils/diskguard.write_file_atomic``).  A failed
        write is counted (``sink_write_errors_serve_state``) and warned,
        the last-good file is kept, and the next write retries."""
        if not self.state_file:
            return
        from ..utils import diskguard
        with self._state_lock:
            try:
                state = self.read_state(self.state_file)
                mutate(state)
                diskguard.write_file_atomic(
                    self.state_file, json.dumps(state).encode(),
                    sink="serve_state", fsync=False)
            except OSError as exc:
                diskguard.note_sink_error(
                    "serve_state", self.state_file, exc,
                    action="the last-good state file is kept; the next "
                    "successful write retries")

    @staticmethod
    def read_state(state_file: str) -> Dict[str, Any]:
        """Parse a serve state file (missing/corrupt -> empty dict: a
        damaged state file must degrade to the boot model, not kill the
        server)."""
        try:
            with open(state_file) as fh:
                state = json.load(fh)
            return state if isinstance(state, dict) else {}
        except (OSError, ValueError):
            return {}

    @staticmethod
    def restore_path(state_file: Optional[str],
                     target: str = "primary") -> Optional[str]:
        """The last-good model path for ``target`` if the state file
        names one that still exists on disk (else None — boot from
        ``input_model``)."""
        if not state_file:
            return None
        entry = ModelManager.read_state(state_file).get(str(target))
        if not isinstance(entry, dict):
            return None          # hand-edited/foreign slot: degrade
        path = entry.get("model")
        if not isinstance(path, str) or not path:
            return None
        if os.path.exists(path):
            return path
        log.warning("serve: last-good model %s from %s no longer "
                    "exists; booting from input_model", path, state_file)
        return None
