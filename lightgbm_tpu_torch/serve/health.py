"""Replica health: state machine, watchdog, synthetic probes.

Port of the JAX package's serve/health.py; the same states, rules and
counters over the port's :class:`~.fleet.Replica`:

- **state machine** (per replica)::

      healthy ──errors/stall/latency──▶ suspect ──watchdog──▶ ejected
         ▲                                                       │
         │  probation_successes clean requests          probe succeeds
         └─────────────── probation ◀────────────────────────────┘

  ``healthy``, ``suspect`` and ``probation`` replicas take traffic;
  ``ejected`` ones are invisible to dispatch.  One error on probation
  re-suspects at once.
- **detection**, by a :class:`Watchdog` daemon thread every
  ``interval_s``: ``serve_error_threshold`` consecutive request errors
  (one on probation), the batcher's worker inside one device batch for
  more than ``serve_stall_ms`` (a wedged replica never returns from
  predict; queue wait under load does not count), and an EWMA service
  time above ``serve_latency_outlier`` x the fleet median for two ticks.
- **containment**: ejection (``serve_ejections_total``) takes the
  replica out of dispatch and aborts its batcher, so its queued and
  in-flight requests fail over to the survivors through the fleet's
  hedged retries; at zero dispatchable replicas dispatch raises
  :class:`NoHealthyReplicas` (HTTP 503, never a hang).
- **recovery**: each tick the watchdog launches one synthetic probe (a
  zero row through the replica's own predict path, in a throwaway
  thread, so a still-wedged replica hangs the probe and not the
  watchdog) with exponential backoff between failures.  Success
  re-admits the replica on a fresh micro-batcher in ``probation``;
  ``PROBATION_SUCCESSES`` clean requests later it is ``healthy``.

Every transition happens under the owning fleet's condition variable,
the lock the dispatcher takes.
"""

from __future__ import annotations

import threading
import time
from typing import List, Tuple

import numpy as np

from .. import obs
from ..utils import log
from .batcher import device_scope

# state-machine states (stored on Replica.health)
HEALTHY = "healthy"
SUSPECT = "suspect"
EJECTED = "ejected"
PROBATION = "probation"

# clean requests a re-admitted replica must serve before it counts as
# fully healthy again (one error meanwhile re-suspects it)
PROBATION_SUCCESSES = 3

# ticks a latency outlier must persist before ejection (one straggler
# batch inflates the EWMA for a moment; a wedged device stays inflated)
OUTLIER_TICKS = 2

# probe backoff: first retry after one interval, doubling up to this cap
PROBE_BACKOFF_MAX_S = 30.0


class ReplicaEjected(RuntimeError):
    """Injected into a replica's queued/in-flight requests at ejection;
    the fleet dispatcher hedges these onto a surviving replica."""


class NoHealthyReplicas(RuntimeError):
    """Dispatch found zero non-ejected replicas for the routed model.
    The HTTP layer renders this as 503 — degrading to *failing fast*,
    never to hanging."""


class Watchdog:
    """Health evaluator + ejector + prober for one :class:`~.fleet.Fleet`.

    Runs as a daemon thread at ``interval_s``; every transition happens
    under ``fleet._cond``.  ``close()`` stops it (idempotent)."""

    def __init__(self, fleet, interval_s: float = 0.25,
                 stall_s: float = 5.0, latency_outlier: float = 8.0,
                 probation_successes: int = PROBATION_SUCCESSES):
        self.fleet = fleet
        self.interval_s = max(float(interval_s), 0.01)
        self.stall_s = float(stall_s)
        self.latency_outlier = float(latency_outlier)
        self.probation_successes = int(probation_successes)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="lgbt-serve-watchdog",
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    # -- loop ------------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as exc:  # pragma: no cover - never die silently
                log.warn_once("serve_watchdog_tick",
                              "serve watchdog tick failed: %r", exc)

    def tick(self) -> None:
        """One evaluation pass (public so tests can drive it without
        waiting out the interval)."""
        to_eject, to_probe = self._evaluate()
        for rep, reason in to_eject:
            self.eject(rep, reason)
        for rep in to_probe:
            self._launch_probe(rep)
        self._reap_probes()

    # -- detection -------------------------------------------------------
    def _evaluate(self) -> Tuple[List[tuple], List]:
        fleet = self.fleet
        now = time.monotonic()
        to_eject: List[tuple] = []
        to_probe: List = []
        with fleet._cond:
            for rs in fleet._live_sets():
                eligible = [r for r in rs.replicas if r.health != EJECTED]
                ewmas = sorted(r.ewma_service_s for r in eligible
                               if r.ewma_service_s > 0.0)
                # lower-middle median: in a 2-replica fleet the straggler
                # must be compared against its healthy peer, not itself
                med = ewmas[(len(ewmas) - 1) // 2] if ewmas else 0.0
                for rep in eligible:
                    # wedge signal: how long the batcher's worker has
                    # been inside ONE device batch — queue wait under
                    # plain overload does not count, so load cannot
                    # cascade into ejections of healthy replicas
                    stuck = rep.batcher.stalled_for_s()
                    stalled = (self.stall_s > 0 and stuck is not None
                               and stuck > self.stall_s)
                    errored = (rep.consecutive_errors
                               >= fleet.error_threshold
                               or rep.probation_failed)
                    outlier = (self.latency_outlier > 0 and med > 0.0
                               and len(eligible) >= 2
                               and rep.ewma_service_s
                               > self.latency_outlier * med)
                    if stalled or errored:
                        rep.health = SUSPECT
                        to_eject.append(
                            (rep, "stalled in-flight request"
                             if stalled else "consecutive errors"))
                    elif outlier:
                        rep.health = SUSPECT
                        rep.outlier_ticks += 1
                        if rep.outlier_ticks >= OUTLIER_TICKS:
                            to_eject.append((rep, "latency outlier"))
                    else:
                        rep.outlier_ticks = 0
                        if rep.health == SUSPECT:
                            # every indictment cleared: suspect heals —
                            # back to PROBATION if it was still serving
                            # out its probation (the clean-request gate
                            # must not be skippable via a suspect hop)
                            rep.health = (PROBATION
                                          if rep.probation_left > 0
                                          else HEALTHY)
                for rep in rs.replicas:
                    if rep.health == EJECTED and rep.probe is None \
                            and now >= rep.next_probe_t:
                        to_probe.append(rep)
        return to_eject, to_probe

    # -- containment -----------------------------------------------------
    def eject(self, rep, reason: str) -> None:
        """Remove ``rep`` from dispatch and fail its queued/in-flight
        work over to the survivors (via the dispatcher's hedged
        retries)."""
        with obs.span("Serve::eject"):
            with self.fleet._cond:
                if rep.health == EJECTED:
                    return
                rep.health = EJECTED
                rep.ejections += 1
                rep.outlier_ticks = 0
                rep.probation_failed = False
                rep.probe = None
                rep.probe_failures = 0
                rep.next_probe_t = 0.0
                batcher = rep.batcher
                self.fleet._update_health_gauge_locked()
            batcher.abort(ReplicaEjected(
                f"replica {rep.replica_id} ({rep.model}) ejected: {reason}"))
        obs.inc("serve_ejections_total")
        obs.inc(obs.labeled_name("serve_ejections_total", model=rep.model))
        log.warning("serve: ejected replica %d (%s, generation %d): %s",
                    rep.replica_id, rep.model, rep.generation, reason)

    # -- recovery --------------------------------------------------------
    def _launch_probe(self, rep) -> None:
        """Synthetic probe in a throwaway daemon thread: a wedged
        replica hangs the probe (its slot stays occupied, so no probe
        pile-up), not the watchdog."""
        state = {"done": threading.Event(), "ok": False, "error": None}
        # probe slot assignment under the fleet lock like every other
        # Replica field the watchdog and dispatcher share — the probe
        # attrs must not be the one family touched bare
        with self.fleet._cond:
            rep.probe = state

        def run():
            try:
                with obs.span("Serve::probe"), device_scope(rep.device):
                    fn = rep.forest.batched_fn()
                    n_feat = max(int(getattr(rep.forest,
                                             "num_features", 1)), 1)
                    fn(np.zeros((1, n_feat), np.float32))
                state["ok"] = True
            except Exception as exc:
                state["error"] = exc
            finally:
                state["done"].set()

        threading.Thread(target=run, daemon=True,
                         name=f"lgbt-serve-probe-{rep.replica_id}").start()

    def _reap_probes(self) -> None:
        now = time.monotonic()
        # all probe bookkeeping (slot clear, failure count, next-probe
        # schedule) under the fleet lock — the same lock that guards
        # these fields at ejection; counters and logging follow outside
        reaped = []
        with self.fleet._cond:
            for rs in self.fleet._live_sets():
                for rep in rs.replicas:
                    if rep.probe is None or not rep.probe["done"].is_set():
                        continue
                    state, rep.probe = rep.probe, None
                    backoff = 0.0
                    if not state["ok"]:
                        rep.probe_failures += 1
                        backoff = min(
                            self.interval_s * (2 ** rep.probe_failures),
                            PROBE_BACKOFF_MAX_S)
                        rep.next_probe_t = now + backoff
                    reaped.append((rep, state, backoff))
        for rep, state, backoff in reaped:
            obs.inc("serve_probes_total")
            if state["ok"]:
                self._readmit(rep)
            else:
                obs.inc("serve_probe_failures_total")
                log.warning("serve: probe of ejected replica %d (%s) "
                            "failed (%r); next probe in %.2fs",
                            rep.replica_id, rep.model, state["error"],
                            backoff)

    def _readmit(self, rep) -> None:
        """Probe succeeded: fresh batcher (the old one was aborted and
        its worker may still be wedged), probation traffic share."""
        batcher = rep.make_batcher()
        with self.fleet._cond:
            rep.batcher = batcher
            rep.health = PROBATION
            rep.consecutive_errors = 0
            rep.probation_failed = False
            rep.probation_left = self.probation_successes
            rep.ewma_service_s = 0.0   # forget the wedged-era signal
            self.fleet._update_health_gauge_locked()
        obs.inc("serve_readmissions_total")
        obs.inc(obs.labeled_name("serve_readmissions_total",
                                 model=rep.model))
        log.info("serve: re-admitted replica %d (%s) on probation after "
                 "successful probe", rep.replica_id, rep.model)


def healthy_count(replica_sets) -> int:
    """Replicas currently visible to dispatch across ``replica_sets``
    (healthy + suspect + probation) — the ``serve_healthy_replicas``
    gauge."""
    return sum(1 for rs in replica_sets for r in rs.replicas
               if r.health != EJECTED)
