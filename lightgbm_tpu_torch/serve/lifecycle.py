"""Guarded model lifecycle: canary guardrails, automatic rollback,
shadow scoring, labeled feedback.

Port of the JAX package's serve/lifecycle.py, reading the port's
registry (``obs/registry.py``):

- :class:`GuardrailPolicy`: per-model thresholds over the ``model=``
  labeled series: the canary-to-primary p99 latency ratio over the
  observation window, the error and ejection rate, a rolling quality
  gate (logloss/AUC) fed by ``POST /feedback``, and the drift gate.
  Every gate needs ``lifecycle_min_samples`` canary requests before it
  may vote.
- :class:`PromotionController`: a daemon that, after a ``/reload
  target=canary``, ends an observation window in exactly one of
  **promote** (the same ``Fleet.promote`` a manual promote is, then
  ``ModelManager.note_good``), **rollback** (canary dropped, a cooldown
  doubling per consecutive rollback, the reason named in ``/stats`` and
  the log) or **extend** (too few samples, bounded by
  ``lifecycle_max_window_s``: an unproven candidate is rolled back,
  never promoted by timeout).  Its state persists in the serve state
  file, so a restart mid-window serves the last-good primary with the
  candidate un-promoted.
- :class:`ShadowScorer`: mirrors a ``serve_shadow`` fraction of primary
  traffic onto the canary off the response path, through a bounded
  queue that drops and counts (``lifecycle_shadow_dropped_total``) and
  never sheds or slows a real request.
- :class:`FeedbackTracker`: ``POST /feedback {request_id, label}`` joins
  a label back to the model that served the prediction, keeping
  per-model rolling logloss/AUC gauges (``lifecycle_quality_*{model=}``).

All of it is host-side bookkeeping over the frozen forests; the
canary's and the shadow batches' predictions run through K4 like any
other.  With the tracer armed a verdict is a ``Serve::verdict`` span
(outcome, candidate, a drift rollback's offending features) and each
mirrored batch a ``Serve::shadow`` span, as in the JAX package.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import obs
from ..utils import log
from .batcher import QueueFull

# Quality-gate margins (module constants, not params: they encode "worse
# beyond estimator noise", not a deployment policy).  The canary fails
# the quality gate when its rolling logloss exceeds the primary's by
# more than QUALITY_LOGLOSS_MARGIN, or its AUC falls more than
# QUALITY_AUC_MARGIN below the primary's.
QUALITY_LOGLOSS_MARGIN = 0.05
QUALITY_AUC_MARGIN = 0.02

# probability clip for logloss: the standard epsilon that keeps a
# confidently-wrong (or skewed past [0, 1]) prediction finite but huge
_LOGLOSS_EPS = 1e-7

# pending request_id -> (model, score) entries the feedback join keeps
# before evicting the oldest (clients that never deliver labels must
# not grow this without bound)
_PENDING_CAP = 4096

# rolling (score, label) samples kept per model for the quality gauges
_ROLLING_CAP = 2048


def _logloss(scores: np.ndarray, labels: np.ndarray) -> float:
    p = np.clip(np.asarray(scores, np.float64),
                _LOGLOSS_EPS, 1.0 - _LOGLOSS_EPS)
    y = np.asarray(labels, np.float64)
    return float(-np.mean(y * np.log(p) + (1.0 - y) * np.log(1.0 - p)))


def _auc(scores: np.ndarray, labels: np.ndarray) -> Optional[float]:
    """Rank-based AUC (Mann-Whitney, ties averaged); None when only one
    class is present."""
    y = np.asarray(labels, np.float64)
    s = np.asarray(scores, np.float64)
    pos = int(np.sum(y > 0.5))
    neg = len(y) - pos
    if pos == 0 or neg == 0:
        return None
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty(len(s), np.float64)
    sorted_s = s[order]
    i = 0
    while i < len(s):
        j = i
        while j + 1 < len(s) and sorted_s[j + 1] == sorted_s[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    return float((np.sum(ranks[y > 0.5]) - pos * (pos + 1) / 2.0)
                 / (pos * neg))


def _hist_delta(now: Optional[Dict[str, Any]],
                base: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Window-local histogram: cumulative snapshot minus the snapshot
    taken at window start (same-bounds subtraction; a histogram born
    mid-window deltas against zero)."""
    if not now:
        return None
    if not base or list(base.get("buckets", [])) != list(now["buckets"]):
        return now
    counts = [int(a) - int(b) for a, b in zip(now["counts"], base["counts"])]
    return {"buckets": list(now["buckets"]),
            "counts": [max(c, 0) for c in counts],
            "sum": max(float(now["sum"]) - float(base["sum"]), 0.0),
            "count": max(int(now["count"]) - int(base["count"]), 0)}


class FeedbackTracker:
    """Join ``POST /feedback`` labels back to the model that served the
    prediction, and keep per-model rolling-quality gauges.

    ``note`` is called on the ``/predict`` success path for single-row
    requests (one request id, one score, one model); ``feedback``
    resolves a client-delivered ``{request_id, label}`` against the
    pending table.  Both ends are O(1) under one lock — this sits on the
    serving path and must never queue behind quality math; the gauges
    recompute from the rolling windows only when a label arrives."""

    def __init__(self, pending_cap: int = _PENDING_CAP,
                 rolling_cap: int = _ROLLING_CAP):
        self._lock = threading.Lock()
        self._pending: "collections.OrderedDict[int, Tuple[str, float]]" = \
            collections.OrderedDict()
        self._pending_cap = int(pending_cap)
        self._rolling: Dict[str, collections.deque] = {}
        self._rolling_cap = int(rolling_cap)

    def note(self, request_id: int, model: str, score: float) -> None:
        """Remember which model produced which score for ``request_id``
        (oldest entry evicted past the cap)."""
        with self._lock:
            self._pending[int(request_id)] = (str(model), float(score))
            while len(self._pending) > self._pending_cap:
                self._pending.popitem(last=False)

    def feedback(self, request_id: int, label: float) -> bool:
        """Deliver a ground-truth label for a previously served request.
        Returns False for an unknown/expired request id (HTTP 404)."""
        with self._lock:
            entry = self._pending.pop(int(request_id), None)
            if entry is None:
                return False
            model, score = entry
            window = self._rolling.get(model)
            if window is None:
                window = self._rolling[model] = collections.deque(
                    maxlen=self._rolling_cap)
            window.append((score, float(label)))
            samples = [list(window)]
        obs.inc("lifecycle_feedback_total")
        obs.inc(obs.labeled_name("lifecycle_feedback_total", model=model))
        self._publish(model, samples[0])
        return True

    def _publish(self, model: str, window: List[Tuple[float, float]]) -> None:
        scores = np.asarray([s for s, _ in window], np.float64)
        labels = np.asarray([lb for _, lb in window], np.float64)
        obs.set_gauge(obs.labeled_name("lifecycle_feedback_samples",
                                       model=model), len(window))
        obs.set_gauge(obs.labeled_name("lifecycle_quality_logloss",
                                       model=model),
                      round(_logloss(scores, labels), 9))
        auc = _auc(scores, labels)
        if auc is not None:
            obs.set_gauge(obs.labeled_name("lifecycle_quality_auc",
                                           model=model), round(auc, 9))

    def quality(self) -> Dict[str, Dict[str, Any]]:
        """Per-model rolling quality: ``{model: {n, logloss, auc}}`` —
        what the quality guardrail evaluates."""
        with self._lock:
            windows = {m: list(w) for m, w in self._rolling.items()}
        out: Dict[str, Dict[str, Any]] = {}
        for model, window in windows.items():
            if not window:
                continue
            scores = np.asarray([s for s, _ in window], np.float64)
            labels = np.asarray([lb for _, lb in window], np.float64)
            out[model] = {"n": len(window),
                          "logloss": _logloss(scores, labels),
                          "auc": _auc(scores, labels)}
        return out


class GuardrailPolicy:
    """Promote/rollback thresholds over the ``model=``-labeled
    series.  ``snapshot()`` at window start + ``evaluate()`` each tick:
    every gate works on window-local DELTAS (counter and histogram
    subtraction), so a canary's past sins — or past glories — outside
    this window cannot tip the verdict.

    Gates (each votes only with >= ``min_samples`` canary requests in
    the window):

    - ``latency_ratio`` — windowed canary p99 / primary p99 above
      ``latency_ratio`` (0 disables);
    - ``error_rate`` — (canary request errors + canary replica
      ejections) / canary requests above ``error_rate``;
    - ``quality`` — rolling canary logloss worse than the primary's by
      more than ``QUALITY_LOGLOSS_MARGIN``, or AUC lower by more than
      ``QUALITY_AUC_MARGIN`` (votes only when BOTH models have
      >= ``min_samples`` labeled feedback samples — this gate abstains,
      it never blocks a promote for lack of labels);
    - ``drift`` — sustained feature PSI: the canary's DriftCollector
      (obs/drift.py, read through ``drift_source``) reports features
      whose window PSI stayed above ``drift_threshold`` for
      consecutive completed windows.  Votes fail naming the offending
      features; abstains with fewer than 2 completed windows, with no
      collector (drift=off / no fingerprint in the artifact), or with
      ``drift_threshold`` 0.
    """

    _COUNTERS = ("serve_requests", "serve_request_errors_total",
                 "serve_ejections_total")

    def __init__(self, min_samples: int = 50, latency_ratio: float = 3.0,
                 error_rate: float = 0.05, drift_threshold: float = 0.0,
                 drift_source=None):
        self.min_samples = max(int(min_samples), 1)
        self.latency_ratio = float(latency_ratio)
        self.error_rate = float(error_rate)
        self.drift_threshold = float(drift_threshold)
        # zero-arg callable -> the canary DriftCollector's stats() dict
        # (or None) — injected by PredictServer so the policy stays
        # registry-pure and unit-testable
        self.drift_source = drift_source

    def snapshot(self) -> Dict[str, Any]:
        """Cumulative labeled counters + latency histograms for both
        models — the window-start baseline ``evaluate`` deltas against."""
        snap: Dict[str, Any] = {}
        for model in ("primary", "canary"):
            for name in self._COUNTERS:
                key = obs.labeled_name(name, model=model)
                snap[key] = obs.get_counter(key)
            hkey = obs.labeled_name("serve_latency_seconds", model=model)
            snap[hkey] = obs.get_histogram(hkey)
        return snap

    def _delta(self, baseline: Dict[str, Any], name: str,
               model: str) -> int:
        key = obs.labeled_name(name, model=model)
        return max(obs.get_counter(key) - int(baseline.get(key) or 0), 0)

    def evaluate(self, baseline: Dict[str, Any],
                 quality: Optional[Dict[str, Dict[str, Any]]] = None
                 ) -> Dict[str, Any]:
        """One verdict over the window so far: ``decision`` is ``pass``
        (every armed gate clean, enough samples), ``fail`` (some armed
        gate tripped; ``reason`` names it) or ``insufficient``."""
        gates: Dict[str, Any] = {}
        samples = self._delta(baseline, "serve_requests", "canary")
        armed = samples >= self.min_samples
        reason = None

        # latency gate: windowed p99 ratio
        if self.latency_ratio > 0:
            ck = obs.labeled_name("serve_latency_seconds", model="canary")
            pk = obs.labeled_name("serve_latency_seconds", model="primary")
            c_hist = _hist_delta(obs.get_histogram(ck), baseline.get(ck))
            p_hist = _hist_delta(obs.get_histogram(pk), baseline.get(pk))
            c_p99 = obs.histogram_quantile(c_hist, 0.99)
            p_p99 = obs.histogram_quantile(p_hist, 0.99)
            gate_armed = (armed and c_p99 is not None and p_p99 is not None
                          and (p_hist or {}).get("count", 0)
                          >= self.min_samples)
            ratio = (c_p99 / max(p_p99, 1e-9)
                     if gate_armed and c_p99 is not None else None)
            ok = ratio is None or ratio <= self.latency_ratio
            gates["latency_ratio"] = {
                "armed": gate_armed, "ok": ok,
                "canary_p99_s": c_p99, "primary_p99_s": p_p99,
                "ratio": round(ratio, 4) if ratio is not None else None,
                "threshold": self.latency_ratio}
            if gate_armed and not ok:
                reason = reason or "latency_ratio"

        # error gate: replica-attributable failures + ejections
        errors = (self._delta(baseline, "serve_request_errors_total",
                              "canary")
                  + self._delta(baseline, "serve_ejections_total", "canary"))
        rate = errors / max(samples, 1)
        err_ok = not armed or rate <= self.error_rate
        gates["error_rate"] = {"armed": armed, "ok": err_ok,
                               "errors": errors, "rate": round(rate, 4),
                               "threshold": self.error_rate}
        if armed and not err_ok:
            reason = reason or "error_rate"

        # quality gate: rolling labeled-feedback logloss/AUC — abstains
        # without enough labels on BOTH sides
        q = quality or {}
        cq, pq = q.get("canary"), q.get("primary")
        q_armed = (cq is not None and pq is not None
                   and cq["n"] >= self.min_samples
                   and pq["n"] >= self.min_samples)
        q_ok = True
        detail: Dict[str, Any] = {"armed": q_armed}
        if q_armed:
            ll_gap = cq["logloss"] - pq["logloss"]
            detail.update(canary_logloss=round(cq["logloss"], 6),
                          primary_logloss=round(pq["logloss"], 6),
                          logloss_margin=QUALITY_LOGLOSS_MARGIN)
            if ll_gap > QUALITY_LOGLOSS_MARGIN:
                q_ok = False
            if cq["auc"] is not None and pq["auc"] is not None:
                detail.update(canary_auc=round(cq["auc"], 6),
                              primary_auc=round(pq["auc"], 6),
                              auc_margin=QUALITY_AUC_MARGIN)
                if pq["auc"] - cq["auc"] > QUALITY_AUC_MARGIN:
                    q_ok = False
        detail["ok"] = q_ok
        gates["quality"] = detail
        if q_armed and not q_ok:
            reason = reason or "quality"

        # drift gate: sustained serve-traffic PSI vs the training
        # fingerprint (obs/drift.py) — one noisy window never votes
        if self.drift_threshold > 0 and self.drift_source is not None:
            try:
                d = self.drift_source()
            except Exception:  # collector died — gate abstains, loudly
                obs.inc("lifecycle_drift_source_errors_total")
                d = None
            d_armed = bool(d) and int(d.get("windows", 0)) >= 2
            offenders = (list(d.get("sustained", {}).get("offenders", ()))
                         if d else [])
            last = (d or {}).get("last") or {}
            top = last.get("top") or []
            d_ok = not (d_armed and offenders)
            gates["drift"] = {
                "armed": d_armed, "ok": d_ok,
                "offenders": offenders,
                "max_psi": max((t["psi"] for t in top), default=None),
                "score_psi": last.get("score_psi"),
                "windows": int(d.get("windows", 0)) if d else 0,
                "threshold": self.drift_threshold}
            if not d_ok:
                reason = reason or "drift"

        if reason is not None:
            decision = "fail"
        elif armed:
            decision = "pass"
        else:
            decision = "insufficient"
        return {"decision": decision, "reason": reason,
                "samples": samples, "min_samples": self.min_samples,
                "gates": gates}


class ShadowScorer:
    """Mirror a fraction of primary traffic onto the canary OFF the
    response path.

    ``offer(rows)`` is called by the HTTP layer after a successful
    primary reply: a deterministic weight accumulator (the fleet's
    canary-split idiom — exact share, no RNG) samples ``fraction`` of
    offered batches into a BOUNDED queue.  A full queue drops the batch
    and counts it (``lifecycle_shadow_dropped_total``) — shadow work is
    strictly best-effort and can never shed, slow, or block a client
    request.  The worker thread submits each mirrored batch straight to
    the least-loaded canary replica's micro-batcher (bypassing
    ``Fleet.submit``: shadow traffic must not consume the fleet's
    admission/in-flight budget real requests are counted against), so
    the canary's ``model="canary"`` latency and request series see the
    load — exactly the evidence the guardrails read."""

    def __init__(self, fleet, fraction: float, queue_max: int = 64,
                 timeout_s: float = 5.0):
        if not (0.0 <= float(fraction) <= 1.0):
            raise ValueError("serve_shadow must be in [0, 1]")
        self.fleet = fleet
        self.fraction = float(fraction)
        self.queue_max = max(int(queue_max), 1)
        self.timeout_s = float(timeout_s)
        self._cond = threading.Condition()
        self._queue: "collections.deque[np.ndarray]" = collections.deque()
        self._acc = 0.0
        self._stop = False
        self._thread = threading.Thread(target=self._run,
                                        name="lgbt-serve-shadow",
                                        daemon=True)
        self._thread.start()

    def offer(self, rows: np.ndarray) -> bool:
        """Maybe mirror one served batch.  O(1), never blocks: sampled
        past the queue bound -> dropped and counted.  Returns True when
        the batch was enqueued (tests)."""
        if self.fraction <= 0.0:
            return False
        with self._cond:
            if self._stop:
                return False
            self._acc += self.fraction
            if self._acc < 1.0:
                return False
            self._acc -= 1.0
            if len(self._queue) >= self.queue_max:
                obs.inc("lifecycle_shadow_dropped_total")
                return False
            self._queue.append(np.asarray(rows))
            self._cond.notify()
            return True

    def _pick_canary(self):
        """Least-loaded dispatchable canary replica, or None (no canary
        slot / all ejected — shadow work quietly evaporates; it must
        never fall back onto the primary it is supposed to be measuring
        against)."""
        fleet = self.fleet
        with fleet._cond:
            rs = fleet._canary
            if rs is None:
                return None
            cands = [r for r in rs.replicas if r.eligible()]
            if not cands:
                return None
            return min(cands, key=lambda r: r.load_score())

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stop:
                    self._cond.wait()
                if self._stop and not self._queue:
                    return
                rows = self._queue.popleft()
            rep = self._pick_canary()
            if rep is None:
                continue
            with obs.trace_span("Serve::shadow",
                                args={"rows": int(rows.shape[0]),
                                      "replica": rep.replica_id}):
                try:
                    rep.batcher.submit(rows, timeout=self.timeout_s)
                    obs.inc("lifecycle_shadow_total")
                except QueueFull:
                    obs.inc("lifecycle_shadow_dropped_total")
                except Exception:
                    # a wedged/poisoned canary is the guardrails' problem
                    # (and their evidence) — the shadow path just counts
                    # and moves on
                    obs.inc("lifecycle_shadow_errors_total")

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            return {"fraction": self.fraction,
                    "queue_depth": len(self._queue),
                    "queue_max": self.queue_max}

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)


# controller phases (persisted in the serve state file's "lifecycle" key)
IDLE = "idle"
OBSERVING = "observing"

# extended windows are bounded by lifecycle_max_window_s; when that is 0
# the cap defaults to this multiple of the base window
_MAX_WINDOW_FACTOR = 4.0

# exponential-backoff cap on the post-rollback cooldown
_COOLDOWN_MAX_S = 3600.0


class PromotionController:
    """Observation-window daemon: after a canary reload, end the window
    in exactly one of **promote** / **rollback** / **extend** (same
    daemon shape as serve/health.py's Watchdog: an ``interval_s`` loop, a
    public ``tick()`` for tests, an idempotent ``close()``).

    All in-memory deadline math runs on ``time.monotonic()``.  The
    persisted record (serve state file, ``"lifecycle"`` key) carries
    epoch timestamps only for the cross-restart cooldown — the one
    quantity a monotonic clock cannot carry across a process boundary.
    """

    def __init__(self, fleet, manager, policy: GuardrailPolicy,
                 window_s: float, max_window_s: float = 0.0,
                 cooldown_s: float = 60.0,
                 feedback: Optional[FeedbackTracker] = None,
                 interval_s: float = 0.25):
        self.fleet = fleet
        self.manager = manager
        self.policy = policy
        self.window_s = float(window_s)
        self.max_window_s = (float(max_window_s) if max_window_s > 0
                             else _MAX_WINDOW_FACTOR * self.window_s)
        self.cooldown_s = float(cooldown_s)
        self.feedback = feedback
        self.interval_s = max(float(interval_s), 0.01)
        self._lock = threading.Lock()
        self._phase = IDLE
        self._candidate = ""
        self._candidate_gen = 0
        self._baseline: Dict[str, Any] = {}
        self._window_end = 0.0          # monotonic
        self._window_hard_end = 0.0     # monotonic
        self._extensions = 0
        self._cooldown_until = 0.0      # monotonic
        self._consecutive_rollbacks = 0
        self._last_verdict: Optional[Dict[str, Any]] = None
        self._restore()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="lgbt-serve-lifecycle",
                                        daemon=True)
        self._thread.start()

    # -- crash restore ---------------------------------------------------
    def _restore(self) -> None:
        """Boot-time read of the persisted controller record: a window
        that was open when the process died is NOT resumed — its
        window-start metric baseline died with the process, so the
        candidate is demoted to un-promoted (the operator re-reloads to
        open a fresh window).  The
        rollback cooldown and its backoff count DO carry over: a crash
        must not launder a flapping candidate's history."""
        if not getattr(self.manager, "state_file", None):
            return
        entry = self.manager.read_state(
            self.manager.state_file).get("lifecycle")
        if not isinstance(entry, dict):
            return
        with self._lock:
            self._consecutive_rollbacks = int(
                entry.get("consecutive_rollbacks") or 0)
            until_t = entry.get("cooldown_until_t")
            if isinstance(until_t, (int, float)):
                # epoch -> remaining seconds, once, at boot: the
                # persisted deadline has to survive the restart, which
                # is exactly what the monotonic clock cannot do
                remaining = float(until_t) - time.time()
                if remaining > 0:
                    self._cooldown_until = time.monotonic() \
                        + min(remaining, _COOLDOWN_MAX_S)
            interrupted = entry.get("phase") == OBSERVING
            if interrupted:
                candidate = str(entry.get("candidate") or "")
                self._last_verdict = {
                    "outcome": "interrupted",
                    "reason": "restart_mid_window",
                    "candidate": candidate}
                self._persist()
        if interrupted:
            obs.inc("lifecycle_interrupted_total")
            log.warning(
                "serve lifecycle: restart interrupted the observation "
                "window of candidate %s — it stays un-promoted; reload "
                "it again to open a fresh window", candidate or "?")

    # -- persistence -----------------------------------------------------
    def _persist(self) -> None:
        self.manager.update_state("lifecycle", {
            "phase": self._phase,
            "candidate": self._candidate,
            "candidate_generation": self._candidate_gen,
            "consecutive_rollbacks": self._consecutive_rollbacks,
            "cooldown_until_t": self._cooldown_remaining_epoch(),
            "t": round(time.time(), 3),
        })

    def _cooldown_remaining_epoch(self) -> Optional[float]:
        remaining = self._cooldown_until - time.monotonic()
        if remaining <= 0:
            return None
        return round(time.time() + remaining, 3)

    # -- lifecycle entry points ------------------------------------------
    def begin(self, model_path: str, generation: int) -> None:
        """A canary reload just succeeded: open its observation window
        (or, inside the post-rollback cooldown, roll it straight back —
        a flapping candidate cannot promote-loop by re-reloading)."""
        act_rollback = False
        with self._lock:
            now = time.monotonic()
            if now < self._cooldown_until:
                self._candidate = str(model_path)
                self._candidate_gen = int(generation)
                act_rollback = True
            else:
                self._phase = OBSERVING
                self._candidate = str(model_path)
                self._candidate_gen = int(generation)
                self._baseline = self.policy.snapshot()
                self._window_end = now + self.window_s
                self._window_hard_end = now + self.max_window_s
                self._extensions = 0
                self._persist()
                log.info("serve lifecycle: observing canary %s "
                         "(generation %d) for %.1fs (max %.1fs)",
                         model_path, generation, self.window_s,
                         self.max_window_s)
        if act_rollback:
            self._rollback("cooldown", verdict=None)

    def tick(self) -> None:
        """One evaluation pass (public so tests can drive the verdict
        without waiting out ``interval_s``)."""
        action = None
        verdict = None
        with self._lock:
            if self._phase != OBSERVING:
                return
            quality = self.feedback.quality() if self.feedback else None
            verdict = self.policy.evaluate(self._baseline, quality)
            now = time.monotonic()
            if verdict["decision"] == "fail":
                action = ("rollback", verdict["reason"])
            elif now >= self._window_end:
                if verdict["decision"] == "pass":
                    action = ("promote", None)
                elif now >= self._window_hard_end:
                    # out of time and still unproven: an unvetted model
                    # is never promoted by timeout
                    action = ("rollback", "insufficient_samples")
                else:
                    self._window_end = min(now + self.window_s,
                                           self._window_hard_end)
                    self._extensions += 1
                    obs.inc("lifecycle_extensions_total")
                    log.info("serve lifecycle: window extended (%d "
                             "canary sample(s) < %d required); verdict "
                             "deadline in %.1fs", verdict["samples"],
                             self.policy.min_samples,
                             self._window_end - now)
        if action is None:
            return
        if action[0] == "promote":
            self._promote(verdict)
        else:
            self._rollback(action[1], verdict)

    # -- verdicts --------------------------------------------------------
    def _promote(self, verdict: Optional[Dict[str, Any]]) -> None:
        """Atomic canary→primary swap: the SAME ``Fleet.promote`` a
        manual operator call uses, on the SAME forest object the canary
        replicas serve — post-swap predictions are bit-identical to the
        canary's by construction."""
        with obs.trace_span("Serve::verdict",
                            args={"outcome": "promote",
                                  "candidate": self._candidate}):
            snap = self.fleet.canary_snapshot()
            if snap is None:
                log.warning("serve lifecycle: verdict was promote but "
                            "the canary slot is empty — nothing to do")
                with self._lock:
                    self._phase = IDLE
                    self._persist()
                return
            forest, model_path, _gen = snap
            # a canary slot built directly (Fleet.build(canary_forest=))
            # carries no model_path; the reload path the window opened
            # with is the authoritative name
            model_path = model_path or self._candidate
            new_set = self.fleet.promote(forest, target="primary",
                                         model_path=model_path)
            self.fleet.drop_canary()
            self.manager.note_good(model_path, target="primary",
                                   generation=new_set.generation)
            self.manager.clear_slot("canary")
            with self._lock:
                self._phase = IDLE
                self._consecutive_rollbacks = 0
                self._last_verdict = {
                    "outcome": "promote", "reason": None,
                    "candidate": model_path,
                    "generation": new_set.generation,
                    "verdict": verdict}
                self._persist()
        obs.inc("lifecycle_promotions_total")
        log.info("serve lifecycle: candidate %s PROMOTED to primary "
                 "(generation %d)", model_path, new_set.generation)

    def _rollback(self, reason: str, verdict: Optional[Dict[str, Any]]
                  ) -> None:
        """Drop the canary and arm the sticky cooldown (exponential
        backoff per consecutive rollback, capped)."""
        # a drift verdict names its offending features in the trace
        # span, per-feature counters and the log: the alarm says which
        # columns moved
        offenders = list(((verdict or {}).get("gates", {})
                          .get("drift", {}) or {}).get("offenders", ()))
        span_args = {"outcome": "rollback", "reason": reason,
                     "candidate": self._candidate}
        if offenders:
            span_args["drift_features"] = offenders
        with obs.trace_span("Serve::verdict", args=span_args):
            self.fleet.drop_canary()
            self.manager.clear_slot("canary")
            with self._lock:
                self._phase = IDLE
                self._consecutive_rollbacks += 1
                backoff = min(
                    self.cooldown_s
                    * (2.0 ** (self._consecutive_rollbacks - 1)),
                    _COOLDOWN_MAX_S)
                if self.cooldown_s > 0:
                    self._cooldown_until = time.monotonic() + backoff
                self._last_verdict = {
                    "outcome": "rollback", "reason": reason,
                    "candidate": self._candidate,
                    "cooldown_s": round(backoff, 3),
                    "verdict": verdict}
                candidate = self._candidate
                self._persist()
        obs.inc("lifecycle_rollbacks_total")
        obs.inc(f"lifecycle_rollback_{reason}")
        for feat in offenders:
            obs.inc(obs.labeled_name("lifecycle_drift_offenders_total",
                                     feature=feat))
        log.warning("serve lifecycle: candidate %s ROLLED BACK (%s%s); "
                    "cooldown %.1fs", candidate or "?", reason,
                    (": " + ", ".join(offenders)) if offenders else "",
                    backoff if self.cooldown_s > 0 else 0.0)

    # -- introspection / loop --------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """The ``/stats`` lifecycle block: phase, candidate, window
        countdowns, cooldown, and the last verdict with its reason."""
        with self._lock:
            now = time.monotonic()
            return {
                "phase": self._phase,
                "candidate": self._candidate or None,
                "candidate_generation": self._candidate_gen or None,
                "window_s": self.window_s,
                "window_remaining_s": (
                    round(max(self._window_end - now, 0.0), 3)
                    if self._phase == OBSERVING else None),
                "extensions": self._extensions,
                "cooldown_remaining_s": round(
                    max(self._cooldown_until - now, 0.0), 3),
                "consecutive_rollbacks": self._consecutive_rollbacks,
                "last_verdict": self._last_verdict,
            }

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as exc:  # pragma: no cover - never die silently
                log.warn_once("serve_lifecycle_tick",
                              "serve lifecycle tick failed: %r", exc)

    def close(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
