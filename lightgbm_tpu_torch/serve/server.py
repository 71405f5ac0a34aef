"""Threaded HTTP front end over a serving Fleet of CompiledForests.

Port of the JAX package's serve/server.py:
``python -m lightgbm_tpu_torch task=serve input_model=model.txt
serve_port=8080`` loads the model, freezes one ``CompiledForest`` a
device (``serve/fleet.py``; the visible cards capped by
``serve_replicas``, or ``serve_replicas`` copies on the CPU with
``device=cpu``), binds at once and serves over stdlib HTTP while it warms
every bucket up to ``serve_max_batch`` on every replica in the
background (``/readyz`` answers 503 ``warming`` until the warm ends).
Each replica answers through the forest-walk kernel K4 behind its own
micro-batcher.

- ``POST /predict``: JSON ``{"rows": [[...], ...], "raw_score": false,
  "deadline_ms": null}`` (or one flat row, or a bare list of rows), or
  CSV/TSV text lines.  Response ``{"predictions": [...], "num_rows": n,
  "request_id": id, "model": ..., "generation": g, "replica": r}``.
  400 names the offending row; 413 for a body over
  ``serve_max_body_bytes``; 429 with ``Retry-After`` when admission
  control sheds the request (``serve_queue_depth``,
  ``serve_max_inflight``); 503 while warming or draining, on timeout and
  at zero healthy replicas; 504 when the request's own deadline
  expires.
- ``POST /reload``: ``{"model": "<path>", "target": "primary"}``, the
  zero-downtime hot swap; with the lifecycle controller on
  (``lifecycle_window_s > 0``) a ``target=canary`` reload opens a
  guarded observation window (``serve/lifecycle.py``).
- ``POST /feedback``: ``{"request_id": id, "label": y}`` joins a label
  back to the model that served the prediction (404 for an unknown id).
- ``GET /healthz`` (liveness, the forest's shape, the generation),
  ``GET /readyz`` (503 while warming and once draining), ``GET /stats``
  (the registry as JSON, the fleet, lifecycle and drift blocks, and the
  forest-walk kernels' launch counts) and ``GET /metrics`` (the
  registry as Prometheus text, ``obs/prom.py``, with ``rank_labels()``).

Every response echoes ``X-Request-Id``.  With ``trace_events_file``
each ``/predict`` and ``/reload`` is a ``Serve::request`` trace (its
``request_id`` and reply status as args), exported at ``stop()``.
Shutdown (SIGINT/SIGTERM or ``stop()``) stops accepting, stops the
lifecycle daemons, drains every replica's batcher, closes the socket,
then exports the trace.
"""

from __future__ import annotations

import itertools
import json
import math
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Mapping, Optional

import numpy as np

from .. import obs
from ..obs import prom
from ..obs.drift import DriftCollector
from ..obs.metrics_server import rank_labels
from ..ops.forest_walk import launch_counts
from ..utils import log
from ..utils.log import LightGBMError
from .batcher import DeadlineExpired
from .fleet import Fleet, ModelManager, Overloaded
from .forest import CompiledForest
from .health import NoHealthyReplicas
from .lifecycle import (FeedbackTracker, GuardrailPolicy,
                        PromotionController, ShadowScorer)

_request_ids = itertools.count(1)


def _rows_to_matrix(rows) -> np.ndarray:
    """A JSON ``rows`` payload -> [n, F] f32; any defect raises
    ``ValueError`` naming the offending row index."""
    if not isinstance(rows, (list, tuple)):
        raise ValueError("rows must be a list")
    if rows and not isinstance(rows[0], (list, tuple)):
        rows = [rows]                  # one flat row
    width = None
    for i, row in enumerate(rows):
        if not isinstance(row, (list, tuple)):
            raise ValueError(
                f"row {i}: expected a list of feature values, got "
                f"{type(row).__name__}")
        if width is None:
            width = len(row)
        elif len(row) != width:
            raise ValueError(
                f"row {i}: {len(row)} feature(s) where row 0 has "
                f"{width}")
        for j, v in enumerate(row):
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise ValueError(
                    f"row {i}: non-numeric value {v!r} at feature {j}")
    return np.asarray(rows, dtype=np.float32).reshape(len(rows), width or 0)


def _parse_rows(body: bytes, content_type: str):
    """Request body -> ``([n, F] f32 rows, options)``: a JSON envelope
    (options ``raw_score`` and ``deadline_ms``) or CSV/TSV lines."""
    opts = {"raw_score": False, "deadline_ms": None}
    if "json" in (content_type or ""):
        payload = json.loads(body.decode("utf-8"))
        if isinstance(payload, dict):
            rows = payload.get("rows", [])
            opts["raw_score"] = bool(payload.get("raw_score", False))
            if payload.get("deadline_ms") is not None:
                opts["deadline_ms"] = float(payload["deadline_ms"])
        else:
            rows = payload
        arr = _rows_to_matrix(rows)
    else:
        lines = [ln for ln in body.decode("utf-8", errors="replace")
                 .splitlines() if ln.strip()]
        delim = "\t" if lines and "\t" in lines[0] else ","
        parsed = []
        width = None
        for i, ln in enumerate(lines):
            parts = ln.split(delim)
            if width is None:
                width = len(parts)
            elif len(parts) != width:
                raise ValueError(
                    f"row {i}: {len(parts)} feature(s) where row 0 "
                    f"has {width}")
            try:
                parsed.append([float(v) for v in parts])
            except ValueError:
                raise ValueError(f"row {i}: unparseable feature value "
                                 f"in {ln[:80]!r}")
        arr = np.asarray(parsed, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr.reshape(1, -1)
    return arr, opts


def _first_nonfinite_row(arr: np.ndarray) -> int:
    """Index of the first row holding a NaN/Inf feature, or -1."""
    bad = ~np.isfinite(arr)
    if not bad.any():
        return -1
    return int(np.argmax(bad.any(axis=1)))


def _json_predictions(raw: np.ndarray, out: np.ndarray,
                      raw_score: bool) -> list:
    """[K, n] scores -> per-row floats / per-row lists."""
    scores = raw if raw_score else out
    if scores.shape[0] == 1:
        return [float(v) for v in scores[0]]
    return [[float(v) for v in col] for col in scores.T]


def registry_stats() -> dict:
    """JSON view of the whole registry: counters and gauges verbatim
    (non-JSON gauge values as strings), histograms as count/sum/mean and
    interpolated p50/p99: the JAX package's ``/stats`` contract."""
    snap = obs.snapshot()
    gauges = {}
    for k, v in snap["gauges"].items():
        gauges[k] = v if isinstance(v, (int, float, str, bool,
                                        type(None))) else str(v)
    hists = {}
    for name, h in snap["histograms"].items():
        p50 = obs.histogram_quantile(h, 0.50)
        p99 = obs.histogram_quantile(h, 0.99)
        hists[name] = {
            "count": h["count"],
            "sum": round(float(h["sum"]), 9),
            "mean": (round(float(h["sum"]) / h["count"], 9)
                     if h["count"] else None),
            "p50": round(p50, 9) if p50 is not None else None,
            "p99": round(p99, 9) if p99 is not None else None,
        }
    return {"counters": snap["counters"], "gauges": gauges,
            "histograms": hists}


class _Handler(BaseHTTPRequestHandler):
    server_version = "lightgbm-tpu-serve/1.0"
    protocol_version = "HTTP/1.1"

    # quiet request logging through our logger, not stderr
    def log_message(self, fmt, *args):  # pragma: no cover - log plumbing
        log.debug("serve: " + fmt, *args)

    def _reply(self, code: int, payload: dict,
               request_id: Optional[int] = None,
               headers: Optional[Mapping[str, str]] = None) -> int:
        """Send a JSON reply; returns its status code."""
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if request_id is not None:
            self.send_header("X-Request-Id", str(request_id))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)
        return code

    def do_GET(self):  # noqa: N802 - stdlib handler naming
        srv: "PredictServer" = self.server.predict_server
        req_id = next(_request_ids)
        if self.path == "/healthz":
            # LIVENESS: the process is up and handling HTTP (200 while
            # warming or draining: restarting a warming server only makes
            # the warm recur)
            self._reply(200, {"status": "ok",
                              "ready": srv.is_ready(),
                              "generation": srv.fleet.generation,
                              **srv.forest.info()}, req_id)
        elif self.path == "/readyz":
            # READINESS: out of rotation until the warm completes and
            # during the shutdown drain
            ready, why = srv.readiness()
            self._reply(200 if ready else 503,
                        {"status": why,
                         "generation": srv.fleet.generation}, req_id)
        elif self.path == "/stats":
            # the WHOLE registry, not a hand-picked key list: new metric
            # names (histogram series included) surface here without this
            # handler ever learning about them
            self._reply(200, {**registry_stats(),
                              "fleet": srv.fleet.stats(),
                              "lifecycle": srv.lifecycle_stats(),
                              "drift": srv.drift_stats(),
                              "kernel_launches": launch_counts()}, req_id)
        elif self.path == "/metrics":
            body = prom.render(labels=rank_labels()).encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", prom.CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Request-Id", str(req_id))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._reply(404, {"error": f"unknown path {self.path}"},
                        req_id)

    def do_POST(self):  # noqa: N802 - stdlib handler naming
        srv: "PredictServer" = self.server.predict_server
        req_id = next(_request_ids)
        if self.path == "/reload":
            self._do_reload(srv, req_id)
            return
        if self.path == "/feedback":
            self._do_feedback(srv, req_id)
            return
        if self.path != "/predict":
            self._reply(404, {"error": f"unknown path {self.path}"}, req_id)
            return
        # the causal-trace root: one trace a request.  What the request
        # causes (dispatch, queue wait, the coalesced batch it rides, the
        # device predict) hangs off this span; it closes on every exit,
        # 4xx, shed and timeout replies included, with the reply's status
        with obs.trace_span("Serve::request",
                            args={"request_id": req_id}) as rh:
            status = self._do_predict(srv, req_id)
            if rh is not None:
                rh.args["status"] = status

    def _do_predict(self, srv: "PredictServer", req_id: int) -> int:
        """``POST /predict``; returns the reply's status code."""
        # ingress: the size cap, per-row validation and the non-finite
        # policy all answer before any device time
        try:
            length = int(self.headers.get("Content-Length", 0) or 0)
        except (TypeError, ValueError):
            obs.inc("serve_bad_requests")
            self.close_connection = True
            return self._reply(400, {"error": "bad request: malformed "
                                              "Content-Length header"},
                               req_id)
        if srv.max_body_bytes and length > srv.max_body_bytes:
            obs.inc("serve_bad_requests")
            obs.inc("serve_oversize_requests")
            # the unread body makes the connection unusable for
            # keep-alive; tell the client and close it
            self.close_connection = True
            return self._reply(413, {
                "error": f"request body {length} bytes exceeds "
                         f"serve_max_body_bytes="
                         f"{srv.max_body_bytes}"}, req_id)
        try:
            body = self.rfile.read(length)
            rows, opts = _parse_rows(
                body, self.headers.get("Content-Type", ""))
            # validate per request BEFORE coalescing: a malformed
            # width must 400 here, not poison every request sharing
            # its batch
            if rows.shape[0] == 0:
                raise ValueError("no rows in request")
            if rows.shape[1] != srv.fleet.num_features:
                raise ValueError(
                    f"expected {srv.fleet.num_features} features per "
                    f"row, got {rows.shape[1]}")
            if srv.nonfinite_policy == "reject":
                bad_row = _first_nonfinite_row(rows)
                if bad_row >= 0:
                    raise ValueError(
                        f"row {bad_row}: non-finite feature value "
                        f"(serve_nonfinite_policy=reject; set "
                        f"serve_nonfinite_policy=propagate to let "
                        f"NaN/Inf through)")
        except Exception as exc:
            obs.inc("serve_bad_requests")
            return self._reply(400, {"error": f"bad request: {exc}"},
                               req_id)
        ready, why = srv.readiness()
        if not ready:
            # not in rotation: warming (the background warm still
            # building or launching) or draining (shutdown requested)
            return self._reply(503, {"error": f"server {why}"}, req_id,
                               headers={"Retry-After": 1})
        deadline_s = None
        if opts["deadline_ms"] is not None:
            deadline_s = time.monotonic() + opts["deadline_ms"] / 1000.0
        try:
            res = srv.fleet.submit(rows, timeout=srv.request_timeout,
                                   deadline_s=deadline_s)
            preds = _json_predictions(res.raw, res.out,
                                      opts["raw_score"])
            # feedback join registered BEFORE the reply bytes go
            # out: a fast client may POST /feedback the instant it
            # reads the response, and the pending entry must already
            # exist (O(1), never blocks the reply)
            if srv.feedback is not None and len(preds) == 1 \
                    and isinstance(preds[0], float):
                srv.feedback.note(req_id, res.model, preds[0])
            code = self._reply(200, {
                "predictions": preds,
                "num_rows": int(rows.shape[0]),
                "request_id": req_id,
                "model": res.model,
                "generation": res.generation,
                "replica": res.replica,
            }, req_id)
            # shadow mirroring AFTER the reply: O(1), bounded queue
            # that drops under load — it never sheds or slows the
            # request we just served
            if srv.shadow is not None and res.model == "primary":
                srv.shadow.offer(rows)
            return code
        except Overloaded as exc:
            # admission control shed: bend p99, don't break it.  The
            # Retry-After hint is the observed p50 service time —
            # integral seconds per RFC 9110, never below 1.
            retry = max(1, int(math.ceil(exc.retry_after_s)))
            return self._reply(429, {"error": f"overloaded: {exc}",
                                     "retry_after_s": retry}, req_id,
                               headers={"Retry-After": retry})
        except DeadlineExpired as exc:
            # the request's own budget ran out: 504, shed before
            # device time wherever possible (serve/batcher.py)
            return self._reply(504, {"error": f"deadline expired: {exc}"},
                               req_id)
        except NoHealthyReplicas as exc:
            # zero dispatchable replicas: fail fast, never hang —
            # the watchdog's probes re-admit recovered replicas
            return self._reply(503,
                               {"error": f"no healthy replicas: {exc}"},
                               req_id, headers={"Retry-After": 1})
        except TimeoutError:
            obs.inc("serve_timeouts")
            return self._reply(503, {"error": "prediction timed out"},
                               req_id)
        except RuntimeError as exc:
            # fleet/batcher closed (graceful shutdown) or retries
            # exhausted against ejected replicas — retryable
            obs.inc("serve_shedding")
            return self._reply(503, {"error": f"retry later: {exc}"},
                               req_id)
        except Exception as exc:
            obs.inc("serve_errors")
            return self._reply(500, {"error": str(exc)}, req_id)

    def _do_reload(self, srv: "PredictServer", req_id: int) -> None:
        """``POST /reload {"model": path[, "target": "primary"]}`` —
        zero-downtime hot swap via the ModelManager; replies with the
        new generation once the old one has drained.  A
        ``Serve::request`` trace of its own, with the reply's status."""
        with obs.trace_span("Serve::request",
                            args={"request_id": req_id,
                                  "path": "/reload"}) as rh:
            status = self._reload(srv, req_id)
            if rh is not None:
                rh.args["status"] = status

    def _reload(self, srv: "PredictServer", req_id: int) -> int:
        try:
            length = int(self.headers.get("Content-Length", 0) or 0)
        except (TypeError, ValueError):
            obs.inc("serve_bad_requests")
            self.close_connection = True
            return self._reply(400, {"error": "bad request: malformed "
                                              "Content-Length header"},
                               req_id)
        if srv.max_body_bytes and length > srv.max_body_bytes:
            obs.inc("serve_bad_requests")
            obs.inc("serve_oversize_requests")
            self.close_connection = True
            return self._reply(413, {
                "error": f"request body {length} bytes exceeds "
                         f"serve_max_body_bytes="
                         f"{srv.max_body_bytes}"}, req_id)
        try:
            payload = json.loads(self.rfile.read(length) or b"{}")
            model = (payload or {}).get("model", "")
            target = (payload or {}).get("target", "primary")
            if not model:
                raise ValueError('body must carry {"model": "<path>"}')
        except Exception as exc:
            obs.inc("serve_bad_requests")
            return self._reply(400, {"error": f"bad request: {exc}"},
                               req_id)
        try:
            gen = srv.manager.reload(str(model), target=str(target))
            # the reload built fresh replica forests: re-attach the
            # drift collectors (a changed fingerprint gets a fresh
            # collector — new model, fresh drift history)
            srv._attach_drift()
            if str(target) == "canary" and srv.controller is not None:
                # open the guarded observation window (or, inside
                # the post-rollback cooldown, roll the candidate
                # straight back — GET /stats names the verdict)
                srv.controller.begin(str(model), gen)
            return self._reply(200, {"status": "ok", "generation": gen,
                                     "target": str(target),
                                     "request_id": req_id}, req_id)
        except (OSError, ValueError, LightGBMError) as exc:
            # client-side rejections: missing/bad model file, width
            # mismatch vs the other live model, no canary slot — a
            # retry of the same request cannot succeed, so 400
            return self._reply(400, {"error": f"reload failed: {exc}"},
                               req_id)
        except Exception as exc:
            obs.inc("serve_errors")
            return self._reply(500, {"error": f"reload failed: {exc}"},
                               req_id)

    def _do_feedback(self, srv: "PredictServer", req_id: int) -> None:
        """``POST /feedback {"request_id": id, "label": y}`` — deliver a
        ground-truth label for a previously served prediction; feeds the
        per-model rolling-quality gauges the lifecycle quality guardrail
        reads.  404 for an unknown/expired request id."""
        try:
            length = int(self.headers.get("Content-Length", 0) or 0)
            payload = json.loads(self.rfile.read(length) or b"{}")
            rid = int(payload["request_id"])
            label = float(payload["label"])
            if not math.isfinite(label):
                raise ValueError("label must be finite")
        except Exception as exc:
            obs.inc("serve_bad_requests")
            self._reply(400, {"error": f"bad request: feedback body must "
                                       f"be {{\"request_id\": id, "
                                       f"\"label\": y}} ({exc})"}, req_id)
            return
        if srv.feedback is None or not srv.feedback.feedback(rid, label):
            self._reply(404, {"error": f"unknown or expired request_id "
                                       f"{rid}"}, req_id)
            return
        self._reply(200, {"status": "ok", "request_id": rid}, req_id)


class PredictServer:
    """Own the HTTP listener + dispatch fleet.

    Accepts either a ready :class:`~.fleet.Fleet` or a bare
    :class:`CompiledForest` (wrapped as a single-replica fleet with the
    pre-fleet defaults: unbounded queue, no in-flight cap).  ``start()``
    binds and serves on a daemon thread (port 0 picks an ephemeral port
    — tests use this); ``serve_forever()`` blocks with SIGINT/SIGTERM
    wired to a graceful stop.
    """

    def __init__(self, forest, host: str = "127.0.0.1",
                 port: int = 8080, max_batch: int = 8192,
                 max_delay_ms: float = 5.0,
                 request_timeout: float = 60.0,
                 params: Optional[dict] = None,
                 state_file: Optional[str] = None,
                 warm_in_background: bool = False,
                 max_body_bytes: int = 33554432,
                 nonfinite_policy: str = "reject",
                 shadow_fraction: float = 0.0,
                 lifecycle_window_s: float = 0.0,
                 lifecycle_max_window_s: float = 0.0,
                 lifecycle_min_samples: int = 50,
                 lifecycle_latency_ratio: float = 3.0,
                 lifecycle_error_rate: float = 0.05,
                 lifecycle_cooldown_s: float = 60.0,
                 lifecycle_interval_s: float = 0.25,
                 drift: str = "off",
                 drift_window: float = 30.0,
                 drift_top_k: int = 5,
                 lifecycle_drift_threshold: float = 0.25):
        # ingress hardening: request body cap (-> 413) and the NaN/Inf
        # feature policy (reject -> 400 naming the row, or propagate)
        self.max_body_bytes = max(int(max_body_bytes), 0)
        if nonfinite_policy not in ("reject", "propagate"):
            raise ValueError(
                f"Unknown serve_nonfinite_policy {nonfinite_policy!r} "
                f"(expected reject or propagate)")
        self.nonfinite_policy = str(nonfinite_policy)
        if isinstance(forest, Fleet):
            self.fleet = forest
        else:
            self.fleet = Fleet.from_forest(
                forest, max_batch=max_batch,
                max_delay_s=max_delay_ms / 1000.0)
        self.manager = ModelManager(self.fleet, params=params,
                                    state_file=state_file)
        self.request_timeout = float(request_timeout)
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.daemon_threads = True
        self.httpd.predict_server = self
        self._thread: Optional[threading.Thread] = None
        self._stop_requested = threading.Event()
        self._stop_lock = threading.Lock()
        self._stopped = False
        # readiness (GET /readyz): liveness comes up with the listener,
        # readiness once the fleet is warm.  With ``warm_in_background``
        # start() runs fleet.warm_all() on a thread and readiness comes
        # up when it returns True, so an orchestrator can health-check
        # the process while the walk kernel builds and warms.
        self._warm_in_background = bool(warm_in_background)
        self._warm_thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        if not self._warm_in_background:
            self._ready.set()       # the caller handed over a warm fleet
        # guarded model lifecycle (serve/lifecycle.py): the feedback
        # join is always on (a dict and two deques); shadow scoring and
        # the promotion controller are built only when configured
        self.feedback: Optional[FeedbackTracker] = FeedbackTracker()
        self.shadow: Optional[ShadowScorer] = None
        if float(shadow_fraction) > 0.0:
            self.shadow = ShadowScorer(self.fleet,
                                       fraction=float(shadow_fraction))
        # drift observatory (obs/drift.py): one collector a model, shared
        # by its replicas' forests, so dispatch and coalescing aggregate
        # into one occupancy.  drift=off builds nothing: the forests keep
        # _drift=None.
        if str(drift) not in ("off", "on"):
            raise ValueError(f"Unknown drift={drift!r} "
                             f"(expected off or on)")
        self._drift_on = str(drift) == "on"
        self.drift_window = float(drift_window)
        self.drift_top_k = int(drift_top_k)
        self.lifecycle_drift_threshold = float(lifecycle_drift_threshold)
        self.drift: Dict[str, DriftCollector] = {}
        self._drift_lock = threading.Lock()
        if self._drift_on:
            self._attach_drift()
        self.controller: Optional[PromotionController] = None
        if float(lifecycle_window_s) > 0.0:
            policy = GuardrailPolicy(
                min_samples=int(lifecycle_min_samples),
                latency_ratio=float(lifecycle_latency_ratio),
                error_rate=float(lifecycle_error_rate),
                drift_threshold=(float(lifecycle_drift_threshold)
                                 if self._drift_on else 0.0),
                drift_source=self._canary_drift_stats)
            self.controller = PromotionController(
                self.fleet, self.manager, policy,
                window_s=float(lifecycle_window_s),
                max_window_s=float(lifecycle_max_window_s),
                cooldown_s=float(lifecycle_cooldown_s),
                feedback=self.feedback,
                interval_s=float(lifecycle_interval_s))

    def lifecycle_stats(self) -> dict:
        """The ``GET /stats`` ``lifecycle`` block: controller phase +
        last verdict (with its named reason), shadow queue state, and
        per-model rolling quality."""
        return {
            "controller": (self.controller.stats()
                           if self.controller is not None else None),
            "shadow": (self.shadow.stats()
                       if self.shadow is not None else None),
            "quality": (self.feedback.quality()
                        if self.feedback is not None else {}),
        }

    # -- drift observatory (obs/drift.py) -------------------------------
    def _attach_drift(self) -> None:
        """(Re)wire per-model DriftCollectors onto every live replica
        forest.  Idempotent and cheap when nothing changed; a reload
        that swapped in a model with a DIFFERENT fingerprint gets a
        fresh collector (new model = fresh drift history); models whose
        artifact carries no fingerprint quietly abstain.  Called at
        construction, after every successful /reload, and lazily from
        drift_stats() so promote/rollback set swaps self-heal."""
        if not self._drift_on:
            return
        fleet = self.fleet
        with fleet._cond:
            sets = [(rs.model, list(rs.replicas))
                    for rs in (fleet._primary, fleet._canary)
                    if rs is not None]
        with self._drift_lock:
            live = set()
            for model, replicas in sets:
                if not replicas:
                    continue
                fp = replicas[0].forest.data_fingerprint
                if fp is None:
                    old = self.drift.pop(model, None)
                    if old is not None:
                        old.close()
                    for rep in replicas:
                        rep.forest._drift = None
                    continue
                live.add(model)
                col = self.drift.get(model)
                if col is None or col.fingerprint is not fp:
                    if col is not None:
                        col.close()
                    col = DriftCollector(
                        fp, model=model, window_s=self.drift_window,
                        top_k=self.drift_top_k,
                        threshold=self.lifecycle_drift_threshold)
                    self.drift[model] = col
                for rep in replicas:
                    rep.forest._drift = col
            for model in list(self.drift):
                if model not in live:
                    self.drift.pop(model).close()

    def _canary_drift_stats(self):
        """GuardrailPolicy drift_source: the canary collector's stats
        dict, or None (drift off / no canary / no fingerprint)."""
        with self._drift_lock:
            col = self.drift.get("canary")
        return col.stats() if col is not None else None

    def drift_stats(self) -> dict:
        """The ``GET /stats`` ``drift`` block: enabled flag + per-model
        collector summaries (window trajectory, top offenders, PSI/KL/
        L-inf, overhead)."""
        self._attach_drift()
        with self._drift_lock:
            return {"enabled": self._drift_on,
                    **{m: c.stats() for m, c in self.drift.items()}}

    def is_ready(self) -> bool:
        return self._ready.is_set() and not self._stop_requested.is_set()

    def readiness(self):
        """(ready, state) for ``GET /readyz``: ``warming`` before the
        fleet's warm completes, ``draining`` once shutdown has been
        requested, ``ready`` otherwise."""
        if self._stop_requested.is_set():
            return False, "draining"
        if not self._ready.is_set():
            return False, "warming"
        return True, "ready"

    def _warm_fleet(self) -> None:
        t0 = time.monotonic()
        try:
            done = self.fleet.warm_all(
                should_abort=self._stop_requested.is_set)
        except Exception as exc:
            # stay not ready: the readiness gate keeps traffic away and
            # the orchestrator's policy decides whether to restart; no
            # fallback to another walk
            log.warning("serve: background warmup failed: %r; readiness "
                        "stays false", exc)
            return
        if not done:
            log.info("serve: background warmup aborted by shutdown")
            return
        self._ready.set()
        log.info("serve: fleet warm in %.3f s, readiness up",
                 time.monotonic() - t0)

    @property
    def forest(self) -> CompiledForest:
        """The primary generation's replica-0 forest (healthz info)."""
        return self.fleet.primary_forest

    @property
    def address(self):
        """(host, port) actually bound (resolves port 0)."""
        return self.httpd.server_address[:2]

    def start(self) -> "PredictServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="lgbt-serve-http", daemon=True)
        self._thread.start()
        if self._warm_in_background and not self._ready.is_set():
            self._warm_thread = threading.Thread(
                target=self._warm_fleet, name="lgbt-serve-warmup",
                daemon=True)
            self._warm_thread.start()
        host, port = self.address
        st = self.fleet.stats()
        log.info("serving CompiledForest (%d trees, %d class) on "
                 "http://%s:%d — %d replica(s), generation %d%s",
                 self.forest.num_trees, self.forest.num_class, host, port,
                 len(st["replicas"]), st["generation"],
                 "" if self.is_ready() else " (warming in background)")
        return self

    def stop(self) -> None:
        """Graceful: stop accepting, drain every replica's batcher,
        close sockets."""
        self._stop_requested.set()
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
        if self._thread is not None:      # shutdown() waits for the loop
            self.httpd.shutdown()
            self._thread.join(timeout=10.0)
        # lifecycle daemons stop BEFORE the fleet closes: a tick or a
        # shadow submit must never race the batcher teardown
        if self.controller is not None:
            self.controller.close()
        if self.shadow is not None:
            self.shadow.close()
        with self._drift_lock:
            drift_cols, self.drift = list(self.drift.values()), {}
        for col in drift_cols:
            col.close()
        if self._warm_thread is not None and self._warm_thread.is_alive():
            # wait out the current bucket (the warm polls _stop_requested
            # between buckets): no launch or build races the teardown
            self._warm_thread.join(timeout=120.0)
        self.fleet.close(drain=True)
        self.httpd.server_close()
        # the causal trace after the drain, so the last batch's spans
        # are in the export
        obs.TRACER.maybe_export()
        log.info("serve: shut down cleanly (%d requests, %d batches, "
                 "%d shed)",
                 obs.get_counter("serve_requests"),
                 obs.get_counter("serve_batches"),
                 obs.get_counter("serve_shed_total"))

    def serve_forever(self) -> None:
        """Block until SIGINT/SIGTERM, then shut down gracefully.  The
        signal handler only *requests* the stop; the blocked main thread
        performs it synchronously, so the process cannot exit with the
        drain half done."""
        def _sig(signum, _frame):  # pragma: no cover - signal delivery
            log.info("serve: received signal %d, shutting down", signum)
            self._stop_requested.set()

        prev = {}
        for s in (signal.SIGINT, signal.SIGTERM):
            try:
                prev[s] = signal.signal(s, _sig)
            except ValueError:  # pragma: no cover - non-main thread
                pass
        try:
            self.start()
            self._stop_requested.wait()
        finally:
            self.stop()
            for s, h in prev.items():  # pragma: no cover - restore
                signal.signal(s, h)


def serve_from_config(config, params=None) -> PredictServer:
    """CLI entry (``task=serve``): load ``input_model`` (or the last-good
    model ``serve_state_file`` names), freeze one forest a device of
    ``fleet_devices(serve_replicas, device)`` and return the server, not
    yet started and not yet warm: ``start()`` binds at once and warms
    every bucket up to ``serve_max_batch`` on every replica in the
    background (``/readyz`` and ``/predict`` answer 503 ``warming`` until
    it ends), as the JAX server does.  ``serve_canary_model`` adds a second model
    at ``serve_canary_weight`` of the traffic; every fleet, lifecycle and
    drift key is read as the JAX server reads it."""
    from ..basic import Booster
    from ..device import resolve_device
    from .batcher import default_ladder
    from .fleet import fleet_devices

    if not config.input_model:
        log.fatal("No model file specified (input_model=...)")
    # the causal trace export (LIGHTGBM_TPU_TRACE_EVENTS wins); a server
    # configured without one disarms the tracer
    obs.TRACER.configure(config.trace_events_file or None)
    # device-time attribution, each server's configuration authoritative
    # (the env variables win inside configure)
    obs.compile_ledger.configure(config.compile_ledger_file or None)
    obs.memwatch.configure(config.memwatch)
    obs.devprof.configure(config.devprof)
    max_batch = int(config.serve_max_batch)
    buckets = list(config.predict_buckets) or default_ladder()
    buckets = [b for b in buckets if b <= max_batch] or [max_batch]
    devices = fleet_devices(int(config.serve_replicas), config.device)
    # the walk strategy and leaf storage ride the params, so a reload
    # freezes the new model the way the boot model was frozen
    walk = str(config.serve_walk or "auto")
    quant = bool(config.serve_quantize_leaves)
    params = dict(params or {})
    params.setdefault("serve_walk", walk)
    params.setdefault("serve_quantize_leaves", quant)
    boot_device = resolve_device(devices[0])

    def _freeze(path):
        booster = Booster(params=dict(params), model_file=path,
                          device=boot_device)
        return CompiledForest.from_booster(booster, buckets=buckets,
                                           serve_walk=walk,
                                           quantize_leaves=quant)

    # crash restore: the state file names the last model that served
    state_file = str(config.serve_state_file or "") or None
    model_path = str(config.input_model)
    restored = ModelManager.restore_path(state_file)
    if restored and restored != model_path:
        log.info("serve: restoring last-good model %s (state file %s; "
                 "input_model was %s)", restored, state_file, model_path)
        model_path = restored
    forest = _freeze(model_path)
    # the canary is restored only while the config still has a slot
    canary = None
    cfg_canary = str(config.serve_canary_model or "")
    canary_path = ""
    if cfg_canary:
        canary_path = ModelManager.restore_path(state_file, "canary") \
            or cfg_canary
    if canary_path:
        canary = _freeze(canary_path)
    log.info("serve: %d bucket(s) for %d trees on %d replica(s)%s; "
             "warming in background, readiness at /readyz",
             len(forest.ladder.sizes), forest.num_trees, len(devices),
             " + canary" if canary is not None else "")
    fleet = Fleet.build(
        forest, devices=devices, canary_forest=canary,
        canary_weight=float(config.serve_canary_weight),
        max_batch=max_batch,
        max_delay_s=float(config.serve_max_delay_ms) / 1000.0,
        max_queue=int(config.serve_queue_depth),
        max_inflight=int(config.serve_max_inflight),
        retry_limit=int(config.serve_retry_limit),
        error_threshold=int(config.serve_error_threshold),
        watchdog_interval_s=float(config.serve_watchdog_ms) / 1000.0,
        stall_s=float(config.serve_stall_ms) / 1000.0,
        latency_outlier=float(config.serve_latency_outlier),
        warm=False)
    server = PredictServer(
        fleet, host=str(config.serve_host or "127.0.0.1"),
        port=int(config.serve_port), max_batch=max_batch,
        max_delay_ms=float(config.serve_max_delay_ms), params=params,
        state_file=state_file, warm_in_background=True,
        max_body_bytes=int(config.serve_max_body_bytes),
        nonfinite_policy=str(config.serve_nonfinite_policy),
        shadow_fraction=float(config.serve_shadow),
        lifecycle_window_s=float(config.lifecycle_window_s),
        lifecycle_max_window_s=float(config.lifecycle_max_window_s),
        lifecycle_min_samples=int(config.lifecycle_min_samples),
        lifecycle_latency_ratio=float(config.lifecycle_latency_ratio),
        lifecycle_error_rate=float(config.lifecycle_error_rate),
        lifecycle_cooldown_s=float(config.lifecycle_cooldown_s),
        drift=str(config.drift or "off"),
        drift_window=float(config.drift_window),
        drift_top_k=int(config.drift_top_k),
        lifecycle_drift_threshold=float(config.lifecycle_drift_threshold))
    # the boot model is the first last-good model
    server.manager.note_good(model_path, generation=fleet.generation)
    if canary is not None:
        canary_gen = fleet.stats()["models"]["canary"]["generation"]
        server.manager.note_good(canary_path, target="canary",
                                 generation=canary_gen)
    return server
