"""Threaded HTTP front end over one CompiledForest.

Port of the JAX package's serve/server.py for a single forest (no fleet):
``python -m lightgbm_tpu_torch task=serve input_model=model.txt
serve_port=8080`` loads the model, freezes it on the card, warms every
bucket up to ``serve_max_batch`` and serves micro-batched predictions
over stdlib HTTP.

- ``POST /predict``: JSON ``{"rows": [[...], ...], "raw_score": false,
  "deadline_ms": null}`` (or one flat row, or a bare list of rows), or
  CSV/TSV text lines.  Response ``{"predictions": [...], "num_rows": n,
  "request_id": id}``: one float per row, or one list of ``num_class``
  floats per row.  400 names the offending row (ragged width, a
  non-numeric value, the wrong feature count, a NaN/Inf under
  ``serve_nonfinite_policy=reject``); 413 for a body over
  ``serve_max_body_bytes``; 503 while draining or on timeout; 504 when
  the request's own deadline expires.
- ``GET /healthz``: liveness plus the forest's shape.
- ``GET /readyz``: 503 once the shutdown drain has started.
- ``GET /stats``: counters (requests, batches, rows, kernel launches,
  rejected requests).

Every response echoes ``X-Request-Id``.  Shutdown (SIGINT/SIGTERM or
``stop()``) stops accepting, drains the batcher, then closes the socket.
"""

from __future__ import annotations

import itertools
import json
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Mapping, Optional

import numpy as np

from ..ops.forest_walk import launch_counts
from ..utils import log
from .batcher import DeadlineExpired, MicroBatcher, default_ladder
from .forest import CompiledForest

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


class _Handler(BaseHTTPRequestHandler):
    server_version = "lightgbm-tpu-torch-serve/1.0"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # pragma: no cover - log plumbing
        log.debug("serve: " + fmt, *args)

    def _reply(self, code: int, payload: dict, request_id: int,
               headers: Optional[Mapping[str, str]] = None) -> None:
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.send_header("X-Request-Id", str(request_id))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 - stdlib handler naming
        srv: "PredictServer" = self.server.predict_server
        req_id = next(_request_ids)
        if self.path == "/healthz":
            self._reply(200, {"status": "ok", "ready": srv.is_ready(),
                              **srv.forest.info()}, req_id)
        elif self.path == "/readyz":
            ready = srv.is_ready()
            self._reply(200 if ready else 503,
                        {"status": "ready" if ready else "draining"},
                        req_id)
        elif self.path == "/stats":
            self._reply(200, srv.stats(), req_id)
        else:
            self._reply(404, {"error": f"unknown path {self.path}"}, req_id)

    def do_POST(self):  # noqa: N802 - stdlib handler naming
        srv: "PredictServer" = self.server.predict_server
        req_id = next(_request_ids)
        if self.path != "/predict":
            self._reply(404, {"error": f"unknown path {self.path}"}, req_id)
            return
        try:
            length = int(self.headers.get("Content-Length", 0) or 0)
        except (TypeError, ValueError):
            srv.count("bad_requests")
            self.close_connection = True
            self._reply(400, {"error": "bad request: malformed "
                                       "Content-Length header"}, req_id)
            return
        if srv.max_body_bytes and length > srv.max_body_bytes:
            srv.count("bad_requests")
            srv.count("oversize_requests")
            self.close_connection = True   # the body stays unread
            self._reply(413, {
                "error": f"request body {length} bytes exceeds "
                         f"serve_max_body_bytes={srv.max_body_bytes}"},
                req_id)
            return
        try:
            rows, opts = _parse_rows(self.rfile.read(length),
                                     self.headers.get("Content-Type", ""))
            # validated per request, before coalescing: a bad request
            # must not poison the batch it would have shared
            if rows.shape[0] == 0:
                raise ValueError("no rows in request")
            if rows.shape[1] != srv.forest.num_features:
                raise ValueError(
                    f"expected {srv.forest.num_features} features per "
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
            srv.count("bad_requests")
            self._reply(400, {"error": f"bad request: {exc}"}, req_id)
            return
        if not srv.is_ready():
            self._reply(503, {"error": "server draining"}, req_id,
                        headers={"Retry-After": 1})
            return
        deadline = None
        if opts["deadline_ms"] is not None:
            deadline = time.monotonic() + opts["deadline_ms"] / 1000.0
        try:
            raw, out = srv.batcher.submit(rows, timeout=srv.request_timeout,
                                          deadline=deadline)
            self._reply(200, {
                "predictions": _json_predictions(raw, out,
                                                 opts["raw_score"]),
                "num_rows": int(rows.shape[0]),
                "request_id": req_id}, req_id)
        except DeadlineExpired as exc:
            self._reply(504, {"error": f"deadline expired: {exc}"}, req_id)
        except TimeoutError:
            srv.count("timeouts")
            self._reply(503, {"error": "prediction timed out"}, req_id)
        except RuntimeError as exc:     # batcher closed: retry later
            self._reply(503, {"error": f"retry later: {exc}"}, req_id)
        except Exception as exc:
            srv.count("errors")
            self._reply(500, {"error": str(exc)}, req_id)


class PredictServer:
    """The HTTP listener and one forest behind a :class:`MicroBatcher`.
    ``start()`` serves on a daemon thread (port 0 picks a free port);
    ``serve_forever()`` blocks with SIGINT/SIGTERM wired to ``stop()``."""

    def __init__(self, forest: CompiledForest, host: str = "127.0.0.1",
                 port: int = 8080, max_batch: int = 8192,
                 max_delay_ms: float = 5.0, request_timeout: float = 60.0,
                 max_body_bytes: int = 33554432,
                 nonfinite_policy: str = "reject"):
        if nonfinite_policy not in ("reject", "propagate"):
            raise ValueError(
                f"Unknown serve_nonfinite_policy {nonfinite_policy!r} "
                f"(expected reject or propagate)")
        self.forest = forest
        self.nonfinite_policy = nonfinite_policy
        self.max_body_bytes = max(int(max_body_bytes), 0)
        self.request_timeout = float(request_timeout)
        self.batcher = MicroBatcher(forest.batched_fn(), max_batch=max_batch,
                                    max_delay_s=max_delay_ms / 1000.0,
                                    device=forest.device)
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.daemon_threads = True
        self.httpd.predict_server = self
        self._counts = {"bad_requests": 0, "oversize_requests": 0,
                        "timeouts": 0, "errors": 0}
        self._count_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop_requested = threading.Event()
        self._stop_lock = threading.Lock()
        self._stopped = False

    def count(self, name: str) -> None:
        with self._count_lock:
            self._counts[name] += 1

    def stats(self) -> dict:
        with self._count_lock:
            own = dict(self._counts)
        b = self.batcher.stats()
        return {"requests": b["requests"], "batches": b["batches"],
                "rows": b["rows"], "batch_rows": b["batch_rows"],
                "deadline_expired": b["deadline_expired"],
                "kernel_launches": launch_counts(), **own}

    def is_ready(self) -> bool:
        return not self._stop_requested.is_set()

    @property
    def address(self):
        """(host, port) actually bound (resolves port 0)."""
        return self.httpd.server_address[:2]

    def start(self) -> "PredictServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="lgbt-torch-http", daemon=True)
        self._thread.start()
        host, port = self.address
        log.info("serving CompiledForest (%d trees, %d class) on %s at "
                 "http://%s:%d", self.forest.num_trees,
                 self.forest.num_class, self.forest.device, host, port)
        return self

    def stop(self) -> None:
        """Graceful: stop accepting, drain the batcher, close sockets."""
        self._stop_requested.set()
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
        if self._thread is not None:
            self.httpd.shutdown()
            self._thread.join(timeout=10.0)
        self.batcher.close(drain=True)
        self.httpd.server_close()
        st = self.stats()
        log.info("serve: shut down cleanly (%d requests, %d batches)",
                 st["requests"], st["batches"])

    def serve_forever(self) -> None:
        """Block until SIGINT/SIGTERM, then shut down gracefully: the
        handler only requests the stop; this thread performs it."""
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
    """CLI entry (``task=serve``): load ``input_model`` on
    ``config.device``, freeze it with the ladder capped at
    ``serve_max_batch``, warm every bucket, and return the server
    (not yet started)."""
    from ..basic import Booster

    if not config.input_model:
        log.fatal("No model file specified (input_model=...)")
    max_batch = int(config.serve_max_batch)
    buckets = list(config.predict_buckets) or default_ladder()
    buckets = [b for b in buckets if b <= max_batch] or [max_batch]
    booster = Booster(model_file=str(config.input_model),
                      params=dict(params or {}), device=config.device)
    forest = CompiledForest.from_booster(
        booster, buckets=buckets, serve_walk=config.serve_walk,
        quantize_leaves=config.serve_quantize_leaves)
    forest.warmup(max_bucket=max_batch)
    return PredictServer(
        forest, host=str(config.serve_host or "127.0.0.1"),
        port=int(config.serve_port), max_batch=max_batch,
        max_delay_ms=float(config.serve_max_delay_ms),
        max_body_bytes=int(config.serve_max_body_bytes),
        nonfinite_policy=str(config.serve_nonfinite_policy))
