"""Scrapeable /metrics endpoint for long-running training processes.

The port's copy of the JAX package's obs/metrics_server.py: a
daemon-thread stdlib ``ThreadingHTTPServer`` serving

- ``GET /metrics``: the process registry in Prometheus text exposition
  0.0.4 (obs/prom.py), and
- ``GET /healthz``: a JSON liveness probe with the rank,

started by ``engine.train`` (and so the CLI) whenever ``metrics_port``
is set or ``LIGHTGBM_TPU_METRICS_PORT`` is present, and stopped on every
exit of ``train``.  Under a multi-process run every process binds its
own listener and labels every sample ``rank="<rank>"``.  The serving
front end does not use this module: ``serve/server.py`` mounts the same
renderer, with the same labels, on its own listener.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Mapping, Optional

from ..utils import log
from . import prom

ENV_PORT = "LIGHTGBM_TPU_METRICS_PORT"

# newest started listener, for introspection (tests, notebooks asking
# "where do I scrape this run?")
_active_lock = threading.Lock()
_active: Optional["MetricsServer"] = None


def rank_labels() -> Optional[Dict[str, str]]:
    """``{"rank": "<rank>"}`` under a process group of more than one
    rank, else None (one process's expositions stay label-free)."""
    from ..parallel.multihost import process_rank_world
    rank, world = process_rank_world()
    return {"rank": str(rank)} if world > 1 else None


class _Handler(BaseHTTPRequestHandler):
    server_version = "lightgbm-tpu-torch-metrics/1.0"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # pragma: no cover - log plumbing
        log.debug("metrics: " + fmt, *args)

    def _reply(self, code: int, body: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 - stdlib handler naming
        if self.path == "/metrics":
            text = prom.render(labels=self.server.metrics_labels)
            self._reply(200, text.encode("utf-8"), prom.CONTENT_TYPE)
        elif self.path == "/healthz":
            payload: Dict[str, Any] = {"status": "ok"}
            labels = self.server.metrics_labels
            if labels:
                payload.update(labels)
            self._reply(200, json.dumps(payload).encode("utf-8"),
                        "application/json")
        else:
            self._reply(404, json.dumps(
                {"error": f"unknown path {self.path}"}).encode("utf-8"),
                "application/json")


class MetricsServer:
    """Own one daemon-thread HTTP listener over the process registry."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 labels: Optional[Mapping[str, str]] = None):
        self.httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self.httpd.daemon_threads = True
        self.httpd.metrics_labels = (dict(labels) if labels
                                     else rank_labels())
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        self._stop_lock = threading.Lock()

    @property
    def address(self):
        """(host, port) actually bound (resolves port 0)."""
        return self.httpd.server_address[:2]

    def start(self) -> "MetricsServer":
        global _active
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="lgbt-torch-metrics-http",
                                        daemon=True)
        self._thread.start()
        host, port = self.address
        log.info("metrics: serving Prometheus exposition on "
                 "http://%s:%d/metrics", host, port)
        with _active_lock:
            _active = self
        return self

    def stop(self) -> None:
        global _active
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
        self.httpd.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        self.httpd.server_close()
        with _active_lock:
            if _active is self:
                _active = None

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def active_server() -> Optional[MetricsServer]:
    """The newest running listener (None outside a metrics-enabled run)."""
    with _active_lock:
        return _active


def resolve_port(params: Optional[Mapping[str, Any]] = None) -> int:
    """Effective metrics port: the ``LIGHTGBM_TPU_METRICS_PORT`` env var
    wins over the ``metrics_port`` param; 0/unset means disabled."""
    port = 0
    env_set = False
    env = os.environ.get(ENV_PORT, "").strip()
    if env:
        try:
            port = int(env)
            env_set = True          # an explicit 0 disables, beating params
        except ValueError:
            log.warning("%s=%r is not an integer; ignoring", ENV_PORT, env)
    if not env_set and params is not None:
        try:
            port = int(params.get("metrics_port", 0) or 0)
        except (TypeError, ValueError):
            log.warning("metrics_port=%r is not an integer; metrics "
                        "listener disabled", params.get("metrics_port"))
            return 0
    # the env var bypasses Config's range check: clamp here too, or an
    # out-of-range port would raise OverflowError at bind — which is not
    # an OSError and would kill the run the listener only observes
    if port and not (0 < port < 65536):
        log.warning("metrics port %d out of range (1..65535); metrics "
                    "listener disabled", port)
        return 0
    return port


def maybe_start(params: Optional[Mapping[str, Any]] = None) \
        -> Optional[MetricsServer]:
    """Start a listener if configuration asks for one.  A bind failure
    (port taken — e.g. a previous run still draining, or two trainings
    on one box) degrades to a warning: losing the scrape endpoint must
    never kill the training run it observes."""
    port = resolve_port(params)
    if port <= 0:
        return None
    host = str((params or {}).get("metrics_host") or "127.0.0.1")
    try:
        return MetricsServer(host=host, port=port).start()
    except OSError as exc:
        log.warning("metrics: could not bind %s:%d (%s); continuing "
                    "without a metrics listener", host, port, exc)
        return None
