"""Scrape endpoint: a stdlib HTTP server over the live obs state.

Port of ``spark_rapids_jni_tpu/obs/server.py``: ``ThreadingHTTPServer``
only, bound to loopback (``SRT_OBS_HTTP_HOST`` widens it deliberately).

- ``GET /metrics``: Prometheus text of the whole registry, after the
  SLO windows are published (``slo.TRACKER.publish()``) and the device
  memory sampled (``memory.sample_device_memory()``), so a scrape always
  carries fresh ``serving.slo.*`` and ``mem.*`` families.
- ``GET /metrics.json``: the same registry as JSON.
- ``GET /slo.json``: the SLO windows' raw merged sketch vectors
  (``slo.TRACKER.export_sketches()``), the form the fleet rollup merges
  across processes (``obs/rollup.py``).
- ``GET /healthz``: 200 when every registered health source reports
  ``ok`` (vacuously with none), else 503; the body also carries the
  device-memory probe's status.
- ``GET /reports?n=``: the newest ExecutionReports (default 16) and the
  flight recorder's tail.

``start(port)`` binds (port 0 = ephemeral; read ``.port``),
``maybe_start_from_env()`` starts the process's server when
``SRT_OBS_HTTP_PORT`` is set, ``stop()`` shuts it down.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

from ..config import env_int, env_str
from .metrics import REGISTRY, count, counter

_lock = threading.Lock()
_server: "Optional[ObsServer]" = None  # guarded-by: _lock

# health sources are module-global: a source registered before the
# server starts (or across a restart) is still seen
_health_sources: "dict[object, Callable[[], dict]]" = {}  # guarded-by: _sources_lock
_sources_lock = threading.Lock()


def add_health_source(key, fn: Callable[[], dict]) -> None:
    """Attach one liveness contributor; ``fn`` returns a JSON-able dict
    with at least ``ok``."""
    with _sources_lock:
        _health_sources[key] = fn


def remove_health_source(key) -> None:
    with _sources_lock:
        _health_sources.pop(key, None)


def reset_health_sources() -> None:
    with _sources_lock:
        _health_sources.clear()


class ObsServer:
    """One bound scrape endpoint (tests may build their own; processes
    use the ``start`` singleton)."""

    def __init__(self, port: int, host: Optional[str] = None):
        if host is None:
            host = env_str("SRT_OBS_HTTP_HOST", "127.0.0.1")
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            server_version = "srt-obs"

            def log_message(self, *args):
                pass

            def do_GET(self):
                try:
                    outer._route(self)
                except ConnectionError:
                    count("obs.http_client_aborts")

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"srt-obs-http-{self.port}", daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    def _health(self) -> "tuple[bool, dict]":
        from . import memory as _memory
        with _sources_lock:
            sources = dict(_health_sources)
        body: dict = {"sources": {}}
        ok = True
        for key, fn in sources.items():
            try:
                snap = dict(fn())
            except Exception:
                count("obs.healthz_source_errors")
                snap = {"ok": False, "error": "health source raised"}
            body["sources"][str(key)] = snap
            ok = ok and bool(snap.get("ok"))
        body["ok"] = ok
        body["quarantined"] = counter("serving.fault.quarantined").value
        body["device_memory_probe"] = (
            "reporting" if _memory.device_memory_stats() is not None
            else "not_reporting")
        return ok, body

    @staticmethod
    def _refresh_exports() -> None:
        """What both metric expositions refresh first."""
        from . import memory as _memory
        from . import slo as _slo
        _slo.TRACKER.publish()
        _memory.sample_device_memory()

    def _route(self, handler: BaseHTTPRequestHandler) -> None:
        url = urlparse(handler.path)
        count("obs.http_requests")
        if url.path == "/metrics":
            self._refresh_exports()
            self._send(handler, 200, REGISTRY.to_prometheus(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif url.path == "/metrics.json":
            self._refresh_exports()
            self._send_json(handler, 200, REGISTRY.to_json())
        elif url.path == "/slo.json":
            from . import slo as _slo
            self._send_json(handler, 200, _slo.TRACKER.export_sketches())
        elif url.path == "/healthz":
            ok, body = self._health()
            self._send_json(handler, 200 if ok else 503, body)
        elif url.path == "/reports":
            from . import flight as _flight
            from .report import recent_reports
            try:
                n = int(parse_qs(url.query).get("n", ["16"])[0])
            except (ValueError, IndexError):
                n = 16
            n = max(1, n)
            self._send_json(handler, 200, {
                "reports": [r.to_dict() for r in recent_reports(n)],
                "flight": _flight.events_tail(n)})
        else:
            self._send_json(handler, 404, {
                "error": f"unknown path {url.path!r}",
                "paths": ["/metrics", "/metrics.json", "/slo.json",
                          "/healthz", "/reports"]})

    @staticmethod
    def _send(handler, status: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        handler.send_response(status)
        handler.send_header("Content-Type", ctype)
        handler.send_header("Content-Length", str(len(data)))
        handler.end_headers()
        handler.wfile.write(data)

    def _send_json(self, handler, status: int, body: dict) -> None:
        self._send(handler, status, json.dumps(body, default=str),
                   "application/json")

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def current() -> "Optional[ObsServer]":
    """The process's server, or None when not started."""
    return _server


def start(port: Optional[int] = None,
          host: Optional[str] = None) -> ObsServer:
    """Start (or return the running) process server; ``port`` defaults
    to ``SRT_OBS_HTTP_PORT``, 0 binds an ephemeral port."""
    global _server
    with _lock:
        if _server is not None:
            return _server
        if port is None:
            port = env_int("SRT_OBS_HTTP_PORT", 0)
        _server = ObsServer(port, host=host)
        count("obs.http_server_starts")
        return _server


def maybe_start_from_env() -> "Optional[ObsServer]":
    """Start the process server iff ``SRT_OBS_HTTP_PORT`` is set; a bind
    failure is counted and returns None."""
    if _server is not None:
        return _server
    v = env_str("SRT_OBS_HTTP_PORT", "").strip()
    if not v:
        return None
    try:
        return start(port=int(v))
    except (OSError, ValueError):
        count("obs.http_server_errors")
        return None


def stop() -> None:
    """Shut the process server down (idempotent)."""
    global _server
    with _lock:
        srv, _server = _server, None
    if srv is not None:
        srv.stop()
