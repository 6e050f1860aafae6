"""Stdlib-only background HTTP endpoint for the observability plane
(a copy of the reference's ``repro/obs/http.py``, which imports no jax).

:class:`ObsServer` serves three read-only endpoints off a daemon
thread (``http.server.ThreadingHTTPServer`` -- no third-party deps):

  * ``/metrics`` -- the registry rendered as Prometheus text format
    (:func:`~repro_torch.obs.export.render_prometheus`); scrape it with any
    Prometheus-compatible collector.
  * ``/healthz`` -- JSON verdict from the attached
    :class:`~repro_torch.obs.health.HealthMonitor`; HTTP 200 when OK/WARN,
    **503** when CRIT (so load balancers and probes need no body
    parsing).  Without a monitor it reports ``{"status": "ok"}``.
  * ``/varz`` -- the raw ``Registry.snapshot()`` as JSON plus server
    metadata (uptime, recorder occupancy) for humans with ``curl``.

The handler only *reads* (snapshot / evaluate); the solver and service
threads never block on a scrape beyond the registry's per-metric
locks, which is why the live-endpoint test can demand bit-identical
solve results with the endpoint on vs off.

Bind with ``port=0`` to let the OS pick (tests do); the resolved port
is on :attr:`ObsServer.port` after :meth:`start`.
"""
from __future__ import annotations

import http.server
import json
import threading
import time
from typing import Optional

from .export import render_prometheus

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class ObsServer:
    """Background HTTP server exposing a registry (+ optional monitor).

    Args:
      registry: the :class:`~repro_torch.obs.metrics.Registry` to expose.
      monitor: optional :class:`~repro_torch.obs.health.HealthMonitor`; its
        (rate-limited) evaluation runs on each ``/healthz`` hit.
      recorder: optional :class:`~repro_torch.obs.recorder.FlightRecorder`;
        surfaces ring occupancy on ``/varz``.
      host/port: bind address; ``port=0`` -> ephemeral.
      prefix: Prometheus metric-name prefix (see ``render_prometheus``).
    """

    def __init__(self, registry, *, monitor=None, recorder=None,
                 host: str = "127.0.0.1", port: int = 0,
                 prefix: str = ""):
        self.registry = registry
        self.monitor = monitor
        self.recorder = recorder
        self.host = host
        self.port = int(port)
        self.prefix = prefix
        self._httpd: Optional[http.server.ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._started_at: Optional[float] = None

    # ------------------------------------------------------------------
    def start(self) -> "ObsServer":
        """Bind and start serving on a daemon thread; returns self."""
        if self._httpd is not None:
            return self
        obs = self

        class Handler(http.server.BaseHTTPRequestHandler):
            # requests are short and read-only; keep stderr quiet
            def log_message(self, fmt, *args):
                pass

            def _send(self, code, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        body = render_prometheus(
                            obs.registry.snapshot(),
                            prefix=obs.prefix).encode()
                        self._send(200, body, PROM_CONTENT_TYPE)
                    elif path == "/healthz":
                        payload, code = obs._healthz()
                        self._send(code, json.dumps(payload).encode(),
                                   "application/json")
                    elif path in ("/varz", "/"):
                        self._send(200,
                                   json.dumps(obs._varz()).encode(),
                                   "application/json")
                    else:
                        self._send(404, b'{"error": "not found"}',
                                   "application/json")
                except BrokenPipeError:      # scraper went away mid-write
                    pass
                except Exception as e:       # never kill the serving thread
                    try:
                        self._send(500,
                                   json.dumps({"error": repr(e)}).encode(),
                                   "application/json")
                    except Exception:
                        pass

        self._httpd = http.server.ThreadingHTTPServer(
            (self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._started_at = time.monotonic()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            name="obs-http", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._httpd = self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # ------------------------------------------------------------------
    def _healthz(self):
        if self.monitor is None:
            return {"status": "ok", "rules": {}}, 200
        self.monitor.poll()
        payload = self.monitor.healthz(evaluate=False)
        code = 503 if payload["status"] == "crit" else 200
        return payload, code

    def _varz(self) -> dict:
        out = {
            "uptime_s": (time.monotonic() - self._started_at
                         if self._started_at is not None else 0.0),
            "metrics": self.registry.snapshot(),
        }
        if self.recorder is not None:
            out["recorder"] = {
                "capacity": self.recorder.capacity,
                "retained": len(self.recorder.events),
                "dropped": self.recorder.dropped,
                "dumps": list(self.recorder.dumps),
            }
        if self.monitor is not None:
            out["health"] = self.monitor.healthz(evaluate=False)
        return out
