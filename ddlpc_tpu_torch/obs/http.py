"""Telemetry over HTTP: the ``/metrics`` content negotiation and the
training run's endpoint — the port's copy of ``ddlpc_tpu/obs/http.py``
(stdlib only: importing it loads no torch).

:func:`render_metrics` owns the ``/metrics`` negotiation of both HTTP
layers (``serve/server.py`` and :class:`TelemetryServer`): JSON stays the
default (existing tooling and the serve bench parse it); Prometheus text
exposition is selected by an ``Accept`` header naming ``text/plain`` or
``openmetrics`` — which is what Prometheus' own scraper sends.

:class:`TelemetryServer` is the training run's scrape surface
(``train.telemetry_port >= 0``, rank 0): a stdlib threading HTTP server on
a daemon thread serving

- ``GET /metrics``: negotiated (Prometheus text or the JSON snapshot);
- ``GET /healthz``: liveness and the recent health alerts;
- ``GET /debug/trace?steps=N``: arms the on-demand profiler (501 without
  one); the capture runs in the training loop over the next N steps and
  its report lands in the workdir, so the answer acknowledges the arm;
- 404 for anything else.

``port=0`` binds an ephemeral port, read back from :attr:`TelemetryServer.port`.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ddlpc_tpu_torch.obs.registry import MetricsRegistry

PROMETHEUS_CTYPE = "text/plain; version=0.0.4; charset=utf-8"


def wants_prometheus(accept: Optional[str]) -> bool:
    """Whether an Accept header asks for the text exposition format."""
    if not accept:
        return False
    accept = accept.lower()
    return "text/plain" in accept or "openmetrics" in accept


def render_metrics(
    registry: MetricsRegistry,
    accept: Optional[str],
    json_fallback: Optional[Callable[[], dict]] = None,
) -> Tuple[str, bytes]:
    """(content type, body) for a ``/metrics`` request.

    JSON default keeps every existing consumer working; ``json_fallback``
    supplies the legacy JSON body (the serve snapshot) — without one the
    registry's own flat snapshot is served.
    """
    if wants_prometheus(accept):
        return PROMETHEUS_CTYPE, registry.exposition().encode()
    obj = json_fallback() if json_fallback is not None else registry.snapshot()
    return "application/json", json.dumps(obj).encode()


class TelemetryServer:
    """The scrape endpoint of a training process; ``start()``/``close()``."""

    def __init__(
        self,
        registry: MetricsRegistry,
        host: str = "127.0.0.1",
        port: int = 0,
        health_fn: Optional[Callable[[], dict]] = None,
        arm_profile_fn: Optional[Callable[[int], dict]] = None,
    ):
        self.registry = registry
        self.host = host
        self._port = port
        self.health_fn = health_fn
        self.arm_profile_fn = arm_profile_fn
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> Optional[int]:
        return self._server.server_address[1] if self._server else None

    def start(self) -> "TelemetryServer":
        if self._server is not None:
            return self
        telemetry = self

        class _Handler(BaseHTTPRequestHandler):
            server_version = "ddlpc-telemetry/1"
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # scrape traffic is not news
                pass

            def _send(self, code: int, ctype: str, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, obj: dict) -> None:
                self._send(code, "application/json", json.dumps(obj).encode())

            def do_GET(self) -> None:
                parsed = urlparse(self.path)
                if parsed.path == "/metrics":
                    ctype, body = render_metrics(telemetry.registry, self.headers.get("Accept"))
                    self._send(200, ctype, body)
                elif parsed.path == "/healthz":
                    fn = telemetry.health_fn
                    self._send_json(200, fn() if fn is not None else {"status": "ok"})
                elif parsed.path == "/debug/trace":
                    if telemetry.arm_profile_fn is None:
                        self._send_json(501, {"error": "no profiler wired to this endpoint"})
                        return
                    q = parse_qs(parsed.query)
                    try:
                        steps = int(q["steps"][0]) if "steps" in q else 0
                    except ValueError:
                        self._send_json(400, {"error": "steps must be an int"})
                        return
                    self._send_json(200, telemetry.arm_profile_fn(steps))
                else:
                    self._send_json(404, {"error": f"no route {parsed.path}"})

        self._server = ThreadingHTTPServer((self.host, self._port), _Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever, name="telemetry-http",
                                        daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._server = None
        self._thread = None
