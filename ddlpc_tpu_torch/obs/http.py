"""Telemetry over HTTP: the ``/metrics`` content negotiation — the port's
copy of :func:`render_metrics` from ``ddlpc_tpu/obs/http.py`` (stdlib
only).

JSON stays the default (existing tooling and the serve bench parse it);
Prometheus text exposition is selected by an ``Accept`` header naming
``text/plain`` or ``openmetrics`` — which is what Prometheus' own scraper
sends.  (The JAX module's ``TelemetryServer``, the training run's scrape
endpoint, comes with the trainer's ``train.telemetry_port``.)
"""

from __future__ import annotations

import json
from typing import Callable, Optional, Tuple

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
