"""Fleet routing frontend: health-aware dispatch, retry, hedging, breakers.

The single-process serving stack (server.py) has no answer to a replica
dying, hanging, or reloading mid-traffic; this module is the routing tier
that makes a FLEET of those processes look like one reliable endpoint:

- **occupancy-aware dispatch** — every request goes to the eligible
  replica with the least work (router-side in-flight + the queue depth
  scraped from each replica's ``/healthz``, which carries queue depth and
  batch occupancy exactly so this tier never parses full ``/metrics``);
- **retry on another replica** — a per-attempt timeout or a 5xx answer
  retries on a *different* replica with full-jitter backoff
  (``uniform(0, base·2^(attempt-1))`` — the supervisor's backoff shape at
  request scale);
- **hedged requests** — after ``hedge_ms`` without an answer a duplicate
  is dispatched to a second replica; the first answer wins and the loser
  is cancelled (fake replicas honor the cancel event; HTTP losers get
  their connection closed under them);
- **per-replica circuit breaker** — error-rate latch with half-open
  probing, the ``obs/health.py`` latch/re-arm pattern applied to a
  replica instead of a queue: trip open on a sustained error rate, admit
  bounded probes after a cooldown, close on consecutive probe successes;
- **graceful drain** — stop dispatching to one replica, wait for its
  in-flight requests to finish; the primitive under both replica restart
  and the rolling hot-reload (serve/fleet.py).

Transport is abstracted behind :class:`ReplicaClient` so the routing
logic unit-tests against in-process fakes; :class:`HTTPReplicaClient` is
the real one (stdlib ``http.client``, one connection per attempt —
serving is engine-bound, not socket-bound).  Everything the router does
is accounted: ``ddlpc_router_*`` metrics on the registry and flat
``kind="router"`` records on ``<fleet_dir>/router.jsonl``.

Deliberately torch-free: the router process babysits replicas that pay
the torch import and hold the card; it must never pay one itself.

The port's own copy of ``ddlpc_tpu/serve/router.py``, kept line for line
so the two read alike: the same decisions, metric families and
``router.jsonl`` records on the same inputs.
"""

from __future__ import annotations

import http.client
import json
import math
import queue
import random
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple
from urllib.parse import parse_qs

from ddlpc_tpu_torch.analysis import lockcheck
from ddlpc_tpu_torch.config import FleetConfig
from ddlpc_tpu_torch.obs import lineage as obs_lineage
from ddlpc_tpu_torch.obs.health import HealthMonitor, SLOTracker
from ddlpc_tpu_torch.obs.registry import MetricsRegistry
from ddlpc_tpu_torch.obs.tracing import (
    TRACEPARENT_HEADER,
    format_traceparent,
    new_span_hex,
    new_trace_id,
)
from ddlpc_tpu_torch.serve.cache import ResponseCache, response_key

# (status, content-type, body).  The HTTP client appends a 4th element —
# the replica's X-DDLPC-Model-Step header — so consumers unpack with
# ``[:3]``; fakes returning bare 3-tuples stay valid.
Response = Tuple[int, str, bytes]


class ReplicaError(RuntimeError):
    """Transport-level attempt failure: connect refused, socket timeout,
    torn read — anything that never produced an HTTP status."""


class NoReplicasAvailable(RuntimeError):
    """No eligible replica (all dead, draining, or breaker-open)."""


def _priority_of(query: str) -> str:
    """Priority class of a request from its query string.  Unknown values
    fall back to interactive for ROUTING policy only — the replica's
    frontend still 400s them, so a typo cannot silently become bulk."""
    if not query:
        return "interactive"
    p = parse_qs(query).get("priority", ["interactive"])[0]
    return p if p == "batch" else "interactive"


def _cache_bypass(query: str) -> bool:
    """Per-request cache opt-out: ``?cache=bypass`` skips both lookup and
    fill (the request is routed and measured exactly as with the cache
    off — what the perf arm compares against)."""
    if not query:
        return False
    return parse_qs(query).get("cache", [""])[0] == "bypass"


def _is_conn_refused(e: BaseException) -> bool:
    """Walk the exception chain for a ConnectionRefusedError.  Clients
    wrap transport errors (``ReplicaError ... from e``), so the refused
    signal — "nothing is listening on that port yet" — arrives as a
    ``__cause__``/``__context__`` link, not the top-level type."""
    seen = set()
    cur: Optional[BaseException] = e
    while cur is not None and id(cur) not in seen:
        if isinstance(cur, ConnectionRefusedError):
            return True
        seen.add(id(cur))
        cur = cur.__cause__ or cur.__context__
    return False


def _percentile(sorted_vals: Sequence[float], q: float) -> Optional[float]:
    """np.percentile(interpolation='linear') without numpy — the router
    stays light enough to import in a torch-free supervisor process."""
    if not sorted_vals:
        return None
    k = (len(sorted_vals) - 1) * q / 100.0
    f, c = math.floor(k), math.ceil(k)
    if f == c:
        return float(sorted_vals[int(k)])
    return float(sorted_vals[f] * (c - k) + sorted_vals[c] * (k - f))


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------


@lockcheck.guarded
class CircuitBreaker:
    """Per-replica error-rate latch with half-open probing.

    closed → (error rate ≥ ``error_rate`` over the last ``window``
    outcomes, once ``min_samples`` seen) → open → (``cooldown_s``
    elapsed) → half_open → (``close_after`` consecutive probe successes)
    → closed; any half-open probe failure re-opens.  The latch/re-arm
    shape is ``obs/health.py:QueueSaturationDetector``'s, applied to a
    replica's error stream instead of a queue ratio.

    ``acquire()`` is the side-effecting admission check (it performs the
    open→half_open transition and counts probe slots); ``available()`` is
    the side-effect-free filter the dispatcher uses to rank candidates.
    """

    def __init__(
        self,
        window: int = 16,
        min_samples: int = 8,
        error_rate: float = 0.5,
        cooldown_s: float = 2.0,
        half_open_probes: int = 1,
        close_after: int = 2,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Optional[Callable[[str], None]] = None,
    ):
        if not 0.0 < error_rate <= 1.0:
            raise ValueError(f"error_rate must be in (0, 1], got {error_rate}")
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.error_rate = float(error_rate)
        self.cooldown_s = float(cooldown_s)
        self.half_open_probes = max(1, int(half_open_probes))
        self.close_after = max(1, int(close_after))
        self._clock = clock
        self._on_transition = on_transition
        self._lock = lockcheck.lock("CircuitBreaker._lock")
        self.state = "closed"  # guarded-by: _lock
        self._outcomes: deque = deque(maxlen=self.window)  # guarded-by: _lock
        self._open_until = 0.0  # guarded-by: _lock
        self._probes_inflight = 0  # guarded-by: _lock
        self._probe_successes = 0  # guarded-by: _lock

    def _transition(self, to: str) -> None:
        self.state = to
        if self._on_transition is not None:
            try:
                self._on_transition(to)
            except Exception:
                pass  # accounting must never break dispatch

    def available(self) -> bool:
        """Could a request be admitted right now?  No side effects."""
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                return self._clock() >= self._open_until
            return self._probes_inflight < self.half_open_probes

    def acquire(self) -> bool:
        """Admit one request; half-open admission consumes a probe slot."""
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                if self._clock() < self._open_until:
                    return False
                self._transition("half_open")
                self._probes_inflight = 0
                self._probe_successes = 0
            if self._probes_inflight < self.half_open_probes:
                self._probes_inflight += 1
                return True
            return False

    def release(self) -> None:
        """Give back an acquired admission WITHOUT an outcome (the attempt
        was cancelled — a hedge/retry loser).  Without this, a cancelled
        half-open probe would leak its slot and wedge the replica out of
        rotation forever."""
        with self._lock:
            if self.state == "half_open":
                self._probes_inflight = max(0, self._probes_inflight - 1)

    def record(self, ok: bool) -> None:
        """Account one completed attempt against this replica."""
        with self._lock:
            if self.state == "half_open":
                self._probes_inflight = max(0, self._probes_inflight - 1)
                if ok:
                    self._probe_successes += 1
                    if self._probe_successes >= self.close_after:
                        self._outcomes.clear()
                        self._transition("closed")
                else:
                    self._open_until = self._clock() + self.cooldown_s
                    self._transition("open")
                return
            if self.state == "open":
                return  # straggler from before the trip; already accounted
            self._outcomes.append(bool(ok))
            if len(self._outcomes) >= self.min_samples:
                errors = sum(1 for o in self._outcomes if not o)
                if errors / len(self._outcomes) >= self.error_rate:
                    self._outcomes.clear()
                    self._open_until = self._clock() + self.cooldown_s
                    self._transition("open")


# ---------------------------------------------------------------------------
# replica clients (transport abstraction)
# ---------------------------------------------------------------------------


class ReplicaClient:
    """What the router needs from one replica.  Subclasses: the HTTP
    client below (real fleet) and in-process fakes (tests).

    ``predict``'s ``traceparent`` keyword is only ever passed when the
    router has TRACING enabled (``FleetConfig.trace``) — pre-existing
    fakes with the old signature keep working untraced."""

    name: str = "?"

    def predict(
        self,
        body: bytes,
        query: str,
        timeout_s: float,
        cancel: Optional[threading.Event] = None,
        traceparent: Optional[str] = None,
    ) -> Response:
        raise NotImplementedError

    def healthz(self, timeout_s: float) -> dict:
        raise NotImplementedError

    def metrics_text(self, timeout_s: float) -> str:
        """Prometheus text exposition from the replica's ``/metrics`` —
        what the fleet TelemetryAggregator scrapes.  Optional: fakes that
        never meet an aggregator may skip it."""
        raise NotImplementedError

    def reload(self, payload: dict, timeout_s: float) -> Tuple[int, dict]:
        raise NotImplementedError


class HTTPReplicaClient(ReplicaClient):
    """stdlib http.client transport: one connection per attempt.

    ``cancel`` support is real but blunt: the router closes the attempt's
    connection from the winning thread, which fails the loser's blocked
    read immediately instead of letting it run to its socket timeout.
    """

    def __init__(self, name: str, host: str, port: int):
        self.name = name
        self.host = host
        self.port = int(port)
        # Live connections keyed by their attempt's cancel token, so a
        # cancel closes ONLY that attempt's socket — this client is shared
        # by every dispatch thread and the scrape loop, and tearing down a
        # sibling request's healthy connection would inject false failures
        # into the breaker.
        self._conns: Dict[int, http.client.HTTPConnection] = {}
        self._conns_lock = threading.Lock()

    def _request(
        self,
        method: str,
        path: str,
        body: Optional[bytes],
        timeout_s: float,
        headers: Optional[dict] = None,
        cancel: Optional[threading.Event] = None,
    ) -> Tuple[int, str, bytes, Optional[str]]:
        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=timeout_s
        )
        key = id(cancel) if cancel is not None else None
        if key is not None:
            with self._conns_lock:
                self._conns[key] = conn
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            data = resp.read()
            # 4th element: the replica's X-DDLPC-Model-Step provenance
            # header (None when absent).  Response consumers unpack via
            # ``[:3]`` so 3-tuple fakes and this 4-tuple interchange.
            return (
                resp.status,
                resp.getheader("Content-Type", ""),
                data,
                resp.getheader(obs_lineage.MODEL_STEP_HEADER),
            )
        except Exception as e:
            raise ReplicaError(f"{self.name}: {type(e).__name__}: {e}") from e
        finally:
            if key is not None:
                with self._conns_lock:
                    self._conns.pop(key, None)
            try:
                conn.close()
            except Exception:
                pass

    def cancel_attempt(self, cancel: threading.Event) -> None:
        """Close the one connection registered under this attempt's cancel
        token: its blocked read fails immediately, nobody else's does."""
        with self._conns_lock:
            conn = self._conns.get(id(cancel))
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass

    def predict(
        self, body, query, timeout_s, cancel=None, traceparent=None
    ) -> Response:
        path = "/predict" + (f"?{query}" if query else "")
        headers = {"Content-Type": "application/x-npy"}
        if traceparent:
            headers[TRACEPARENT_HEADER] = traceparent
        return self._request(
            "POST", path, body, timeout_s, headers=headers, cancel=cancel,
        )

    def metrics_text(self, timeout_s: float) -> str:
        """Prometheus text exposition (Accept negotiates it — obs/http.py)."""
        status, _, body = self._request(
            "GET", "/metrics", None, timeout_s,
            headers={"Accept": "text/plain"},
        )[:3]
        if status != 200:
            raise ReplicaError(f"{self.name}: /metrics returned {status}")
        return body.decode("utf-8", errors="replace")

    def healthz(self, timeout_s: float) -> dict:
        status, _, body = self._request(
            "GET", "/healthz", None, timeout_s
        )[:3]
        try:
            h = json.loads(body)
        except ValueError:
            raise ReplicaError(f"{self.name}: /healthz returned non-JSON")
        if not isinstance(h, dict):
            raise ReplicaError(f"{self.name}: /healthz returned {type(h)}")
        return h

    def reload(self, payload: dict, timeout_s: float) -> Tuple[int, dict]:
        status, _, body = self._request(
            "POST", "/reload", json.dumps(payload).encode(), timeout_s,
            headers={"Content-Type": "application/json"},
        )[:3]
        try:
            meta = json.loads(body) if body else {}
        except ValueError:
            meta = {"error": "non-JSON /reload response"}
        return status, meta


# ---------------------------------------------------------------------------
# router metrics
# ---------------------------------------------------------------------------


class RouterMetrics:
    """Counters + windowed latency ring for the routing tier, published as
    ``ddlpc_router_*`` on the registry and as flat ``kind="router"``
    snapshots on router.jsonl.  The acceptance bar is that every retry,
    hedge, and breaker transition is accounted — these counters are the
    ledger a fault-injection run audits its fault schedule against."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 window: int = 4096):
        self._lock = threading.Lock()
        self._lat = deque(maxlen=window)
        self.requests = 0
        self.errors_5xx = 0  # CLIENT-VISIBLE failures (a fault run forbids them)
        self.attempts = 0
        self.retries = 0
        self.hedges = 0
        self.hedge_wins = 0
        self.batch_shed = 0  # bulk-class requests shed at the router
        self.breaker_opens = 0
        self.breaker_half_opens = 0
        self.breaker_closes = 0
        self.drains = 0
        self.readmissions = 0
        self.reloads_ok = 0
        self.reloads_aborted = 0
        self._t0 = time.monotonic()
        self._last_t = self._t0
        self._last_requests = 0
        self._reg = None
        if registry is not None:
            self._reg = {
                "requests": registry.counter(
                    "ddlpc_router_requests_total",
                    "Client requests answered by the router, by outcome.",
                    labelnames=("outcome",),
                ),
                "attempts": registry.counter(
                    "ddlpc_router_attempts_total",
                    "Replica attempts dispatched, by replica and reason.",
                    labelnames=("replica", "reason"),
                ),
                "retries": registry.counter(
                    "ddlpc_router_retries_total",
                    "Attempts re-dispatched to another replica, by cause.",
                    labelnames=("cause",),
                ),
                "hedges": registry.counter(
                    "ddlpc_router_hedges_total",
                    "Duplicate attempts dispatched for the latency tail.",
                ),
                "hedge_wins": registry.counter(
                    "ddlpc_router_hedge_wins_total",
                    "Requests answered by the hedged attempt.",
                ),
                "batch_shed": registry.counter(
                    "ddlpc_router_batch_shed_total",
                    "Bulk-class (?priority=batch) requests shed at the "
                    "router because every eligible replica's interactive "
                    "queue was at or above batch_shed_queue_depth.",
                ),
                "breaker": registry.counter(
                    "ddlpc_router_breaker_transitions_total",
                    "Circuit-breaker transitions, by replica and new state.",
                    labelnames=("replica", "to"),
                ),
                "drains": registry.counter(
                    "ddlpc_router_drains_total",
                    "Replica drains completed (restart or rolling reload).",
                ),
                "reloads": registry.counter(
                    "ddlpc_router_reloads_total",
                    "Rolling fleet reloads, by outcome.",
                    labelnames=("outcome",),
                ),
                "latency": registry.histogram(
                    "ddlpc_router_request_latency_seconds",
                    "End-to-end routed request latency.",
                ),
                "ready": registry.gauge(
                    "ddlpc_router_replicas_ready",
                    "Replicas currently eligible for dispatch.",
                ),
                "cache_hits": registry.counter(
                    "ddlpc_cache_hits_total",
                    "Predict requests answered from the response cache.",
                ),
                "cache_misses": registry.counter(
                    "ddlpc_cache_misses_total",
                    "Cacheable predict requests that missed the cache.",
                ),
                "cache_evictions": registry.counter(
                    "ddlpc_cache_evictions_total",
                    "Cache entries evicted by the LRU byte bound.",
                ),
                "cache_invalidations": registry.counter(
                    "ddlpc_cache_invalidations_total",
                    "Fleet-wide cache flushes (serving step changed).",
                ),
                "cache_bytes": registry.gauge(
                    "ddlpc_cache_bytes",
                    "Payload bytes currently held by the response cache.",
                ),
                "cache_entries": registry.gauge(
                    "ddlpc_cache_entries",
                    "Entries currently held by the response cache.",
                ),
                # Freshness SLOs.  Replicas with unknown
                # lineage are SKIPPED (their healthz shows the explicit
                # lineage_unknown marker) — an absent series, never a
                # fabricated age.
                "model_age": registry.gauge(
                    "ddlpc_serve_model_age_s",
                    "Per-replica serving-checkpoint age: newest durable "
                    "checkpoint's save time minus the serving one's "
                    "(replica=\"fleet\" is the worst live replica).",
                    labelnames=("replica",),
                ),
                "step_skew": registry.gauge(
                    "ddlpc_fleet_step_skew",
                    "max - min over live replicas' serving checkpoint "
                    "steps; nonzero marks a mixed-weights window.",
                ),
            }
        # Last cache totals pushed to the registry, so sync_cache can inc
        # the monotonic counters by delta (the cache keeps the totals).
        self._cache_seen = {
            "cache_hits": 0, "cache_misses": 0,
            "cache_evictions": 0, "cache_invalidations": 0,
        }

    def record_request(self, latency_s: float, ok: bool) -> None:
        with self._lock:
            self.requests += 1
            self._lat.append(float(latency_s))
            if not ok:
                self.errors_5xx += 1
        if self._reg is not None:
            self._reg["requests"].inc(outcome="ok" if ok else "error")
            self._reg["latency"].observe(float(latency_s))

    def record_attempt(self, replica: str, reason: str) -> None:
        with self._lock:
            self.attempts += 1
        if self._reg is not None:
            self._reg["attempts"].inc(replica=replica, reason=reason)

    def record_retry(self, cause: str) -> None:
        with self._lock:
            self.retries += 1
        if self._reg is not None:
            self._reg["retries"].inc(cause=cause)

    def record_hedge(self) -> None:
        with self._lock:
            self.hedges += 1
        if self._reg is not None:
            self._reg["hedges"].inc()

    def record_hedge_win(self) -> None:
        with self._lock:
            self.hedge_wins += 1
        if self._reg is not None:
            self._reg["hedge_wins"].inc()

    def record_batch_shed(self) -> None:
        with self._lock:
            self.batch_shed += 1
        if self._reg is not None:
            self._reg["batch_shed"].inc()

    def record_breaker(self, replica: str, to: str) -> None:
        with self._lock:
            if to == "open":
                self.breaker_opens += 1
            elif to == "half_open":
                self.breaker_half_opens += 1
            else:
                self.breaker_closes += 1
        if self._reg is not None:
            self._reg["breaker"].inc(replica=replica, to=to)

    def record_drain(self) -> None:
        with self._lock:
            self.drains += 1
        if self._reg is not None:
            self._reg["drains"].inc()

    def record_readmit(self) -> None:
        with self._lock:
            self.readmissions += 1

    def record_reload(self, ok: bool) -> None:
        with self._lock:
            if ok:
                self.reloads_ok += 1
            else:
                self.reloads_aborted += 1
        if self._reg is not None:
            self._reg["reloads"].inc(outcome="ok" if ok else "aborted")

    def set_ready(self, n: int) -> None:
        if self._reg is not None:
            self._reg["ready"].set(n)

    def set_model_age(self, replica: str, age_s: float) -> None:
        if self._reg is not None:
            self._reg["model_age"].set(float(age_s), replica=replica)

    def set_step_skew(self, skew: float) -> None:
        if self._reg is not None:
            self._reg["step_skew"].set(float(skew))

    def sync_cache(self, stats: Dict[str, float]) -> None:
        """Push a ResponseCache.stats() snapshot to the registry: gauges
        are set absolutely, counters advance by delta since last sync."""
        if self._reg is None:
            return
        self._reg["cache_bytes"].set(float(stats["cache_bytes"]))
        self._reg["cache_entries"].set(float(stats["cache_entries"]))
        for key in self._cache_seen:
            total = int(stats[key])
            delta = total - self._cache_seen[key]
            if delta > 0:
                self._reg[key].inc(delta)
            self._cache_seen[key] = total

    def snapshot(self, advance: bool = True) -> Dict[str, object]:
        with self._lock:
            now = time.monotonic()
            dt = max(now - self._last_t, 1e-9)
            rate = (self.requests - self._last_requests) / dt
            if advance:
                self._last_t = now
                self._last_requests = self.requests
            lat = sorted(self._lat)
            return {
                "kind": "router",
                "requests": self.requests,
                "errors_5xx": self.errors_5xx,
                "attempts": self.attempts,
                "retries": self.retries,
                "hedges": self.hedges,
                "hedge_wins": self.hedge_wins,
                "batch_shed": self.batch_shed,
                "breaker_opens": self.breaker_opens,
                "breaker_half_opens": self.breaker_half_opens,
                "breaker_closes": self.breaker_closes,
                "drains": self.drains,
                "readmissions": self.readmissions,
                "reloads_ok": self.reloads_ok,
                "reloads_aborted": self.reloads_aborted,
                "p50_ms": _round(_percentile(lat, 50)),
                "p95_ms": _round(_percentile(lat, 95)),
                "p99_ms": _round(_percentile(lat, 99)),
                "requests_per_sec": round(rate, 3),
                "uptime_s": round(now - self._t0, 3),
            }


def _round(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(v * 1000.0, 3)


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------


class _Replica:
    """Router-side view of one replica: client + dispatch state."""

    def __init__(self, name: str, client: ReplicaClient,
                 breaker: CircuitBreaker):
        self.name = name
        self.client = client
        self.breaker = breaker
        self.ready = False  # supervisor-declared (process up + warmed)
        self.draining = False  # router-declared (drain/reload in progress)
        self.healthy = True  # scrape-declared (flips after N failed scrapes)
        self.inflight = 0  # router-side attempts outstanding
        self.queue_depth = 0  # scraped
        # Per-priority depths + quant mode (scraped from the same one
        # /healthz): what priority-aware dispatch/shedding and quantized
        # rolling reloads rank on.  Replicas predating the continuous
        # batcher report only the total; interactive then mirrors it.
        self.queue_depth_interactive = 0  # scraped
        self.queue_depth_batch = 0  # scraped
        self.quant_mode: Optional[str] = None  # scraped
        self.occupancy: Optional[float] = None  # scraped
        self.checkpoint_step: Optional[int] = None  # scraped
        self.version: Optional[int] = None  # scraped
        self.slot_busy: Optional[float] = None  # scraped (autoscaler signal)
        # Serving lineage (scraped): the literal marker string for
        # pre-lineage checkpoints — visible on /fleet, skipped by gauges.
        self.lineage_id: Optional[str] = None  # scraped
        self.lineage_saved_at: Optional[float] = None  # scraped
        self.scrape_fail_streak = 0
        # True once this replica has EVER answered anything (a successful
        # scrape or any HTTP response to an attempt).  Until then a
        # connection-refused is "still warming", not "failing": the
        # replica is scored ineligible without feeding its breaker, so a
        # scale-up can never open a breaker on a replica mid-launch.
        self.ever_ok = False

    def status(self) -> Dict[str, object]:
        return {
            "name": self.name,
            "ready": self.ready,
            "draining": self.draining,
            "healthy": self.healthy,
            "breaker": self.breaker.state,
            "inflight": self.inflight,
            "queue_depth": self.queue_depth,
            "queue_depth_interactive": self.queue_depth_interactive,
            "queue_depth_batch": self.queue_depth_batch,
            "quant_mode": self.quant_mode,
            "occupancy": self.occupancy,
            "checkpoint_step": self.checkpoint_step,
            "version": self.version,
            "slot_busy": self.slot_busy,
            "lineage_id": self.lineage_id,
            "lineage_saved_at": self.lineage_saved_at,
        }


class _Attempt:
    __slots__ = ("replica", "cancel", "reason", "outcome", "thread", "t0")

    def __init__(self, replica: _Replica, reason: str):
        self.replica = replica
        self.reason = reason  # "primary" | "retry" | "hedge"
        self.cancel = threading.Event()
        self.outcome: Optional[Tuple[str, object]] = None
        self.thread: Optional[threading.Thread] = None
        self.t0 = time.monotonic()


@lockcheck.guarded
class FleetRouter:
    """Dispatch requests across replicas; the fleet's one client-facing
    brain.  Thread-safe; replicas come and go at runtime (the supervisor
    registers them as they pass readiness and removes them when their
    process dies).

    Lock order (enforced by analysis/lockcheck.py under
    ``DDLPC_LOCKCHECK=1``): ``FleetRouter._lock`` may be held while taking
    ``CircuitBreaker._lock`` (``_pick`` ranks and admits under the router
    lock); the reverse never happens — breaker callbacks
    (``_on_breaker``) log and count without touching the router lock."""

    def __init__(
        self,
        cfg: Optional[FleetConfig] = None,
        registry: Optional[MetricsRegistry] = None,
        logger=None,
        rng: Optional[random.Random] = None,
        sleep: Callable[[float], None] = time.sleep,
        tracer=None,
    ):
        self.cfg = cfg or FleetConfig()
        self.registry = registry if registry is not None else MetricsRegistry()
        self.metrics = RouterMetrics(registry=self.registry)
        self.logger = logger  # MetricsLogger(basename="router") or None
        self._rng = rng if rng is not None else random.Random()
        self._sleep = sleep
        # Distributed tracing: with an enabled Tracer each
        # dispatch mints a request trace id, records route_request +
        # per-attempt spans, and forwards the context to the replica on
        # the traceparent header.  None/disabled = zero-cost no-op.
        self.tracer = tracer
        # SLO layer: every routed request feeds the per-priority latency/
        # availability objectives; burn-rate alerts ride the health
        # monitor's fan-out (JSONL + ddlpc_alerts_total + /healthz).
        self.health = HealthMonitor(
            logger=logger, registry=self.registry, service="router"
        )
        self.slo = SLOTracker.from_fleet_config(
            self.cfg, registry=self.registry, monitor=self.health
        )
        # Content-addressed response cache (serve/cache.py): repeated
        # tiles answer from memory when the fleet serves one consistent
        # (step, quant) identity.  max_bytes=0 keeps every call a no-op.
        self.cache = ResponseCache(self.cfg.cache_max_bytes)
        self._lock = lockcheck.lock("FleetRouter._lock")
        self._cache_step: Optional[int] = None  # guarded-by: _lock
        self._replicas: dict = {}  # guarded-by: _lock
        self._rr = 0  # guarded-by: _lock (round-robin tiebreaker)
        self._drain_cond = lockcheck.condition(lock=self._lock)
        self._stop = threading.Event()
        self._scraper: Optional[threading.Thread] = None
        self._emitter: Optional[threading.Thread] = None

    # -- replica registry ---------------------------------------------------

    def _new_breaker(self, name: str) -> CircuitBreaker:
        """ONE construction site: a readmitted replica's fresh breaker
        must never drift from a freshly added one's."""
        return CircuitBreaker(
            window=self.cfg.breaker_window,
            min_samples=self.cfg.breaker_min_samples,
            error_rate=self.cfg.breaker_error_rate,
            cooldown_s=self.cfg.breaker_cooldown_s,
            half_open_probes=self.cfg.breaker_half_open_probes,
            close_after=self.cfg.breaker_close_after,
            on_transition=lambda to, n=name: self._on_breaker(n, to),
        )

    def add_replica(
        self, name: str, client: ReplicaClient, ready: bool = True,
        health: Optional[Dict[str, object]] = None,
    ) -> None:
        """``health``: the replica's ``/healthz`` answer that declared it
        ready, taken as its first scrape, so that the fleet's view (its
        serving step, queue, lineage) holds from the moment the replica
        counts as ready rather than from the next scrape pass."""
        breaker = self._new_breaker(name)
        with self._lock:
            r = self._replicas[name] = _Replica(name, client, breaker)
            r.ready = ready
            if health is not None:
                self._apply_health(r, health)
        self._log_event("replica_added", replica=name)
        self._publish_ready()

    def remove_replica(self, name: str) -> None:
        with self._lock:
            self._replicas.pop(name, None)
        self._log_event("replica_removed", replica=name)
        self._publish_ready()

    def set_ready(self, name: str, ready: bool) -> None:
        with self._lock:
            r = self._replicas.get(name)
            if r is not None:
                r.ready = ready
                if ready:
                    # A fresh process: forget the old error history.
                    r.healthy = True
                    r.scrape_fail_streak = 0
        self._publish_ready()

    def _on_breaker(self, name: str, to: str) -> None:
        self.metrics.record_breaker(name, to)
        self._log_event("breaker", replica=name, to=to)

    def _publish_ready(self) -> None:
        with self._lock:
            n = sum(
                1
                for r in self._replicas.values()
                if r.ready and not r.draining and r.healthy
            )
        self.metrics.set_ready(n)

    def replica_names(self) -> List[str]:
        with self._lock:
            return sorted(self._replicas)

    def replica_status(self) -> List[Dict[str, object]]:
        with self._lock:
            return [r.status() for _, r in sorted(self._replicas.items())]

    # -- scraping -----------------------------------------------------------

    def scrape_once(self) -> None:
        """One /healthz pass over the fleet: queue depth + occupancy feed
        the dispatch score; ``unhealthy_after`` consecutive failures take
        a replica out of rotation until a scrape succeeds again."""
        with self._lock:
            targets = [r for r in self._replicas.values() if r.ready]
        for r in targets:
            try:
                h = r.client.healthz(self.cfg.scrape_timeout_s)
            except Exception as e:
                with self._lock:
                    r.scrape_fail_streak += 1
                    if _is_conn_refused(e) and not r.ever_ok:
                        # Mid-launch: the port isn't listening yet.  Take
                        # the replica out of rotation NOW (don't wait for
                        # unhealthy_after) but stay off its breaker — a
                        # warming replica has done nothing wrong.
                        if r.healthy:
                            self._log_event(
                                "replica_warming", replica=r.name,
                            )
                        r.healthy = False
                    elif r.scrape_fail_streak >= self.cfg.unhealthy_after:
                        if r.healthy:
                            self._log_event(
                                "replica_unhealthy", replica=r.name,
                                scrape_failures=r.scrape_fail_streak,
                            )
                        r.healthy = False
                continue
            with self._lock:
                if not r.healthy:
                    self._log_event("replica_recovered", replica=r.name)
                self._apply_health(r, h)
        try:
            self._update_freshness()
        except Exception:
            pass  # freshness accounting must never break the scrape
        self._publish_ready()

    @staticmethod
    def _apply_health(r: "_Replica", h: Dict[str, object]) -> None:
        """One successful scrape's answer into the replica's record (the
        caller holds the lock)."""
        r.scrape_fail_streak = 0
        r.healthy = True
        r.ever_ok = True
        r.queue_depth = int(h.get("queue_depth") or 0)
        r.queue_depth_interactive = int(
            h.get("queue_depth_interactive", h.get("queue_depth"))
            or 0
        )
        r.queue_depth_batch = int(h.get("queue_depth_batch") or 0)
        r.quant_mode = h.get("quant_mode")
        occ = h.get("batch_occupancy")
        r.occupancy = float(occ) if occ is not None else None
        r.checkpoint_step = h.get("checkpoint_step")
        r.version = h.get("version")
        sb = h.get("slot_busy_fraction")
        r.slot_busy = float(sb) if sb is not None else None
        lid = h.get("lineage_id")
        r.lineage_id = lid if isinstance(lid, str) else None
        sv = h.get("lineage_saved_at")
        r.lineage_saved_at = (
            float(sv)
            if isinstance(sv, (int, float))
            and not isinstance(sv, bool)
            else None
        )
        if h.get("status") == "draining":
            # The replica is shutting down on its own (SIGTERM):
            # treat like a router-side drain — no new dispatch.
            r.draining = True

    def _update_freshness(self) -> None:
        """Model-age + step-skew gauges from the latest scrape.

        Age = newest DURABLE checkpoint's ``saved_at`` (read from the
        sidecar via the stdlib path — no torch import in this tier) minus
        the replica's serving ``saved_at``.  Replicas whose lineage is
        the unknown marker are skipped — their healthz carries the
        explicit ``lineage_unknown`` string; the gauge never invents an
        age for them.  The ``replica="fleet"`` series is the worst live
        replica (the fleet is only as fresh as its stalest member)."""
        workdir = getattr(self.cfg, "workdir", None)
        newest = (
            obs_lineage.newest_checkpoint_lineage(workdir)
            if workdir
            else None
        )
        newest_saved = newest.get("saved_at") if newest else None
        with self._lock:
            live = [
                r for r in self._replicas.values()
                if r.ready and r.healthy and not r.draining
            ]
            rows = [(r.name, r.lineage_saved_at) for r in live]
            steps = [
                int(r.checkpoint_step)
                for r in live
                if r.checkpoint_step is not None
            ]
        ages = []
        for name, saved in rows:
            if newest_saved is None or saved is None:
                continue
            age = max(0.0, float(newest_saved) - float(saved))
            self.metrics.set_model_age(name, age)
            ages.append(age)
        if ages:
            self.metrics.set_model_age("fleet", max(ages))
        if steps:
            self.metrics.set_step_skew(float(max(steps) - min(steps)))

    def start(self) -> "FleetRouter":
        """Start the background scrape loop (and JSONL emitter if a
        logger is attached)."""
        if self._scraper is None and self.cfg.scrape_every_s > 0:
            self._scraper = threading.Thread(
                target=self._scrape_loop, name="router-scrape", daemon=True
            )
            self._scraper.start()
        if (
            self._emitter is None
            and self.logger is not None
            and self.cfg.metrics_every_s > 0
        ):
            self._emitter = threading.Thread(
                target=self._emit_loop, name="router-metrics", daemon=True
            )
            self._emitter.start()
        return self

    def _scrape_loop(self) -> None:
        while not self._stop.wait(self.cfg.scrape_every_s):
            try:
                self.scrape_once()
            except Exception:
                pass  # scraping must never kill the router

    def _emit_loop(self) -> None:
        while not self._stop.wait(self.cfg.metrics_every_s):
            self.emit()

    def emit(self) -> Dict[str, object]:
        snap = self.metrics.snapshot()
        if self.logger is not None:
            self.logger.log(snap, echo=False)
        # SLO status rides the same cadence: burn-rate detectors evaluate
        # (alerts fan out via the health monitor) and one flat
        # kind="slo" record lands per emit — the error-budget ledger.
        self.slo.check()
        if self.logger is not None and self.slo.enabled:
            try:
                self.logger.log(self.slo.status(), echo=False)
            except Exception:
                pass  # accounting must never break dispatch
        if self.cache.enabled:
            stats = self.cache.stats()
            self.metrics.sync_cache(stats)
            if self.logger is not None:
                try:
                    self.logger.log(
                        {"kind": "cache", **stats}, echo=False
                    )
                except Exception:
                    pass
        return snap

    def _log_event(self, event: str, **fields) -> None:
        if self.logger is None:
            return
        try:
            self.logger.log(
                {"kind": "router", "event": event, **fields}, echo=False
            )
        except Exception:
            pass

    def close(self) -> None:
        self._stop.set()
        for t in (self._scraper, self._emitter):
            if t is not None:
                t.join(timeout=5.0)
        if self.logger is not None:
            self.emit()

    # -- drain / readmit ----------------------------------------------------

    def drain(self, name: str, timeout_s: Optional[float] = None) -> bool:
        """Stop dispatching to ``name``, wait for its router-side in-flight
        count to reach zero.  Returns False on timeout (work still in
        flight — callers decide whether to proceed anyway)."""
        timeout_s = (
            self.cfg.drain_timeout_s if timeout_s is None else timeout_s
        )
        deadline = time.monotonic() + timeout_s
        with self._lock:
            r = self._replicas.get(name)
            if r is None:
                return True
            r.draining = True
            while r.inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._publish_ready_locked()
                    return False
                self._drain_cond.wait(remaining)
        self.metrics.record_drain()
        self._log_event("drain", replica=name)
        self._publish_ready()
        return True

    def _publish_ready_locked(self) -> None:
        n = sum(
            1
            for r in self._replicas.values()
            if r.ready and not r.draining and r.healthy
        )
        self.metrics.set_ready(n)

    def readmit(self, name: str) -> None:
        """Put a drained replica back into dispatch with a clean slate
        (fresh weights or a fresh process deserve a fresh breaker)."""
        with self._lock:
            r = self._replicas.get(name)
            if r is None:
                return
            r.draining = False
            r.breaker = self._new_breaker(name)
        self.metrics.record_readmit()
        self._log_event("readmit", replica=name)
        self._publish_ready()

    # -- dispatch -----------------------------------------------------------

    def _pick(self, exclude: Sequence[str]) -> Optional[_Replica]:
        """Least-loaded eligible replica, preferring ones not in
        ``exclude`` (a retry must land ELSEWHERE when anywhere else
        exists).  Score = router-side in-flight + scraped queue depth."""
        with self._lock:
            def eligible(r: _Replica) -> bool:
                return (
                    r.ready
                    and not r.draining
                    and r.healthy
                    and r.breaker.available()
                )

            ordered = [
                self._replicas[n] for n in sorted(self._replicas)
            ]
            pool = [
                r for r in ordered if eligible(r) and r.name not in exclude
            ]
            if not pool:
                pool = [r for r in ordered if eligible(r)]
            if not pool:
                return None
            # Rotate equal scores round-robin: stable sort by load keeps
            # the rotated order among ties, so an idle fleet spreads
            # instead of hammering whichever name sorts first.
            self._rr += 1
            k = self._rr % len(pool)
            pool = pool[k:] + pool[:k]
            pool.sort(key=lambda r: r.inflight + r.queue_depth)
            for r in pool:
                if r.breaker.acquire():
                    r.inflight += 1
                    return r
            return None

    def _finish_attempt(self, a: _Attempt, ok: Optional[bool]) -> None:
        """Attempt bookkeeping, run by the ATTEMPT THREAD on completion —
        not the dispatch loop, which may long since have answered the
        client off a faster attempt.  ``ok=None`` means cancelled (a
        hedge loser, a raced retry): the failure is the router's doing,
        so it must not poison the replica's breaker — but the admission
        it acquired (a half-open probe slot, possibly) must be
        released."""
        if ok is not None:
            a.replica.breaker.record(ok)
        else:
            a.replica.breaker.release()
        with self._lock:
            a.replica.inflight = max(0, a.replica.inflight - 1)
            self._drain_cond.notify_all()

    def _launch_waiting(
        self, body: bytes, query: str, reason: str,
        exclude: Sequence[str], done: "queue.Queue[_Attempt]",
        trace_id: Optional[str] = None,
    ) -> Optional["_Attempt"]:
        """`_launch` plus the bounded zero-eligible wait: a rolling
        reload's drain→readmit hand-off, a relaunch-readiness gap, and a
        breaker cooldown can momentarily leave NO eligible replica — a
        transient total-outage blip that should surface as tail latency,
        not a client-visible 503.  Admission and the no-pending retry
        pick ride it out the same way (per-pick bound)."""
        a = self._launch(body, query, reason, exclude, done, trace_id)
        if a is None and self.cfg.no_replica_wait_ms > 0:
            deadline = (
                time.monotonic() + self.cfg.no_replica_wait_ms / 1000.0
            )
            while a is None and time.monotonic() < deadline:
                self._sleep(self._rng.uniform(0.01, 0.04))
                a = self._launch(body, query, reason, exclude, done, trace_id)
        return a

    def _launch(
        self, body: bytes, query: str, reason: str,
        exclude: Sequence[str], done: "queue.Queue[_Attempt]",
        trace_id: Optional[str] = None,
    ) -> Optional[_Attempt]:
        r = self._pick(exclude)
        if r is None:
            return None
        a = _Attempt(r, reason)
        self.metrics.record_attempt(r.name, reason)
        tr = self.tracer
        traced = trace_id is not None and tr is not None and tr.enabled

        def call() -> Response:
            timeout_s = self.cfg.request_timeout_ms / 1000.0
            if not traced:
                # Untraced: exact pre-trace call shape, so fakes with the
                # old predict signature keep working.
                return r.client.predict(body, query, timeout_s, cancel=a.cancel)
            # One 16-hex span id per ATTEMPT: it rides the traceparent
            # header to the replica (whose serve_request records it as
            # remote_parent) AND is recorded on the attempt span as
            # span_hex — the two halves obs/merge.py joins on.
            attempt_hex = new_span_hex()
            with tr.bind(trace_id):
                with tr.span(
                    "router_attempt", replica=r.name, reason=reason,
                    span_hex=attempt_hex,
                ) as sp:
                    resp = r.client.predict(
                        body, query, timeout_s, cancel=a.cancel,
                        traceparent=format_traceparent(trace_id, attempt_hex),
                    )
                    sp.set(status=resp[0], cancelled=a.cancel.is_set())
                    return resp

        def run() -> None:
            ok: Optional[bool] = None
            try:
                resp = call()
                a.outcome = ("response", resp)
                ok = resp[0] < 500
                with self._lock:
                    r.ever_ok = True  # answered: warming grace is over
            except Exception as e:
                a.outcome = ("fail", e)
                ok = False
                if _is_conn_refused(e) and not r.ever_ok:
                    # Still warming (supervisor raced readiness, or a fake
                    # marked it ready early): neutral for the breaker —
                    # release the permit without recording an outcome —
                    # and out of rotation until a scrape succeeds.
                    ok = None
                    with self._lock:
                        if r.healthy:
                            self._log_event(
                                "replica_warming", replica=r.name,
                            )
                        r.healthy = False
            if ok is False and a.cancel.is_set():
                ok = None  # cancelled loser: neutral for the breaker
            self._finish_attempt(a, ok)
            done.put(a)

        a.thread = threading.Thread(
            target=run, name=f"router-attempt-{r.name}", daemon=True
        )
        a.thread.start()
        return a

    @staticmethod
    def _cancel(attempts: List[_Attempt], winner: Optional[_Attempt]) -> None:
        for a in attempts:
            if a is winner or a.outcome is not None:
                continue
            a.cancel.set()
            cancel_hook = getattr(a.replica.client, "cancel_attempt", None)
            if cancel_hook is not None:
                try:
                    cancel_hook(a.cancel)
                except Exception:
                    pass

    def _should_shed_batch(self) -> bool:
        """Bulk shedding rule: with ``batch_shed_queue_depth`` armed,
        ?priority=batch requests are shed when EVERY eligible replica's
        scraped interactive queue is at or past the threshold — bulk work
        must never consume the last admission the interactive tail needs.
        Interactive traffic is never shed by this rule."""
        threshold = int(self.cfg.batch_shed_queue_depth)
        if threshold <= 0:
            return False
        with self._lock:
            eligible = [
                r
                for r in self._replicas.values()
                if r.ready and not r.draining and r.healthy
                and r.breaker.available()
            ]
            if not eligible:
                return False  # the normal no-replica path answers this
            return all(
                r.queue_depth_interactive >= threshold for r in eligible
            )

    def dispatch(
        self, body: bytes, query: str = "",
        trace_context: Optional[Tuple[str, Optional[str]]] = None,
        info: Optional[dict] = None,
    ) -> Response:
        """Route one request; ALWAYS returns a response.  A 5xx here means
        every eligible replica (and every retry/hedge) failed — the
        client-visible failure a fault run requires to be zero.
        ``?priority=batch`` requests may additionally be SHED here (a
        policy 503, accounted separately from failures) when the fleet's
        interactive queues are saturated, and are never hedged — hedges
        are a p99-tail spend reserved for interactive traffic.

        ``trace_context`` is an optional (trace_id, parent span hex) pair
        parsed from an inbound traceparent header — an external client's
        trace continues through the fleet; without one a traced router
        mints a fresh request trace id.

        ``info``, when given, is filled in-place with attribution for
        the caller's response headers: ``cache_hit``, ``model_step``
        (the serving checkpoint step this answer came from), and
        ``lineage_id`` — every served prediction, including a cache
        hit, stays attributable to the exact training step."""
        priority = _priority_of(query)
        if priority == "batch" and self._should_shed_batch():
            self.metrics.record_batch_shed()
            self._log_event("batch_shed")
            return self._error(
                503, "bulk traffic shed: interactive queues saturated; "
                "retry with backoff"
            )
        t0 = time.monotonic()
        inf = info if info is not None else {}
        tr = self.tracer
        cache_key = None
        if self.cache.enabled and not _cache_bypass(query):
            ident = self._cache_identity()
            if ident is not None:
                cache_key = response_key(
                    body, ident[0], ident[1], lineage_id=ident[2]
                )
                cached = self.cache.get(cache_key)
                if cached is not None:
                    # A hit is a real answered request: it feeds the same
                    # ledgers (latency ring, SLO) as a routed one — the
                    # p99 win must be visible, not hidden from the stats.
                    latency_s = time.monotonic() - t0
                    self.metrics.record_request(latency_s, True)
                    self.slo.observe(priority, latency_s, True)
                    inf["cache_hit"] = True
                    inf["model_step"] = ident[0]
                    inf["lineage_id"] = ident[2]
                    if tr is not None and tr.enabled:
                        # The hit used to return without a span — a
                        # dangling trace with no fleet-side record.  The
                        # cache_hit span closes it, carrying the same
                        # lineage attribution as a routed answer, and is
                        # breaker-neutral by construction: no replica is
                        # touched, so no breaker sees this request.
                        trace_id, parent_hex = (
                            trace_context
                            if trace_context is not None
                            else (new_trace_id(), None)
                        )
                        with tr.bind(trace_id, parent_hex):
                            with tr.span(
                                "cache_hit",
                                priority=priority,
                                model_step=ident[0],
                                lineage_id=ident[2],
                            ) as sp:
                                sp.set(status=cached[0])
                    return cached
        if tr is not None and tr.enabled:
            trace_id, parent_hex = (
                trace_context
                if trace_context is not None
                else (new_trace_id(), None)
            )
            with tr.bind(trace_id, parent_hex):
                with tr.span("route_request", priority=priority) as sp:
                    status, ctype, payload = self._dispatch_inner(
                        body, query, priority, trace_id, info=inf
                    )
                    sp.set(
                        status=status,
                        model_step=inf.get("model_step"),
                        lineage_id=inf.get("lineage_id"),
                    )
        else:
            status, ctype, payload = self._dispatch_inner(
                body, query, priority, info=inf
            )
        ok = status < 500
        latency_s = time.monotonic() - t0
        self.metrics.record_request(latency_s, ok)
        self.slo.observe(priority, latency_s, ok)
        if cache_key is not None and ok:
            self.cache.put(cache_key, (status, ctype, payload))
        return status, ctype, payload

    # -- response cache -----------------------------------------------------

    def _cache_identity(self) -> Optional[Tuple[int, str, Optional[str]]]:
        """The fleet's consensus serving identity (step, quant mode,
        lineage id), or None when there isn't one — no scraped step yet,
        or mixed steps / quant modes mid-rolling-reload (caching simply
        pauses; the step is also in the key, so this is belt on top of
        braces).  The lineage id is part of the returned identity only
        when every live replica agrees on one; disagreement or the
        unknown marker degrades to None (the pre-lineage key), never a
        refusal to cache.  A consensus step DIFFERENT from the last one
        flushes the cache: that is the fleet-wide invalidation on any
        reload — forward or rollback — that changes the serving step."""
        flush = False
        with self._lock:
            live = [
                r for r in self._replicas.values()
                if r.ready and r.healthy and not r.draining
                and r.checkpoint_step is not None
            ]
            steps = {int(r.checkpoint_step) for r in live}
            quants = {r.quant_mode or "none" for r in live}
            if len(steps) != 1 or len(quants) != 1:
                return None
            step, quant = steps.pop(), quants.pop()
            lids = {r.lineage_id for r in live}
            lid = lids.pop() if len(lids) == 1 else None
            if lid == obs_lineage.LINEAGE_UNKNOWN:
                lid = None
            if self._cache_step is not None and self._cache_step != step:
                flush = True
            self._cache_step = step
        if flush:
            # Outside _lock: the router lock must never wait on the cache
            # lock while a put is evicting.
            dropped = self.cache.invalidate("step_change")
            self._log_event(
                "cache_invalidate", reason="step_change", dropped=dropped,
                step=step,
            )
        return step, quant, lid

    def invalidate_cache(self, reason: str) -> int:
        """Fleet-wide cache flush, called by the supervisor around any
        reload outcome that moves the serving step (including the
        rollback after an aborted one).  Always logged when the cache is
        on — a fault run audits for this record on the rollback path."""
        if not self.cache.enabled:
            return 0
        dropped = self.cache.invalidate(reason)
        with self._lock:
            self._cache_step = None  # re-learn consensus from scrapes
        self._log_event("cache_invalidate", reason=reason, dropped=dropped)
        return dropped

    def _error(self, status: int, msg: str) -> Response:
        return status, "application/json", json.dumps({"error": msg}).encode()

    def _dispatch_inner(
        self, body: bytes, query: str, priority: str = "interactive",
        trace_id: Optional[str] = None, info: Optional[dict] = None,
    ) -> Response:
        cfg = self.cfg
        done: "queue.Queue[_Attempt]" = queue.Queue()
        attempts: List[_Attempt] = []
        tried: List[str] = []
        retries_left = max(0, int(cfg.retries))
        hedges_left = (
            max(0, int(cfg.hedge_max))
            if cfg.hedge_ms > 0 and priority == "interactive"
            else 0
        )

        a = self._launch_waiting(body, query, "primary", tried, done, trace_id)
        if a is None:
            self._log_event("no_replicas")
            return self._error(503, "no replicas available")
        attempts.append(a)
        tried.append(a.replica.name)
        pending = 1

        while True:
            timeout = cfg.hedge_ms / 1000.0 if hedges_left > 0 else None
            try:
                fin: _Attempt = done.get(timeout=timeout)
            except queue.Empty:
                # The tail case: nobody answered within hedge_ms — duplicate
                # to another replica, first answer wins.
                hedges_left -= 1
                h = self._launch(body, query, "hedge", tried, done, trace_id)
                if h is not None:
                    self.metrics.record_hedge()
                    attempts.append(h)
                    tried.append(h.replica.name)
                    pending += 1
                continue

            pending -= 1
            kind, val = fin.outcome  # type: ignore[misc]
            if kind == "response":
                st, ctype, payload = val[:3]  # type: ignore[misc]
                if st < 500:
                    # Success or a client-owned 4xx: either way the replica
                    # answered coherently — return it, cancel the rest
                    # (each loser's own thread does its bookkeeping).
                    self._cancel(attempts, fin)
                    if fin.reason == "hedge":
                        self.metrics.record_hedge_win()
                    if info is not None:
                        # Attribution: prefer the replica's per-response
                        # model-step header (exact even mid-reload) over
                        # the last scrape's step.
                        hdr = val[3] if len(val) > 3 else None
                        info["cache_hit"] = False
                        info["replica"] = fin.replica.name
                        if hdr is not None and hdr.isdigit():
                            info["model_step"] = int(hdr)
                        elif hdr is not None:
                            info["model_step"] = hdr
                        else:
                            info["model_step"] = fin.replica.checkpoint_step
                        info["lineage_id"] = fin.replica.lineage_id
                    return st, ctype, payload
                cause = f"http_{st}"
            else:
                cause = (
                    "cancelled" if fin.cancel.is_set() else "transport"
                )
            if fin.cancel.is_set():
                # A cancelled loser finishing late is not a new failure;
                # don't burn a retry on it.
                if pending == 0 and retries_left == 0:
                    return self._error(503, "all replica attempts failed")
                continue

            if retries_left > 0:
                retries_left -= 1
                self.metrics.record_retry(cause)
                # Full-jitter backoff before the retry (attempt number =
                # how many have failed so far).
                n_failed = len([x for x in attempts if x.outcome is not None])
                ceiling = min(
                    cfg.retry_backoff_ms * (2.0 ** max(n_failed - 1, 0)),
                    1000.0,
                ) / 1000.0
                delay = self._rng.uniform(0.0, ceiling)
                if delay > 0:
                    self._sleep(delay)
                nxt = self._launch(body, query, "retry", tried, done, trace_id)
                if nxt is None and pending == 0:
                    # With nothing pending this would fall through to an
                    # instant 503 — the same transient zero-eligible
                    # window the admission wait rides out (an untried
                    # replica readmitting mid-reload); wait for it too.
                    nxt = self._launch_waiting(
                        body, query, "retry", tried, done, trace_id
                    )
                if nxt is not None:
                    attempts.append(nxt)
                    tried.append(nxt.replica.name)
                    pending += 1
                    continue
                # Nowhere to retry: fall through to waiting on any
                # still-pending attempt, else fail.
            if pending > 0:
                continue
            self._log_event(
                "request_failed", attempts=len(attempts), last_cause=cause
            )
            return self._error(503, "all replica attempts failed")

    # -- fleet health summary ----------------------------------------------

    def healthz(self) -> dict:
        statuses = self.replica_status()
        ready = [
            s
            for s in statuses
            if s["ready"] and not s["draining"] and s["healthy"]
        ]
        out = {
            "status": "ok" if ready else "unavailable",
            "replicas": len(statuses),
            "ready": len(ready),
            "checkpoint_steps": sorted(
                {
                    s["checkpoint_step"]
                    for s in statuses
                    if s["checkpoint_step"] is not None
                }
            ),
            "replica_status": statuses,
        }
        steps = out["checkpoint_steps"]
        # Nonzero only in a mixed-weights window (mid-rolling-reload);
        # the fleet test pins >0 there and ==0 once converged.
        out["step_skew"] = (max(steps) - min(steps)) if steps else None
        if self.cache.enabled:
            out["cache"] = self.cache.stats()
        if self.slo.enabled:
            # Error budgets + burn rates on the fleet's ONE health
            # endpoint: the SLO layer is scrapeable where the operator
            # already looks.
            out["slo"] = self.slo.status()
            out["slo_alerts"] = [
                a for a in self.health.alerts
                if str(a.get("alert", "")).startswith("slo_")
            ]
        return out
