"""Serving observability: latency quantiles, queue depth, occupancy, rates.

Rides the same JSONL stream shape as training (`train/observability.py`
``MetricsLogger``): one flat JSON object per emit, so the tooling that tails
training metrics tails serving metrics unchanged.  Quantiles AND batch
occupancy come from bounded rings of recent observations (windowed, not
lifetime, so a load spike is visible in p99 — and a cold-start occupancy
ramp ages out instead of dragging the reported mean forever); rates
(requests/sec, tiles/sec) are measured over the interval since the previous
snapshot.

With a ``registry`` (obs/registry.py) every hook also updates the
Prometheus-side series (``ddlpc_serve_*``), so the text exposition on
``GET /metrics`` reflects live counters without a snapshot cycle.

The port's own copy of ``ddlpc_tpu/serve/metrics.py`` (stdlib only), kept line for line
so the two read alike.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

import numpy as np


class ServeMetrics:
    """Thread-safe counters + windowed latency histogram for the serve path.

    Hooked by the frontend (``record_request``: one call per scene request
    with its end-to-end latency and tile count — so ``requests_per_sec`` is
    scene throughput and ``tiles_per_sec`` is accelerator throughput, which
    differ for multi-window scenes) and by the batcher (batch occupancy,
    queue depth, sheds, deadline misses).
    """

    def __init__(self, window: int = 2048, registry=None):
        self._lock = threading.Lock()
        self._lat = deque(maxlen=window)  # seconds, most-recent window
        # Per-priority-class latency rings (serve/cbatch.py): bulk tiling
        # work must be visible as ITS OWN tail, not a contaminant of the
        # interactive p99 the fleet router protects.
        self._lat_by_prio = {
            "interactive": deque(maxlen=window),
            "batch": deque(maxlen=window),
        }
        # Windowed like the latency ring: a day-old cold-start ramp must
        # not drag the reported occupancy permanently (the old lifetime
        # `_occupancy_sum` did exactly that).
        self._occ = deque(maxlen=window)
        self.requests = 0
        self.tiles = 0
        self.shed = 0
        self.shed_batch = 0  # bulk-class admissions shed (subset of shed)
        self.deadline_exceeded = 0
        self.batches = 0
        self.queue_depth = 0
        self.priority_depths = {"interactive": 0, "batch": 0}
        self.slot_busy: Dict[int, float] = {}
        # False until a priority-aware batcher reports per-class depths;
        # snapshot() then mirrors the single queue into interactive so a
        # coalesce-mode stream never contradicts itself (queue_depth=40,
        # queue_depth_interactive=0).
        self._prio_source = False
        self._t0 = time.monotonic()
        self._last_t = self._t0
        self._last_requests = 0
        self._last_tiles = 0
        # Prometheus-side series (optional; obs/registry.py).
        self._reg = None
        if registry is not None:
            self._reg = {
                "requests": registry.counter(
                    "ddlpc_serve_requests_total", "Scene requests completed."
                ),
                "tiles": registry.counter(
                    "ddlpc_serve_tiles_total", "Tiles forwarded for requests."
                ),
                "latency": registry.histogram(
                    "ddlpc_serve_request_latency_seconds",
                    "End-to-end scene request latency.",
                ),
                "shed": registry.counter(
                    "ddlpc_serve_shed_total", "Requests shed at admission."
                ),
                "deadline": registry.counter(
                    "ddlpc_serve_deadline_exceeded_total",
                    "Requests expired in queue past their deadline.",
                ),
                "batches": registry.counter(
                    "ddlpc_serve_batches_total", "Batched forwards executed."
                ),
                "occupancy": registry.gauge(
                    "ddlpc_serve_batch_occupancy",
                    "Occupancy (size/capacity) of the most recent batch.",
                ),
                "queue_depth": registry.gauge(
                    "ddlpc_serve_queue_depth", "Admission queue depth (tiles)."
                ),
                "priority_depth": registry.gauge(
                    "ddlpc_serve_priority_queue_depth",
                    "Admission queue depth by priority class "
                    "(continuous batcher).",
                    labelnames=("priority",),
                ),
                "slot_busy": registry.gauge(
                    "ddlpc_serve_slot_busy_fraction",
                    "Busy fraction of each continuous-batcher slot worker "
                    "over the last metrics window — the signal for sizing "
                    "`slots`.",
                    labelnames=("slot",),
                ),
            }

    # ---- recording hooks ---------------------------------------------------

    def record_request(
        self, latency_s: float, tiles: int = 1, priority: str = "interactive"
    ) -> None:
        with self._lock:
            self._lat.append(float(latency_s))
            ring = self._lat_by_prio.get(priority)
            if ring is not None:
                ring.append(float(latency_s))
            self.requests += 1
            self.tiles += int(tiles)
        if self._reg is not None:
            self._reg["requests"].inc()
            self._reg["tiles"].inc(int(tiles))
            self._reg["latency"].observe(float(latency_s))

    def record_batch(self, size: int, capacity: int) -> None:
        occ = size / max(capacity, 1)
        with self._lock:
            self.batches += 1
            self._occ.append(occ)
        if self._reg is not None:
            self._reg["batches"].inc()
            self._reg["occupancy"].set(occ)

    def record_shed(self, n: int = 1, priority: str = "interactive") -> None:
        with self._lock:
            self.shed += int(n)
            if priority == "batch":
                self.shed_batch += int(n)
        if self._reg is not None:
            self._reg["shed"].inc(int(n))

    def record_deadline(self, n: int = 1) -> None:
        with self._lock:
            self.deadline_exceeded += int(n)
        if self._reg is not None:
            self._reg["deadline"].inc(int(n))

    def set_queue_depth(self, depth: int) -> None:
        with self._lock:
            self.queue_depth = int(depth)
        if self._reg is not None:
            self._reg["queue_depth"].set(int(depth))

    def set_priority_queue_depth(self, depths: Dict[str, int]) -> None:
        """Per-priority-class depths (continuous batcher hook)."""
        with self._lock:
            self._prio_source = True
            self.priority_depths.update(
                {p: int(d) for p, d in depths.items()}
            )
        if self._reg is not None:
            for p, d in depths.items():
                self._reg["priority_depth"].set(int(d), priority=p)

    def priority_queue_depths(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.priority_depths)

    def set_slot_busy(self, fractions: Dict[int, float]) -> None:
        """Per-slot busy fractions (continuous batcher, emit cadence)."""
        with self._lock:
            self.slot_busy = {int(s): float(f) for s, f in fractions.items()}
        if self._reg is not None:
            for s, f in fractions.items():
                self._reg["slot_busy"].set(float(f), slot=str(s))

    # ---- readout -----------------------------------------------------------

    def occupancy(self) -> Optional[float]:
        """Windowed mean batch occupancy (None before the first batch).

        Cheap enough for every ``/healthz`` — the fleet router's
        occupancy-aware dispatch scrapes this once per second per replica,
        so it must not pay the full ``snapshot()`` percentile pass."""
        with self._lock:
            return float(np.mean(self._occ)) if self._occ else None

    def percentiles_ms(self) -> Dict[str, Optional[float]]:
        with self._lock:
            lat = list(self._lat)
        if not lat:
            return {"p50_ms": None, "p95_ms": None, "p99_ms": None}
        p50, p95, p99 = np.percentile(np.asarray(lat) * 1000.0, [50, 95, 99])
        return {
            "p50_ms": round(float(p50), 3),
            "p95_ms": round(float(p95), 3),
            "p99_ms": round(float(p99), 3),
        }

    def snapshot(self, advance: bool = True) -> Dict[str, object]:
        """One flat record: cumulative counters + windowed quantiles +
        interval rates.

        ``advance=True`` (the periodic emitter, the bench) closes the rate
        interval; ``advance=False`` (ad-hoc readers like ``GET /metrics``)
        reads rates over the currently open interval WITHOUT resetting it,
        so scrapes cannot corrupt the emitter's cadence."""
        pct = self.percentiles_ms()
        with self._lock:
            now = time.monotonic()
            dt = max(now - self._last_t, 1e-9)
            req_rate = (self.requests - self._last_requests) / dt
            tile_rate = (self.tiles - self._last_tiles) / dt
            if advance:
                self._last_t = now
                self._last_requests = self.requests
                self._last_tiles = self.tiles
            occupancy = float(np.mean(self._occ)) if self._occ else None
            by_prio = {}
            for p, ring in self._lat_by_prio.items():
                if ring:
                    by_prio[f"{p}_p99_ms"] = round(
                        float(np.percentile(np.asarray(ring) * 1e3, 99)), 3
                    )
            return {
                "kind": "serve",
                **pct,
                **by_prio,
                "requests": self.requests,
                "tiles": self.tiles,
                "shed": self.shed,
                "shed_batch": self.shed_batch,
                "deadline_exceeded": self.deadline_exceeded,
                "batches": self.batches,
                "batch_occupancy": (
                    round(occupancy, 4) if occupancy is not None else None
                ),
                "queue_depth": self.queue_depth,
                "queue_depth_interactive": (
                    self.priority_depths["interactive"]
                    if self._prio_source
                    else self.queue_depth
                ),
                "queue_depth_batch": self.priority_depths["batch"],
                "requests_per_sec": round(req_rate, 3),
                "tiles_per_sec": round(tile_rate, 3),
                "uptime_s": round(now - self._t0, 3),
            }

    def emit(self, logger) -> Dict[str, object]:
        """Write a snapshot onto a ``MetricsLogger`` JSONL stream."""
        snap = self.snapshot()
        logger.log(snap, echo=False)
        return snap
