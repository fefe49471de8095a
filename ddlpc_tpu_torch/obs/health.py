"""Health detectors: turn metric streams into structured alert records.

Three detectors cover the failure modes that keep showing up in
practice — the kind a human spots by staring at metrics.jsonl after the
fact, emitted live instead:

- :class:`EwmaRegressionDetector` — step-time regression: the observed
  value exceeds ``factor`` × its own exponentially-weighted moving average
  (the standard drift-tolerant baseline: slow drift folds into the EWMA,
  a sudden regression does not);
- :class:`LossDetector` — NaN/inf loss (critical, always) and loss spikes
  against the same EWMA logic;
- :class:`QueueSaturationDetector` — the serve admission queue sitting at
  ≥ ``threshold`` of its limit for ``consecutive`` observations (a single
  full sample is a burst; a sustained one means shedding is imminent).

Alerts are plain flat records (``kind="alert"``) published by the
:class:`HealthMonitor` into the run's JSONL metrics stream, the Prometheus
registry (``ddlpc_alerts_total{alert,severity}``), and the
``StallWatchdog``'s recent-alert ring — so a stall diagnosis shows what
health was doing just before the hang.  Detection never raises into the
loop being observed.

The port's own copy of ``ddlpc_tpu/obs/health.py`` (stdlib only), kept line for line
so the two read alike, but for the fleet router's SLO tracking (error
budgets and burn-rate alerts), which comes with the router.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ddlpc_tpu_torch.analysis import lockcheck


@dataclass
class Alert:
    """One structured health alert.  ``record()`` is the flat JSONL form."""

    alert: str  # detector kind, e.g. "step_time_regression"
    severity: str  # "warn" | "critical"
    message: str
    value: float
    threshold: float
    context: Dict[str, object] = field(default_factory=dict)

    def record(self) -> Dict[str, object]:
        rec: Dict[str, object] = {
            "kind": "alert",
            "alert": self.alert,
            "severity": self.severity,
            "message": self.message,
            "value": None if math.isnan(self.value) else round(self.value, 6),
            "threshold": round(self.threshold, 6),
        }
        rec.update(self.context)
        return rec


class EwmaRegressionDetector:
    """Fires when an observation exceeds ``factor`` × the EWMA of previous
    observations.  The first ``warmup`` observations only seed the average
    (compile-time first steps must not count as regressions); the alerting
    observation still updates the EWMA, so a sustained new plateau stops
    alerting once the average catches up (level shift, not a siren)."""

    def __init__(
        self,
        kind: str = "step_time_regression",
        factor: float = 1.5,
        alpha: float = 0.2,
        warmup: int = 5,
        severity: str = "warn",
    ):
        if factor <= 1.0:
            raise ValueError(f"factor must be > 1, got {factor}")
        self.kind = kind
        self.factor = float(factor)
        self.alpha = float(alpha)
        self.warmup = int(warmup)
        self.severity = severity
        self._ewma: Optional[float] = None
        self._seen = 0

    def observe(self, value: float) -> Optional[Alert]:
        v = float(value)
        if math.isnan(v) or math.isinf(v):
            return None  # not this detector's failure mode
        alert = None
        if self._seen >= self.warmup and self._ewma is not None:
            limit = self.factor * self._ewma
            if v > limit and self._ewma > 0:
                alert = Alert(
                    alert=self.kind,
                    severity=self.severity,
                    message=(
                        f"{self.kind}: {v:.4g} > {self.factor:.2f}x "
                        f"EWMA {self._ewma:.4g}"
                    ),
                    value=v,
                    threshold=limit,
                    context={"ewma": round(self._ewma, 6)},
                )
        self._ewma = (
            v
            if self._ewma is None
            else (1 - self.alpha) * self._ewma + self.alpha * v
        )
        self._seen += 1
        return alert


class LossDetector:
    """NaN/inf loss → critical alert (always, every observation — a NaN
    loss means the run is dead and the record should say so repeatedly);
    finite spikes ride the EWMA regression logic."""

    def __init__(self, factor: float = 2.0, alpha: float = 0.3, warmup: int = 3):
        self._ewma = EwmaRegressionDetector(
            kind="loss_spike", factor=factor, alpha=alpha, warmup=warmup
        )

    def observe(self, loss: float) -> Optional[Alert]:
        v = float(loss)
        if math.isnan(v) or math.isinf(v):
            return Alert(
                alert="loss_nonfinite",
                severity="critical",
                message=f"loss is {v!r}: the optimization has diverged",
                value=v,
                threshold=0.0,
            )
        return self._ewma.observe(v)


class QueueSaturationDetector:
    """Sustained queue saturation: depth/limit ≥ ``threshold`` for
    ``consecutive`` observations fires once, then holds until the queue
    drops below the threshold (re-arms on recovery — no alert-per-scrape
    spam while saturated)."""

    def __init__(self, threshold: float = 0.9, consecutive: int = 3):
        if not 0.0 < threshold <= 1.0:
            raise ValueError(f"threshold must be in (0, 1], got {threshold}")
        self.threshold = float(threshold)
        self.consecutive = int(consecutive)
        self._streak = 0
        self._latched = False

    def observe(self, depth: int, limit: int) -> Optional[Alert]:
        ratio = depth / max(int(limit), 1)
        if ratio < self.threshold:
            self._streak = 0
            self._latched = False
            return None
        self._streak += 1
        if self._streak < self.consecutive or self._latched:
            return None
        self._latched = True
        return Alert(
            alert="queue_saturation",
            severity="warn",
            message=(
                f"admission queue at {depth}/{limit} "
                f"({ratio:.0%}) for {self._streak} consecutive samples — "
                f"shedding imminent"
            ),
            value=ratio,
            threshold=self.threshold,
            context={"queue_depth": int(depth), "queue_limit": int(limit)},
        )


@lockcheck.guarded
class HealthMonitor:
    """Owns the detectors for one process side and fans alerts out to the
    JSONL stream, the metrics registry, and the stall watchdog."""

    def __init__(
        self,
        logger=None,
        registry=None,
        watchdog=None,
        service: str = "train",
        step_time_factor: float = 1.5,
        loss_factor: float = 2.0,
        queue_threshold: float = 0.9,
        max_kept: int = 64,
    ):
        self.logger = logger
        self.watchdog = watchdog
        self.service = service
        # Appended by the observing thread, snapshotted by HTTP handler
        # threads (/healthz) — same discipline as the watchdog's ring:
        # mutation and iteration under one lock, or CPython raises
        # "deque mutated during iteration" into a scrape.
        self._alerts: deque = deque(maxlen=max_kept)  # guarded-by: _alerts_lock
        self._alerts_lock = lockcheck.lock("HealthMonitor._alerts_lock")
        self._step_time = EwmaRegressionDetector(factor=step_time_factor)
        self._loss = LossDetector(factor=loss_factor)
        self._queue = QueueSaturationDetector(threshold=queue_threshold)
        self._counter = (
            registry.counter(
                "ddlpc_alerts_total",
                "Health alerts emitted, by detector and severity.",
                labelnames=("alert", "severity"),
            )
            if registry is not None
            else None
        )

    @property
    def alerts(self) -> List[Dict[str, object]]:
        """Snapshot of the recent alert records (thread-safe)."""
        with self._alerts_lock:
            return list(self._alerts)

    def emit(self, alert: Alert) -> Dict[str, object]:
        rec = alert.record()
        rec["service"] = self.service
        rec.setdefault("time", time.time())
        with self._alerts_lock:
            self._alerts.append(rec)
        if self._counter is not None:
            self._counter.inc(alert=alert.alert, severity=alert.severity)
        if self.watchdog is not None:
            try:
                self.watchdog.record_alert(rec)
            except Exception:
                pass  # diagnostics must not break the observed loop
        if self.logger is not None:
            try:
                self.logger.log(rec, echo=alert.severity == "critical")
            except Exception:
                pass
        return rec

    def observe_train(self, record: Dict[str, object]) -> List[Alert]:
        """Feed one epoch/step metrics record; emits and returns alerts."""
        out: List[Alert] = []
        loss = record.get("loss")
        if isinstance(loss, (int, float)):
            a = self._loss.observe(loss)
            if a is not None:
                out.append(a)
        st = record.get("step_time_s")
        if isinstance(st, (int, float)):
            a = self._step_time.observe(st)
            if a is not None:
                out.append(a)
        for a in out:
            self.emit(a)
        return out

    def observe_queue(self, depth: int, limit: int) -> Optional[Alert]:
        """Feed one serve queue-depth sample; emits and returns the alert."""
        a = self._queue.observe(depth, limit)
        if a is not None:
            self.emit(a)
        return a
