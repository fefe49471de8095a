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

The fleet router's SLO layer lives here too: :class:`SLOTracker` keeps
error budgets per priority class and raises multi-window burn-rate
alerts through the same monitor.

The port's own copy of ``ddlpc_tpu/obs/health.py`` (stdlib only), kept line for line
so the two read alike.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

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


# ---------------------------------------------------------------------------
# SLO tracking: error budgets + multi-window burn-rate alerts
# ---------------------------------------------------------------------------


class _WindowCounter:
    """Sliding-window good/bad accounting at O(1) time and bounded
    memory: events aggregate into ``window_s / buckets`` coarse time
    buckets, so observation is an increment on the tail bucket and
    eviction pops fully-expired buckets from the head.  The window is
    honored to within one bucket (default window/60) — burn-rate
    alerting needs nothing finer, and the alternative (a raw event
    deque) puts a full-window walk under the SLO lock on every
    ``/healthz`` scrape, stalling the dispatch threads whose p99 the SLO
    is measuring."""

    __slots__ = ("window_s", "res", "_q", "bad", "total")

    def __init__(self, window_s: float, buckets: int = 60):
        self.window_s = float(window_s)
        self.res = self.window_s / max(int(buckets), 1)
        self._q: deque = deque()  # [bucket_index, bad, total]
        self.bad = 0
        self.total = 0

    def add(self, now: float, good: bool) -> None:
        b = int(now // self.res)
        if self._q and self._q[-1][0] == b:
            e = self._q[-1]
        else:
            e = [b, 0, 0]
            self._q.append(e)
        if not good:
            e[1] += 1
            self.bad += 1
        e[2] += 1
        self.total += 1
        self.evict(now)

    def evict(self, now: float) -> None:
        # a bucket leaves only once ALL its events are older than the
        # cutoff (conservative: the window runs at most one bucket long)
        cutoff = now - self.window_s
        q = self._q
        while q and (q[0][0] + 1) * self.res <= cutoff:
            _, bad, total = q.popleft()
            self.bad -= bad
            self.total -= total

    def counts(self, now: float) -> Tuple[int, int]:
        self.evict(now)
        return self.bad, self.total


class BurnRateLatch:
    """One (window, threshold) burn-rate alarm with the latch/re-arm shape
    of :class:`QueueSaturationDetector`: fires ONCE when the burn rate
    reaches ``threshold``, stays quiet while it remains there (no
    alert-per-evaluation spam), re-arms when the rate drops below."""

    def __init__(self, label: str, window_s: float, threshold: float,
                 severity: str):
        if threshold <= 0:
            raise ValueError(f"burn threshold must be > 0, got {threshold}")
        self.label = label
        self.window_s = float(window_s)
        self.threshold = float(threshold)
        self.severity = severity
        self._latched = False

    def observe(self, burn_rate: float) -> bool:
        """True exactly when this evaluation should alert."""
        if burn_rate < self.threshold:
            self._latched = False
            return False
        if self._latched:
            return False
        self._latched = True
        return True


@lockcheck.guarded
class SLOTracker:
    """Per-priority-class latency/availability objectives over sliding
    windows — the fleet router feeds it one (priority, latency, ok) per
    routed request.

    A request is GOOD when it succeeded (no 5xx) AND finished inside its
    class's latency objective.  The availability objective says what
    fraction must be good; the error budget over ``budget_window_s`` is
    the allowed bad fraction, and a *burn rate* is (observed bad fraction)
    / (allowed bad fraction) over a window — burn 1.0 spends the budget
    exactly at its window's length, burn 14 torches it 14× faster.  Two
    windows (the multi-window pattern from the SRE literature) catch both
    a fast outage and a slow leak; each is a :class:`BurnRateLatch`.

    Everything is published three ways: ``ddlpc_slo_*`` registry series,
    one flat ``kind="slo"`` record per :meth:`status` call (the router's
    emit cadence), and alerts through a :class:`HealthMonitor`.
    Thread-safe; observation AND evaluation are O(1) — windows are
    time-bucketed (:class:`_WindowCounter`, resolution window/60), so a
    ``/healthz`` scrape never walks an event log under the lock the
    dispatch threads need.
    """

    def __init__(
        self,
        latency_objectives_s: Dict[str, float],
        availability: float = 0.999,
        budget_window_s: float = 3600.0,
        windows: Optional[List[Tuple[str, float, float, str]]] = None,
        min_requests: int = 10,
        registry=None,
        monitor: Optional[HealthMonitor] = None,
        clock=time.monotonic,
        enabled: bool = True,
    ):
        if not 0.0 < availability < 1.0:
            # availability 1.0 would make every burn rate infinite; an SLO
            # of "never fail" is not an SLO, it is a wish.
            if enabled:
                raise ValueError(
                    f"availability objective must be in (0, 1), got "
                    f"{availability}"
                )
        self.enabled = bool(enabled) and bool(latency_objectives_s)
        self.objectives = {
            str(k): float(v) for k, v in latency_objectives_s.items()
        }
        self.availability = float(availability)
        self.budget_window_s = float(budget_window_s)
        self.windows = list(
            windows
            if windows is not None
            else [
                ("fast", 300.0, 14.0, "critical"),
                ("slow", 3600.0, 2.0, "warn"),
            ]
        )
        self.min_requests = int(min_requests)
        self._clock = clock
        self._monitor = monitor
        self._lock = lockcheck.lock("SLOTracker._lock")
        self._t0 = clock()
        # per priority class, one bucketed counter per distinct window
        # (latch windows + the budget window, deduped by length)
        window_lengths = sorted(
            {self.budget_window_s} | {w[1] for w in self.windows}
        )
        self._wins: dict = {
            p: {w: _WindowCounter(w) for w in window_lengths}
            for p in self.objectives
        }  # guarded-by: _lock
        self._latches: dict = {
            p: [BurnRateLatch(lbl, w, thr, sev)
                for lbl, w, thr, sev in self.windows]
            for p in self.objectives
        }  # guarded-by: _lock
        self._reg = None
        if registry is not None and self.enabled:
            self._reg = {
                "requests": registry.counter(
                    "ddlpc_slo_requests_total",
                    "Routed requests classified against the SLO, by "
                    "priority class and good/bad.",
                    labelnames=("priority", "good"),
                ),
                "budget": registry.gauge(
                    "ddlpc_slo_error_budget_remaining",
                    "Fraction of the error budget left over the budget "
                    "window, by priority class (1 = untouched, 0 = spent, "
                    "negative = overspent).",
                    labelnames=("priority",),
                ),
                "burn": registry.gauge(
                    "ddlpc_slo_burn_rate",
                    "Error-budget burn rate by priority class and "
                    "alerting window (1.0 = spending exactly at budget).",
                    labelnames=("priority", "window"),
                ),
            }

    @classmethod
    def from_fleet_config(cls, cfg, registry=None,
                          monitor: Optional[HealthMonitor] = None,
                          clock=time.monotonic) -> "SLOTracker":
        """The fleet wiring: objectives + windows from ``FleetConfig``
        ``slo_*`` knobs (config.py documents each)."""
        return cls(
            latency_objectives_s={
                "interactive": cfg.slo_interactive_p99_ms / 1000.0,
                "batch": cfg.slo_batch_p99_ms / 1000.0,
            },
            availability=cfg.slo_availability,
            budget_window_s=cfg.slo_budget_window_s,
            windows=[
                ("fast", cfg.slo_fast_window_s, cfg.slo_fast_burn,
                 "critical"),
                ("slow", cfg.slo_slow_window_s, cfg.slo_slow_burn, "warn"),
            ],
            registry=registry,
            monitor=monitor,
            clock=clock,
            enabled=cfg.slo_enabled,
        )

    # -- feeding -------------------------------------------------------------

    def observe(self, priority: str, latency_s: float, ok: bool,
                now: Optional[float] = None) -> None:
        """Classify one routed request.  Unknown priorities count against
        the interactive objective (the router's own fallback rule)."""
        if not self.enabled:
            return
        p = priority if priority in self.objectives else "interactive"
        if p not in self.objectives:
            return
        now = self._clock() if now is None else now
        good = bool(ok) and float(latency_s) <= self.objectives[p]
        with self._lock:
            for wc in self._wins[p].values():
                wc.add(now, good)
        if self._reg is not None:
            self._reg["requests"].inc(
                priority=p, good="true" if good else "false"
            )

    # -- evaluation ----------------------------------------------------------

    def _window_counts(self, p: str, window_s: float,
                       now: float) -> Tuple[int, int]:
        """(bad, total) within the trailing window — an O(1) bucket-sum
        readout (at sustained load the budget window holds 100k+ events
        and an evaluation must never walk them under the lock dispatch
        threads need for observe())."""
        with self._lock:
            wc = self._wins.get(p, {}).get(window_s)
            if wc is None:
                return 0, 0
            return wc.counts(now)

    def _burn(self, bad: int, total: int) -> float:
        if total == 0:
            return 0.0  # an idle fleet burns nothing
        return (bad / total) / (1.0 - self.availability)

    def burn_rate(self, priority: str, window_s: float,
                  now: Optional[float] = None) -> float:
        """(bad fraction over window) / (allowed bad fraction)."""
        now = self._clock() if now is None else now
        return self._burn(*self._window_counts(priority, window_s, now))

    @staticmethod
    def _budget_remaining_from(bad: int, total: int,
                               availability: float) -> float:
        if total == 0:
            return 1.0
        allowed = total * (1.0 - availability)
        return 1.0 - bad / allowed if allowed > 0 else 0.0

    def error_budget_remaining(self, priority: str,
                               now: Optional[float] = None) -> float:
        now = self._clock() if now is None else now
        bad, total = self._window_counts(
            priority, self.budget_window_s, now
        )
        return self._budget_remaining_from(bad, total, self.availability)

    def check(self, now: Optional[float] = None) -> List[Alert]:
        """Evaluate every (class, window) burn latch; emit fired alerts
        through the health monitor (latched — one alert per excursion,
        re-armed on recovery).  Publishes the gauges as a side effect."""
        if not self.enabled:
            return []
        now = self._clock() if now is None else now
        out: List[Alert] = []
        for p in self.objectives:
            budget = self.error_budget_remaining(p, now)
            if self._reg is not None:
                self._reg["budget"].set(budget, priority=p)
            with self._lock:
                latches = list(self._latches[p])
            for latch in latches:
                bad, total = self._window_counts(p, latch.window_s, now)
                burn = self._burn(bad, total)
                if self._reg is not None:
                    self._reg["burn"].set(
                        burn, priority=p, window=latch.label
                    )
                if total < self.min_requests:
                    continue  # too little traffic to call an outage
                if latch.observe(burn):
                    out.append(
                        Alert(
                            alert=f"slo_burn_{latch.label}",
                            severity=latch.severity,
                            message=(
                                f"{p} error-budget burn rate {burn:.1f}x "
                                f"over the last {latch.window_s:.0f}s "
                                f"(threshold {latch.threshold:.1f}x, "
                                f"availability objective "
                                f"{self.availability:.4f})"
                            ),
                            value=burn,
                            threshold=latch.threshold,
                            context={
                                "priority": p,
                                "window_s": latch.window_s,
                                "error_budget_remaining": round(budget, 4),
                            },
                        )
                    )
        if self._monitor is not None:
            for a in out:
                self._monitor.emit(a)
        return out

    def status(self, now: Optional[float] = None) -> Dict[str, object]:
        """One flat ``kind="slo"`` record: the error-budget ledger per
        priority class, ready for the router's JSONL stream and the fleet
        ``/healthz``."""
        now = self._clock() if now is None else now
        rec: Dict[str, object] = {
            "kind": "slo",
            "availability_objective": self.availability,
            "budget_window_s": self.budget_window_s,
        }
        for p, obj_s in sorted(self.objectives.items()):
            bad, total = self._window_counts(p, self.budget_window_s, now)
            rec[f"{p}_latency_objective_ms"] = round(obj_s * 1000.0, 3)
            rec[f"{p}_requests"] = total
            rec[f"{p}_bad"] = bad
            rec[f"{p}_error_budget_remaining"] = round(
                self._budget_remaining_from(bad, total, self.availability), 4
            )
            for latch in self._latches[p]:
                rec[f"{p}_burn_{latch.label}"] = round(
                    self.burn_rate(p, latch.window_s, now), 4
                )
        return rec
