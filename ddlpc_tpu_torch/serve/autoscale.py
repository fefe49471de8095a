"""SLO-driven autoscaler: the reaction layer over the replica fleet.

The SLO layer tells the fleet when it is burning error budget; this
module acts on the signal instead of leaving the replica count fixed at
`ReplicaSupervisor` launch.  It closes the loop: a policy
thread reads the router's live view of the fleet (SLO burn rate,
per-priority queue depths, continuous-batcher slot busy fractions,
breaker states) and drives the supervisor's runtime
``scale_up`` / ``scale_down``.

Policy shape — deliberately boring hysteresis, not a controller:

- **Scale up** when ANY pressure signal crosses its high-water mark:
  interactive fast-window burn rate ≥ ``autoscale_burn_threshold``,
  mean interactive queue depth across ready replicas ≥
  ``autoscale_queue_depth_high``, or max replica slot-busy fraction ≥
  ``autoscale_slot_busy_high``.  One replica per decision; scale-up
  races warmup (the supervisor's readiness stays port-file + /healthz,
  so the new replica takes no traffic until it has compiled).
- **Scale down** only when EVERY signal is below its low-water mark
  (burn under 1.0 — spending inside budget — plus the ``*_low``
  thresholds).  The victim prefers a breaker-open replica (it is
  already taking no traffic), then an unhealthy one, then the
  highest-index ready replica (LIFO keeps the original fleet shape).
- **Never flaps**: ``autoscale_cooldown_s`` must elapse between
  actions, and ``autoscale_min_replicas`` / ``autoscale_max_replicas``
  bound the fleet absolutely.

Every decision AND every suppressed decision is a flat
``kind="autoscale"`` JSONL record carrying the triggering signal
values, so a scaling timeline is reconstructible from the stream alone.
Quiet holds (no pressure either way) emit nothing.

The module is torch-free (stdlib only) and fully injectable: the router and supervisor are duck-typed and the
clock is a parameter, so the policy is unit-testable with fakes and no
sleeping.

The port's own copy of ``ddlpc_tpu/serve/autoscale.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ddlpc_tpu_torch.config import FleetConfig

_INTERACTIVE = "interactive"


class AutoscaleMetrics:
    """Registry wiring for the autoscaler (optional, like RouterMetrics)."""

    def __init__(self, registry=None):
        self._reg = {}
        if registry is not None:
            self._reg = {
                "decisions": registry.counter(
                    "ddlpc_autoscale_decisions_total",
                    "autoscaler decisions by action (including suppressions)",
                    labelnames=("action",),
                ),
                "target": registry.gauge(
                    "ddlpc_autoscale_replicas_target",
                    "replica count the autoscaler is currently steering to",
                ),
            }

    def record(self, action: str, target: int) -> None:
        if self._reg:
            self._reg["decisions"].inc(action=action)
            self._reg["target"].set(float(target))


class Autoscaler:
    """Threshold policy loop over a router (signals) + supervisor (actuation).

    ``router`` needs ``.slo.burn_rate(priority, window_s)`` and
    ``.replica_status()``; ``supervisor`` needs ``.replica_count()``,
    ``.scale_up() -> name`` and ``.scale_down(name) -> bool``.  Tests
    inject fakes for all three plus ``clock``.
    """

    def __init__(
        self,
        cfg: FleetConfig,
        router,
        supervisor,
        logger=None,
        registry=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.cfg = cfg
        self.router = router
        self.supervisor = supervisor
        self.logger = logger
        self.metrics = AutoscaleMetrics(registry)
        self._clock = clock
        self._last_action_at: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- signal gathering ---------------------------------------------------

    def _signals(self) -> Dict[str, float]:
        cfg = self.cfg
        try:
            burn = float(
                self.router.slo.burn_rate(_INTERACTIVE, cfg.slo_fast_window_s)
            )
        except Exception:
            burn = 0.0  # no SLO tracker (slo_enabled=False) → never a trigger
        statuses = self.router.replica_status()
        ready = [s for s in statuses if s.get("ready") and s.get("healthy")]
        queues = [float(s.get("queue_depth_interactive") or 0) for s in ready]
        busy = [
            float(s["slot_busy"]) for s in ready
            if s.get("slot_busy") is not None
        ]
        return {
            "burn_rate": burn,
            "queue_depth": (sum(queues) / len(queues)) if queues else 0.0,
            "slot_busy": max(busy) if busy else 0.0,
            "ready_replicas": float(len(ready)),
        }

    def _pick_victim(self) -> Optional[str]:
        """Scale-down victim: breaker-open first, then unhealthy, then the
        highest-named ready replica.  Draining replicas are already on
        their way out — never double-select one."""
        statuses: List[Dict[str, object]] = self.router.replica_status()
        candidates = [s for s in statuses if not s.get("draining")]
        if not candidates:
            return None

        def rank(s: Dict[str, object]):
            breaker_open = 0 if s.get("breaker") == "open" else 1
            unhealthy = 0 if not s.get("healthy") else 1
            return (breaker_open, unhealthy, _neg_name_key(str(s["name"])))

        return str(sorted(candidates, key=rank)[0]["name"])

    # -- the policy ---------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> Optional[str]:
        """One policy pass; returns the action taken/suppressed, or None
        on a quiet hold."""
        cfg = self.cfg
        now = self._clock() if now is None else now
        sig = self._signals()
        count = int(self.supervisor.replica_count())

        up_reasons = []
        if sig["burn_rate"] >= cfg.autoscale_burn_threshold:
            up_reasons.append("burn_rate")
        if sig["queue_depth"] >= cfg.autoscale_queue_depth_high:
            up_reasons.append("queue_depth")
        if sig["slot_busy"] >= cfg.autoscale_slot_busy_high:
            up_reasons.append("slot_busy")

        # A collapsed fleet reads exactly like an idle one — zero ready
        # replicas means zero queue depth and zero slot busy — so scale-
        # down additionally requires at least one ready replica to be
        # REPORTING those low signals, or the policy would retire
        # capacity in the middle of an outage.
        down_ok = (
            sig["ready_replicas"] > 0
            and sig["burn_rate"] < 1.0
            and sig["queue_depth"] <= cfg.autoscale_queue_depth_low
            and sig["slot_busy"] <= cfg.autoscale_slot_busy_low
        )

        cooling = (
            self._last_action_at is not None
            and (now - self._last_action_at) < cfg.autoscale_cooldown_s
        )

        if count < cfg.autoscale_min_replicas:
            # below the floor (e.g. a replica gave up): restore it even
            # during cooldown — the bound outranks flap damping.
            name = self.supervisor.scale_up()
            self._last_action_at = now
            return self._record(
                "scale_up", sig, count, count + 1, reason="below_min",
                replica=name,
            )

        if up_reasons:
            reason = ",".join(up_reasons)
            if count >= cfg.autoscale_max_replicas:
                return self._record(
                    "suppressed_max", sig, count, count, reason=reason
                )
            if cooling:
                return self._record(
                    "suppressed_cooldown", sig, count, count, reason=reason
                )
            name = self.supervisor.scale_up()
            self._last_action_at = now
            return self._record(
                "scale_up", sig, count, count + 1, reason=reason,
                replica=name,
            )

        if down_ok and count > cfg.autoscale_min_replicas:
            if cooling:
                return self._record(
                    "suppressed_cooldown", sig, count, count, reason="idle"
                )
            victim = self._pick_victim()
            if victim is None:
                return None
            if not self.supervisor.scale_down(victim):
                return None
            self._last_action_at = now
            return self._record(
                "scale_down", sig, count, count - 1, reason="idle",
                replica=victim,
            )

        if down_ok and count == cfg.autoscale_min_replicas and count > 0:
            # idle but pinned at the floor: stay quiet (this is the
            # steady state, not a decision worth a record).
            return None
        return None

    def _record(
        self,
        action: str,
        sig: Dict[str, float],
        replicas: int,
        target: int,
        reason: str,
        replica: Optional[str] = None,
    ) -> str:
        self.metrics.record(action, target)
        if self.logger is not None:
            rec: Dict[str, object] = {
                "kind": "autoscale",
                "action": action,
                "reason": reason,
                "replicas": replicas,
                "replicas_target": target,
            }
            rec.update(sig)
            if replica is not None:
                rec["replica"] = replica
            self.logger.log(rec)
        return action

    # -- background loop ----------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="autoscaler", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.cfg.autoscale_interval_s):
            try:
                self.evaluate()
            except Exception:
                # policy errors must never take down the fleet process;
                # the next tick retries with fresh signals.
                pass

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def _neg_name_key(name: str):
    """Sort key that puts the HIGHEST replica index first (LIFO victim
    order) while staying total for arbitrary names."""
    digits = "".join(c for c in name if c.isdigit())
    idx = int(digits) if digits else -1
    return (-idx, name)
