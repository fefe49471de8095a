"""Replica supervision + zero-downtime rolling reload: the fleet's
process tier.

``ReplicaSupervisor`` launches and babysits N serving replicas, each a
``python -m ddlpc_tpu_torch.serve.server`` subprocess on an ephemeral port
(learned through a ``--port-file``), and keeps the routing tier
(serve/router.py) in sync with reality:

- **launch → warmup → register**: a replica only enters dispatch after
  its port file lands (written post-``engine.warmup()``) and ``/healthz``
  answers ``ok`` — first traffic never pays a compile;
- **exit classification + restart** via the SAME machinery as the
  training supervisor (resilience/supervisor.py): ``classify_exit`` on
  the exit status, :class:`RestartPolicy` for full-jitter backoff,
  crash-loop give-up, and the restart budget.  "Progress" for a serving
  replica means it became ready since launch — a replica that dies warm
  relaunches immediately, one that crash-loops at import backs off and
  eventually gives up LOUDLY while the rest of the fleet keeps serving;
- **graceful replacement**: ``stop()`` SIGTERMs every replica, which runs
  server.py's drain path (finish in-flight, flush metrics, exit 0);
- **rolling hot-reload**: push a new checkpoint replica-by-replica —
  router drain → ``POST /reload`` → warmup confirm → readmit — so a
  training run updates a live fleet with zero dropped requests.  If any
  replica's reload errors or quarantines the blob, the WHOLE fleet is
  rolled back to the old step (explicit ``step=`` reloads) and the update
  reports aborted.

Like the router, this module is deliberately torch-free: only the replica
subprocesses pay the torch import and hold the card.  Every replica runs
on the fleet's ``--device`` (``cuda`` unless ``cpu`` is asked for); on
one card they time-share it, each with its own CUDA context.

CLI::

    python -m ddlpc_tpu_torch.serve.fleet --config configs/fleet_vaihingen.json
    python -m ddlpc_tpu_torch.serve.fleet --workdir runs/x --replicas 3 --port 8570
    python -m ddlpc_tpu_torch.serve.fleet --workdir runs/x --port 0 --device cpu

The port's own copy of ``ddlpc_tpu/serve/fleet.py``: the same front-end
protocol, supervision and rolling reload; ``--device`` is the port's
addition to the CLI, never a config key.  The banner printed once every
replica is ready names the bound port (``--port 0`` takes an ephemeral
one).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Callable, Dict, List, Optional
from urllib.parse import urlparse

from ddlpc_tpu_torch.config import FleetConfig
from ddlpc_tpu_torch.obs import lineage as obs_lineage
from ddlpc_tpu_torch.obs.aggregate import TelemetryAggregator
from ddlpc_tpu_torch.obs.http import PROMETHEUS_CTYPE, render_metrics, wants_prometheus
from ddlpc_tpu_torch.obs.registry import MetricsRegistry
from ddlpc_tpu_torch.obs.tracing import Tracer, parse_traceparent
from ddlpc_tpu_torch.resilience.supervisor import RestartPolicy, classify_exit
from ddlpc_tpu_torch.serve.router import FleetRouter, HTTPReplicaClient
from ddlpc_tpu_torch.serve.server import ServeHTTPServer


class _ManagedReplica:
    """One supervised replica: process handle + restart policy state."""

    def __init__(self, idx: int, home: str, cfg: FleetConfig):
        self.idx = idx
        self.name = f"r{idx}"
        self.home = home  # <fleet_dir>/r<idx>: config, port file, log, metrics
        self.cfg_path = os.path.join(home, "serve.json")
        self.port_file = os.path.join(home, "port")
        self.log_path = os.path.join(home, "replica.log")
        self.policy = RestartPolicy(
            max_restarts=cfg.max_restarts,
            crash_loop_limit=cfg.crash_loop_limit,
            backoff_base_s=cfg.backoff_base_s,
            backoff_cap_s=cfg.backoff_cap_s,
        )
        self.proc: Optional[subprocess.Popen] = None
        self.port: Optional[int] = None
        self.client: Optional[HTTPReplicaClient] = None
        self.launches = 0
        self.became_ready = False  # since the most recent launch
        self.gave_up = False
        # Scale-down marker: a retired replica's supervision loop exits
        # instead of relaunching when its process dies — the orderly
        # counterpart of gave_up (serve/autoscale.py drives it).
        self.retired = False
        self.ready_evt = threading.Event()


class ReplicaSupervisor:
    """Launch, watch, classify, back off, relaunch — per serving replica.

    ``env_fn(replica_idx, launch_n) -> dict | None`` varies a replica's
    environment per launch (how a fault-injection run injects a different
    ``DDLPC_CHAOS`` schedule into each replica / each restart).
    ``device`` is every replica's ``--device``.
    """

    def __init__(
        self,
        cfg: FleetConfig,
        router: Optional[FleetRouter] = None,
        registry: Optional[MetricsRegistry] = None,
        logger=None,
        env_fn: Optional[Callable[[int, int], Optional[dict]]] = None,
        echo: bool = True,
        aggregator: Optional[TelemetryAggregator] = None,
        device: str = "cuda",
    ):
        self.cfg = cfg
        self.device = device
        self.fleet_dir = cfg.resolved_fleet_dir()
        if registry is None:
            registry = router.registry if router is not None else MetricsRegistry()
        self.registry = registry
        self.router = (
            router
            if router is not None
            else FleetRouter(cfg, registry=registry, logger=logger)
        )
        # Fleet telemetry aggregation (obs/aggregate.py): replicas opt in
        # as metrics sources exactly when they enter dispatch, and leave
        # when their process dies — the aggregator's staleness flag covers
        # the gap in between.
        self.aggregator = aggregator
        self.logger = logger
        self.env_fn = env_fn
        self.echo = echo
        self._restarts = registry.counter(
            "ddlpc_fleet_restarts_total",
            "Replica relaunches, by replica and classified exit cause.",
            labelnames=("replica", "cause"),
        )
        # Deploy latency: checkpoint durable on disk (lineage saved_at,
        # stamped at the durable-write moment) → 100% of the fleet
        # serving that step.  Set once per completed rolling reload;
        # stays at the last value between reloads.
        self._deploy_latency = registry.gauge(
            "ddlpc_deploy_latency_s",
            "Seconds from checkpoint durable-write to the whole fleet "
            "serving it, per completed rolling reload.",
        )
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._reload_lock = threading.Lock()
        # replicas/_threads grow at runtime (scale_up) — every iteration
        # works on a snapshot taken under this lock.
        self._replicas_lock = threading.Lock()
        self.replicas: List[_ManagedReplica] = []
        for i in range(cfg.replicas):
            home = os.path.join(self.fleet_dir, f"r{i}")
            self.replicas.append(_ManagedReplica(i, home, cfg))
        self._next_idx = cfg.replicas  # next scale-up replica index

    def _snapshot(self) -> List[_ManagedReplica]:
        with self._replicas_lock:
            return list(self.replicas)

    def _spawn_supervision(self, rp: _ManagedReplica) -> None:
        """Config on disk + one supervision thread — shared by boot-time
        start() and runtime scale_up()."""
        self._write_serve_config(rp)
        t = threading.Thread(
            target=self._run_replica, args=(rp,),
            name=f"fleet-{rp.name}", daemon=True,
        )
        with self._replicas_lock:
            self._threads.append(t)
        t.start()

    # -- plumbing -----------------------------------------------------------

    def _say(self, msg: str) -> None:
        if self.echo:
            print(f"[fleet] {msg}", file=sys.stderr, flush=True)

    def _log(self, event: str, **fields) -> None:
        """Flat kind="fleet" records on the router.jsonl stream."""
        if self.logger is None:
            return
        try:
            self.logger.log(
                {"kind": "fleet", "event": event, **fields}, echo=False
            )
        except Exception:
            pass

    # -- launch / readiness -------------------------------------------------

    def _write_serve_config(self, rp: _ManagedReplica) -> None:
        os.makedirs(rp.home, exist_ok=True)
        serve_cfg = self.cfg.replica_serve_config(metrics_dir=rp.home)
        with open(rp.cfg_path, "w") as f:
            f.write(serve_cfg.to_json())

    def _launch(self, rp: _ManagedReplica) -> None:
        rp.launches += 1
        rp.became_ready = False
        rp.port = None
        try:
            os.unlink(rp.port_file)
        except OSError:
            pass
        env = None
        if self.env_fn is not None:
            env = self.env_fn(rp.idx, rp.launches)
        if env is None:
            env = dict(os.environ)
        # The replica must import ddlpc_tpu_torch from the same tree as
        # the supervisor regardless of the caller's cwd.
        repo_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        cmd = [
            sys.executable,
            "-m",
            "ddlpc_tpu_torch.serve.server",
            "--config",
            rp.cfg_path,
            "--port-file",
            rp.port_file,
            "--device",
            self.device,
        ]
        log = open(rp.log_path, "ab")
        try:
            rp.proc = subprocess.Popen(
                cmd, env=env, stdout=log, stderr=subprocess.STDOUT
            )
        finally:
            log.close()
        self._say(f"{rp.name}: launched pid {rp.proc.pid} (launch {rp.launches})")
        self._log(
            "replica_launch", replica=rp.name, pid=rp.proc.pid,
            launch=rp.launches,
        )

    def _wait_ready(self, rp: _ManagedReplica) -> Optional[dict]:
        """Port file lands (post-warmup) and /healthz answers ok: that
        answer, or None if the replica died or the warmup window ran out."""
        deadline = time.monotonic() + self.cfg.warmup_timeout_s
        while time.monotonic() < deadline and not self._stop.is_set():
            if rp.proc is None or rp.proc.poll() is not None:
                return None  # died during startup
            if rp.port is None and os.path.exists(rp.port_file):
                try:
                    with open(rp.port_file) as f:
                        rp.port = int(f.read().strip())
                    rp.client = HTTPReplicaClient(
                        rp.name, self.cfg.host, rp.port
                    )
                except (OSError, ValueError):
                    rp.port = None
            if rp.client is not None and rp.port is not None:
                try:
                    h = rp.client.healthz(self.cfg.scrape_timeout_s)
                    if h.get("status") == "ok":
                        return h
                except Exception:
                    pass
            time.sleep(0.2)
        return None

    # -- the per-replica supervision loop ------------------------------------

    def _run_replica(self, rp: _ManagedReplica) -> None:
        while not self._stop.is_set() and not rp.retired:
            self._launch(rp)
            health = self._wait_ready(rp)
            if health is not None and not self._stop.is_set():
                rp.became_ready = True
                # The answer that made it ready is its first scrape: the
                # fleet's /healthz names its step from now on.
                self.router.add_replica(rp.name, rp.client, health=health)
                if self.aggregator is not None:
                    client = rp.client
                    timeout_s = self.cfg.scrape_timeout_s
                    self.aggregator.add_source(
                        rp.name,
                        lambda c=client, t=timeout_s: c.metrics_text(t),
                    )
                self._say(f"{rp.name}: ready on port {rp.port}")
                self._log(
                    "replica_ready", replica=rp.name, port=rp.port,
                    launch=rp.launches,
                )
                rp.ready_evt.set()
            elif rp.proc is not None and rp.proc.poll() is None:
                # Alive but never became ready inside the warmup window:
                # a wedged start is a failed launch, not a serving replica.
                self._say(f"{rp.name}: warmup timeout — killing")
                try:
                    rp.proc.kill()
                except OSError:
                    pass
            rc = rp.proc.wait() if rp.proc is not None else -1
            self.router.remove_replica(rp.name)
            if self.aggregator is not None:
                self.aggregator.remove_source(rp.name)
            rp.ready_evt.clear()
            cause = classify_exit(rc)
            self._say(f"{rp.name}: exit {rc} ({cause})")
            self._log(
                "replica_exit", replica=rp.name, rc=rc, cause=cause,
                was_ready=rp.became_ready,
            )
            if self._stop.is_set():
                return
            if rp.retired:
                # Scale-down completing: the exit was ordered, not a
                # failure — no restart accounting, no relaunch.
                self._say(f"{rp.name}: retired (scale-down)")
                self._log("replica_retired", replica=rp.name)
                return
            self._restarts.inc(replica=rp.name, cause=cause)
            decision = rp.policy.record_exit(progressed=rp.became_ready)
            if decision != "restart":
                rp.gave_up = True
                msg = (
                    f"{rp.name}: giving up after {rp.policy.attempts} exits "
                    f"({decision}); the rest of the fleet keeps serving"
                )
                self._say(msg)
                self._log(
                    "replica_give_up", severity="critical", replica=rp.name,
                    attempts=rp.policy.attempts, reason=decision,
                )
                return
            delay = rp.policy.delay_s()
            if delay > 0:
                self._say(f"{rp.name}: backing off {delay:.2f}s before relaunch")
                self._stop.wait(delay)

    # -- lifecycle -----------------------------------------------------------

    def start(self, wait_ready: bool = True) -> int:
        """Launch every replica (each on its own supervision thread).
        With ``wait_ready`` blocks until each is ready or its warmup
        window expired; returns how many are ready."""
        os.makedirs(self.fleet_dir, exist_ok=True)
        initial = self._snapshot()
        for rp in initial:
            self._spawn_supervision(rp)
        self.router.start()
        if not wait_ready:
            return 0
        n = 0
        for rp in initial:
            if rp.ready_evt.wait(self.cfg.warmup_timeout_s):
                n += 1
        return n

    def ready_count(self) -> int:
        return sum(1 for rp in self._snapshot() if rp.ready_evt.is_set())

    # -- runtime elasticity (serve/autoscale.py drives these) ----------------

    def replica_count(self) -> int:
        """Replicas the fleet is steering toward: live or relaunching,
        excluding retired and given-up ones."""
        return sum(
            1 for rp in self._snapshot() if not rp.retired and not rp.gave_up
        )

    def scale_up(self) -> str:
        """Add one replica at runtime; returns its name immediately.
        Scale-up races warmup by design: the new replica enters dispatch
        through the SAME port-file + /healthz readiness gate as a boot
        launch, so first traffic never pays its compile."""
        with self._replicas_lock:
            idx = self._next_idx
            self._next_idx += 1
            home = os.path.join(self.fleet_dir, f"r{idx}")
            rp = _ManagedReplica(idx, home, self.cfg)
            self.replicas.append(rp)
        os.makedirs(self.fleet_dir, exist_ok=True)
        self._spawn_supervision(rp)
        self._log("scale_up_launch", replica=rp.name)
        return rp.name

    def scale_down(self, name: str) -> bool:
        """Retire one replica at runtime: drain its in-flight work, then
        SIGTERM (the replica's own drain path finishes the rest).  The
        supervision loop sees ``retired`` and exits instead of
        relaunching.  Returns False if ``name`` isn't a live candidate."""
        with self._replicas_lock:
            rp = next(
                (
                    r for r in self.replicas
                    if r.name == name and not r.retired and not r.gave_up
                ),
                None,
            )
        if rp is None:
            return False
        rp.retired = True
        self.router.drain(name, self.cfg.drain_timeout_s)
        if rp.proc is not None and rp.proc.poll() is None:
            try:
                rp.proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
        self._log("scale_down_retire", replica=name)
        return True

    def stop(self, grace_s: float = 30.0) -> None:
        """Graceful fleet shutdown: SIGTERM every replica (each drains —
        finish in-flight, flush metrics, exit 0), SIGKILL stragglers."""
        self._stop.set()
        live = self._snapshot()
        for rp in live:
            if rp.proc is not None and rp.proc.poll() is None:
                try:
                    rp.proc.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        deadline = time.monotonic() + grace_s
        for rp in live:
            if rp.proc is None:
                continue
            remaining = max(deadline - time.monotonic(), 0.1)
            try:
                rp.proc.wait(timeout=remaining)
            except subprocess.TimeoutExpired:
                self._say(f"{rp.name}: did not drain in {grace_s}s — SIGKILL")
                try:
                    rp.proc.kill()
                    rp.proc.wait(timeout=10)
                except (OSError, subprocess.TimeoutExpired):
                    pass
        with self._replicas_lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=10)
        self.router.close()

    # -- rolling hot-reload ---------------------------------------------------

    def rolling_reload(
        self, step: Optional[int] = None, workdir: Optional[str] = None
    ) -> dict:
        """Push a checkpoint into the live fleet replica-by-replica:
        drain → /reload → warmup confirm → readmit.  Zero dropped
        requests: a draining replica finishes its in-flight work while
        the others keep serving.

        Fleet-wide fallback: if ANY replica's reload errors or
        quarantines the blob (the reader fell back past a corrupt
        checkpoint — train/checkpoint.py), every already-updated replica
        is reloaded back to the old step and the update reports
        ``{"ok": False, ...}`` — a fleet never serves mixed weights
        because one copy of the new blob was bad."""
        with self._reload_lock:
            return self._rolling_reload_locked(step, workdir)

    def _reload_payload(self, step, workdir) -> dict:
        payload: Dict[str, object] = {}
        if step is not None:
            payload["step"] = int(step)
        if workdir is not None:
            payload["workdir"] = workdir
        return payload

    def _reload_to(self, rp: _ManagedReplica, step: Optional[int]) -> bool:
        """Best-effort direct reload (rollback path): the engine's hot
        swap is atomic, so no drain is needed to go BACK to weights every
        in-flight request may already be using."""
        if rp.client is None:
            return False
        try:
            status, meta = rp.client.reload(
                self._reload_payload(step, None), self.cfg.scrape_timeout_s + 30
            )
            return status == 200 and "error" not in meta
        except Exception as e:
            self._log(
                "rollback_failed", replica=rp.name, severity="critical",
                error=f"{type(e).__name__}: {e}",
            )
            return False

    def _rolling_reload_locked(self, step, workdir) -> dict:
        live = [
            rp
            for rp in self._snapshot()
            if rp.ready_evt.is_set() and rp.client is not None
            and not rp.retired
        ]
        if not live:
            return {"ok": False, "error": "no ready replicas"}
        # The fleet-wide fallback target: what the fleet serves NOW.
        old_steps = []
        for rp in live:
            try:
                h = rp.client.healthz(self.cfg.scrape_timeout_s)
                if h.get("checkpoint_step") is not None:
                    old_steps.append(int(h["checkpoint_step"]))
            except Exception:
                pass
        old_step = max(old_steps) if old_steps else None
        self._log(
            "rolling_reload_start", step=step, old_step=old_step,
            replicas=len(live),
        )
        updated: List[_ManagedReplica] = []
        details = []
        new_step = None
        new_lineage: dict = {}
        for rp in live:
            self.router.drain(rp.name, self.cfg.drain_timeout_s)
            try:
                status, meta = rp.client.reload(
                    self._reload_payload(step, workdir),
                    self.cfg.scrape_timeout_s + 60,
                )
            except Exception as e:
                status, meta = 0, {"error": f"{type(e).__name__}: {e}"}
            quarantined = meta.get("quarantined_steps")
            ok = status == 200 and "error" not in meta and not quarantined
            details.append(
                {
                    "replica": rp.name,
                    "status": status,
                    "step": meta.get("step"),
                    "quarantined_steps": quarantined,
                    "error": meta.get("error"),
                }
            )
            if not ok:
                reason = (
                    f"quarantined {quarantined}"
                    if quarantined
                    else str(meta.get("error") or f"http {status}")
                )
                self._say(
                    f"rolling reload ABORTED on {rp.name}: {reason}; "
                    f"rolling fleet back to step {old_step}"
                )
                # Fleet-wide fallback.  The failing replica may already be
                # serving fallback weights (the reader's quarantine path) —
                # an explicit step= reload pins it to the same old step as
                # everyone else.
                rollback_ok = [self._reload_to(rp, old_step)]
                self.router.readmit(rp.name)
                for u in updated:
                    rollback_ok.append(self._reload_to(u, old_step))
                # Replicas that already served the new step are back on
                # the old one: anything cached against EITHER step is
                # suspect until the fleet re-converges — flush.
                self.router.invalidate_cache("reload_rollback")
                self.router.metrics.record_reload(ok=False)
                self._log(
                    "rolling_reload_aborted", replica=rp.name, reason=reason,
                    rolled_back_to=old_step,
                    rollback_clean=all(rollback_ok),
                )
                return {
                    "ok": False,
                    "aborted_on": rp.name,
                    "reason": reason,
                    "rolled_back_to": old_step,
                    "rollback_clean": all(rollback_ok),
                    "replicas": details,
                }
            new_step = meta.get("step")
            if isinstance(meta.get("lineage"), dict):
                new_lineage = meta["lineage"]
            # Warmup confirm: the replica answers /healthz with the new
            # step before it re-enters dispatch.
            confirm_deadline = time.monotonic() + self.cfg.scrape_timeout_s + 10
            while time.monotonic() < confirm_deadline:
                try:
                    h = rp.client.healthz(self.cfg.scrape_timeout_s)
                    if (
                        h.get("status") == "ok"
                        and h.get("checkpoint_step") == new_step
                    ):
                        break
                except Exception:
                    pass
                time.sleep(0.1)
            self.router.readmit(rp.name)
            updated.append(rp)
        # The serving step moved: every cached response answered for the
        # old weights.  (The router's consensus watcher would also catch
        # this on the next scrape; the explicit call makes the flush
        # synchronous with the reload result.)
        if new_step != old_step:
            self.router.invalidate_cache("rolling_reload")
        self.router.metrics.record_reload(ok=True)
        # Deploy latency: the last replica just confirmed the new step,
        # so the WHOLE fleet serves it now; anchor on the checkpoint's
        # durable-write stamp.  Pre-lineage checkpoints (v1/v2) have no
        # stamp — report the explicit unknown marker, never a fake zero.
        lineage_id = new_lineage.get("lineage_id")
        saved_at = new_lineage.get("saved_at")
        deploy_latency_s = None
        if isinstance(saved_at, (int, float)) and not isinstance(
            saved_at, bool
        ):
            deploy_latency_s = max(0.0, time.time() - float(saved_at))
            self._deploy_latency.set(deploy_latency_s)
        self._log(
            "rolling_reload_done", step=new_step, old_step=old_step,
            replicas=len(updated),
            lineage_id=lineage_id or obs_lineage.LINEAGE_UNKNOWN,
            deploy_latency_s=deploy_latency_s,
        )
        if self.logger is not None:
            # The fleet-side lineage event: joined with the trainer's
            # checkpoint_saved record (same lineage_id) by obs/merge.py
            # to place train→serve hand-off on one timeline.
            try:
                self.logger.log(
                    {
                        "kind": "lineage",
                        "event": "fleet_serving",
                        **obs_lineage.flatten(
                            new_lineage or obs_lineage.unknown_lineage(
                                new_step
                            )
                        ),
                        "deploy_latency_s": deploy_latency_s,
                        "replicas": len(updated),
                    },
                    echo=False,
                )
            except Exception:
                pass
        return {
            "ok": True,
            "step": new_step,
            "old_step": old_step,
            "lineage_id": lineage_id,
            "deploy_latency_s": deploy_latency_s,
            "replicas": details,
        }

    def status(self) -> dict:
        return {
            "replicas": [
                {
                    "name": rp.name,
                    "pid": rp.proc.pid if rp.proc is not None else None,
                    "port": rp.port,
                    "ready": rp.ready_evt.is_set(),
                    "launches": rp.launches,
                    "gave_up": rp.gave_up,
                    "retired": rp.retired,
                }
                for rp in self._snapshot()
            ],
        }


# ---------------------------------------------------------------------------
# fleet HTTP front end (what clients talk to)
# ---------------------------------------------------------------------------


class _FleetHandler(BaseHTTPRequestHandler):
    server_version = "ddlpc-fleet/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        pass

    @property
    def router(self) -> FleetRouter:
        return self.server.router  # type: ignore[attr-defined]

    @property
    def supervisor(self) -> Optional[ReplicaSupervisor]:
        return self.server.supervisor  # type: ignore[attr-defined]

    @property
    def aggregator(self) -> Optional[TelemetryAggregator]:
        return getattr(self.server, "aggregator", None)

    def _send(
        self, status: int, ctype: str, body: bytes, extra=()
    ) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype or "application/octet-stream")
        self.send_header("Content-Length", str(len(body)))
        for name, value in extra:
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, status: int, obj: dict) -> None:
        self._send(status, "application/json", json.dumps(obj).encode())

    def do_GET(self) -> None:
        path = urlparse(self.path).path
        if path == "/healthz":
            h = self.router.healthz()
            self._send_json(200 if h["status"] == "ok" else 503, h)
        elif path == "/metrics":
            # One scrape answers for the whole fleet: the router's own
            # registry plus the aggregator's ddlpc_fleet_* rollups
            # (per-replica labels preserved) in one exposition.
            agg = self.aggregator
            accept = self.headers.get("Accept")
            if agg is not None and wants_prometheus(accept):
                body = (
                    self.router.registry.exposition() + agg.exposition()
                ).encode()
                self._send(200, PROMETHEUS_CTYPE, body)
                return
            ctype, body = render_metrics(
                self.router.registry,
                accept,
                json_fallback=lambda: self._json_metrics(agg),
            )
            self._send(200, ctype, body)
        elif path == "/fleet":
            out = self.router.healthz()
            if self.supervisor is not None:
                out["supervisor"] = self.supervisor.status()
            self._send_json(200, out)
        else:
            self._send_json(404, {"error": f"no route {path}"})

    def _json_metrics(self, agg: Optional[TelemetryAggregator]) -> dict:
        out = self.router.metrics.snapshot(advance=False)
        if agg is not None:
            out.update(agg.snapshot())
        return out

    def do_POST(self) -> None:
        parsed = urlparse(self.path)
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length) if length else b""
            if parsed.path == "/predict":
                # An external client's traceparent continues through the
                # fleet (its trace id spans client→router→replica);
                # otherwise a traced router mints a fresh one.
                info: dict = {}
                status, ctype, payload = self.router.dispatch(
                    body, parsed.query,
                    trace_context=parse_traceparent(
                        self.headers.get("traceparent")
                    ),
                    info=info,
                )
                # Every served prediction — cache hits included — names
                # the checkpoint step it came from.
                step = info.get("model_step")
                self._send(
                    status, ctype, payload,
                    extra=[(
                        obs_lineage.MODEL_STEP_HEADER,
                        str(step)
                        if step is not None
                        else obs_lineage.LINEAGE_UNKNOWN,
                    )],
                )
            elif parsed.path == "/reload":
                if self.supervisor is None:
                    self._send_json(
                        501, {"error": "no supervisor attached to this router"}
                    )
                    return
                try:
                    req = json.loads(body) if body else {}
                except ValueError as e:
                    self._send_json(
                        400, {"error": f"body is not valid JSON: {e}"}
                    )
                    return
                res = self.supervisor.rolling_reload(
                    step=req.get("step"), workdir=req.get("workdir")
                )
                self._send_json(200 if res.get("ok") else 409, res)
            else:
                self._send_json(404, {"error": f"no route {parsed.path}"})
        except BrokenPipeError:
            pass


def make_fleet_server(
    router: FleetRouter,
    supervisor: Optional[ReplicaSupervisor] = None,
    host: str = "127.0.0.1",
    port: int = 0,
    aggregator: Optional[TelemetryAggregator] = None,
) -> ServeHTTPServer:
    """Client-facing HTTP server over the router (+ optional supervisor
    for ``POST /reload`` rolling updates, + optional telemetry
    aggregator whose ddlpc_fleet_* rollups join ``GET /metrics``)."""
    server = ServeHTTPServer((host, port), _FleetHandler)
    server.router = router  # type: ignore[attr-defined]
    server.supervisor = supervisor  # type: ignore[attr-defined]
    server.aggregator = aggregator  # type: ignore[attr-defined]
    return server


def main(argv: Optional[List[str]] = None) -> int:
    from ddlpc_tpu_torch import device_arg

    p = argparse.ArgumentParser(prog="python -m ddlpc_tpu_torch.serve.fleet")
    p.add_argument("--config", help="FleetConfig JSON (configs/fleet_*.json)")
    p.add_argument("--workdir", help="training run to serve (overrides config)")
    p.add_argument("--replicas", type=int)
    p.add_argument("--host")
    p.add_argument("--port", type=int)
    p.add_argument("--device", type=device_arg, default="cuda",
                   help="every replica's device: cuda, cuda:N or cpu "
                   "(never a config key)")
    args = p.parse_args(argv)

    cfg = FleetConfig()
    if args.config:
        with open(args.config) as f:
            cfg = FleetConfig.from_json(f.read())
    overrides = {
        k: v
        for k, v in (
            ("workdir", args.workdir),
            ("replicas", args.replicas),
            ("host", args.host),
            ("port", args.port),
        )
        if v is not None
    }
    if overrides:
        cfg = cfg.replace(**overrides)

    from ddlpc_tpu_torch.train.observability import MetricsLogger

    fleet_dir = cfg.resolved_fleet_dir()
    os.makedirs(fleet_dir, exist_ok=True)
    logger = MetricsLogger(fleet_dir, basename="router")
    registry = MetricsRegistry()
    tracer = Tracer(
        enabled=cfg.trace,
        service="router",
        jsonl_path=os.path.join(fleet_dir, "router_spans.jsonl"),
        chrome_path=os.path.join(fleet_dir, "router_trace.json"),
    )
    router = FleetRouter(cfg, registry=registry, logger=logger, tracer=tracer)
    aggregator = None
    if cfg.aggregate_every_s > 0:
        aggregator = TelemetryAggregator(
            stale_after_s=cfg.aggregate_stale_after_s
        )
        # The router's own registry is a source too — its ddlpc_router_*
        # series roll up beside the replicas' ddlpc_serve_* families.
        aggregator.add_source("router", registry.exposition)
        aggregator.start(cfg.aggregate_every_s)
    sup = ReplicaSupervisor(
        cfg, router=router, logger=logger, aggregator=aggregator,
        device=args.device,
    )
    n = sup.start(wait_ready=True)
    autoscaler = None
    if cfg.autoscale_enabled:
        from ddlpc_tpu_torch.serve.autoscale import Autoscaler

        autoscaler = Autoscaler(
            cfg, router, sup, logger=logger, registry=registry
        )
        autoscaler.start()
    server = make_fleet_server(
        router, sup, cfg.host, cfg.port, aggregator=aggregator
    )
    print(
        f"fleet: {n}/{cfg.replicas} replicas ready; routing "
        f"http://{cfg.host}:{server.server_address[1]} -> {cfg.workdir} "
        f"(device {args.device})",
        flush=True,
    )

    def _shutdown(signum, frame):
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        if autoscaler is not None:
            autoscaler.close()
        sup.stop()
        if aggregator is not None:
            aggregator.close()
        tracer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
