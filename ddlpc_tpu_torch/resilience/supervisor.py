"""Process supervisor: launch, watch, classify, back off, relaunch, resume.

The recovery story the watchdog docstring promises (train/watchdog.py:
detect → die → restart → resume) needs a process that OUTLIVES the
training process.  This is that process, which a cluster entrypoint can
wrap:

    python -m ddlpc_tpu_torch.resilience.supervisor --workdir runs/x -- \\
        python -m ddlpc_tpu_torch.train --config configs/x.json --workdir runs/x

Behavior:

- **Exit-cause classification** via the structured exit-status/breadcrumb
  protocol (resilience/protocol.py): clean (0) ends supervision;
  watchdog stall (42), graceful preemption (43), crashes, and external
  kills (SIGKILL ⇒ possible OOM) each restart with their own accounting,
  emitted as ``ddlpc_restarts_total{cause}`` through the obs registry and
  as flat schema-stamped records in ``<workdir>/resilience.jsonl``.
- **Exponential backoff + full jitter** between restarts that made no
  checkpoint progress (base·2^n capped, uniformly jittered — the fleet-
  thundering-herd standard); progressing restarts and graceful
  preemptions relaunch immediately.
- **Crash-loop detection**: ``crash_loop_limit`` consecutive failures
  without the newest checkpoint step advancing → give up LOUDLY (a
  critical record + stderr banner + nonzero status) instead of burning a
  restart budget on a deterministic crash.
- **Signal forwarding**: SIGTERM/SIGINT to the supervisor forward to the
  child (which runs its graceful-preemption path) and end supervision
  after the child exits — the whole tree preempts as one unit.

Stdlib + obs-registry only: the supervisor must stay importable and alive
when the training process cannot even reach its first torch import.

The port's own copy of ``ddlpc_tpu/resilience/supervisor.py``: the same
causes, backoff and records.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from ddlpc_tpu_torch.obs.registry import MetricsRegistry
from ddlpc_tpu_torch.obs.schema import SCHEMA_VERSION
from ddlpc_tpu_torch.resilience.protocol import (
    EXIT_CLEAN,
    EXIT_PREEMPTED,
    EXIT_STALL,
    latest_checkpoint_step,
    read_breadcrumb,
)


def classify_exit(returncode: int, breadcrumb: Optional[dict] = None) -> str:
    """Coarse exit status + breadcrumb → one cause label.

    Causes: ``clean`` | ``stall`` | ``preempted`` | ``oom_kill`` |
    ``signal`` | ``crash``.  The breadcrumb refines ambiguity the status
    cannot carry — e.g. a process that died of SIGKILL while its crumb
    still says ``running`` is an external kill/OOM, not a code path.
    """
    phase = (breadcrumb or {}).get("phase")
    if returncode == EXIT_CLEAN:
        return "clean"
    if returncode == EXIT_STALL or phase == "stalled":
        return "stall"
    if returncode == EXIT_PREEMPTED or phase in ("preempted", "preempt_timeout"):
        return "preempted"
    if returncode in (-signal.SIGKILL, 128 + signal.SIGKILL):
        # SIGKILL is what both the kernel OOM killer and an impatient
        # scheduler send; without a crumb saying otherwise, treat as OOM-
        # class (restartable, but worth distinct accounting).
        return "oom_kill"
    if returncode < 0:
        return "signal"
    return "crash"


class RestartPolicy:
    """The backoff / crash-loop / give-up state machine, extracted so the
    training :class:`Supervisor` and the serve fleet's ``ReplicaSupervisor``
    (serve/fleet.py) restart things by ONE set of rules:

    - full-jitter exponential backoff between restarts that made no
      progress (``uniform(0, min(cap, base·2^(streak-1)))``);
    - ``crash_loop_limit`` consecutive no-progress exits → give up;
    - ``max_restarts`` total restarts → give up.

    "Progress" is the caller's notion (the training supervisor: the newest
    checkpoint step advanced or a graceful preemption completed; the fleet:
    the replica became ready and served traffic since launch).  The policy
    only tracks the streak.
    """

    def __init__(
        self,
        max_restarts: int = 100,
        crash_loop_limit: int = 3,
        backoff_base_s: float = 1.0,
        backoff_cap_s: float = 60.0,
        rng: Optional[random.Random] = None,
    ):
        if crash_loop_limit < 1:
            raise ValueError(
                f"crash_loop_limit must be >= 1, got {crash_loop_limit}"
            )
        self.max_restarts = int(max_restarts)
        self.crash_loop_limit = int(crash_loop_limit)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.rng = rng if rng is not None else random.Random()
        self.fail_streak = 0
        self.attempts = 0  # exits recorded (== restarts granted so far + 1)

    def backoff_s(self, fail_streak: int) -> float:
        """Full-jitter exponential backoff for the Nth consecutive
        no-progress failure (streak >= 1): uniform(0, min(cap, base·2^(N-1)))."""
        if fail_streak <= 0:
            return 0.0
        ceiling = min(
            self.backoff_cap_s,
            self.backoff_base_s * (2.0 ** (fail_streak - 1)),
        )
        return self.rng.uniform(0.0, ceiling)

    def record_exit(self, progressed: bool) -> str:
        """Account one child exit; returns the decision:
        ``"restart"`` | ``"give_up_crash_loop"`` | ``"give_up_budget"``."""
        self.attempts += 1
        if progressed:
            self.fail_streak = 0
        else:
            self.fail_streak += 1
        if self.fail_streak >= self.crash_loop_limit:
            return "give_up_crash_loop"
        if self.attempts > self.max_restarts:
            return "give_up_budget"
        return "restart"

    def delay_s(self) -> float:
        """The backoff to sleep before the restart just granted."""
        return self.backoff_s(self.fail_streak)


@dataclass
class SupervisorResult:
    """What a supervision run amounted to."""

    final_status: int
    attempts: int
    restarts_by_cause: Dict[str, int] = field(default_factory=dict)
    gave_up: bool = False
    reason: str = ""

    @property
    def ok(self) -> bool:
        return self.final_status == EXIT_CLEAN and not self.gave_up


class Supervisor:
    """Relaunch ``cmd`` until it exits clean, gives up, or is told to stop.

    ``env_fn(attempt) -> dict | None`` lets a caller vary the child's
    environment per attempt — how a fault-injection run puts a different
    fault into each relaunch (resilience/chaos.py counts steps per process, so a
    schedule that killed attempt 0 at step K would kill every restart at
    step K too unless rewritten).  ``sleep``/``rng``/``popen`` are
    injectable so the backoff/crash-loop logic unit-tests with a fake
    clock and no real processes.
    """

    def __init__(
        self,
        cmd: Sequence[str],
        workdir: str,
        ckpt_dir: Optional[str] = None,
        max_restarts: int = 100,
        crash_loop_limit: int = 3,
        backoff_base_s: float = 1.0,
        backoff_cap_s: float = 60.0,
        env_fn: Optional[Callable[[int], Optional[dict]]] = None,
        registry: Optional[MetricsRegistry] = None,
        sleep: Callable[[float], None] = time.sleep,
        rng: Optional[random.Random] = None,
        popen: Callable[..., "subprocess.Popen"] = subprocess.Popen,
        echo: bool = True,
    ):
        self.cmd = list(cmd)
        self.workdir = workdir
        self.ckpt_dir = ckpt_dir or os.path.join(workdir, "checkpoints")
        self.policy = RestartPolicy(
            max_restarts=max_restarts,
            crash_loop_limit=crash_loop_limit,
            backoff_base_s=backoff_base_s,
            backoff_cap_s=backoff_cap_s,
            rng=rng,
        )
        self.max_restarts = self.policy.max_restarts
        self.crash_loop_limit = self.policy.crash_loop_limit
        self.env_fn = env_fn
        self.registry = registry if registry is not None else MetricsRegistry()
        self._restarts = self.registry.counter(
            "ddlpc_restarts_total",
            "Supervised training restarts, by classified exit cause.",
            labelnames=("cause",),
        )
        self._sleep = sleep
        self._popen = popen
        self.echo = echo
        self._stop = threading.Event()
        self._child: Optional[subprocess.Popen] = None
        self._jsonl_path = os.path.join(workdir, "resilience.jsonl")

    # -- plumbing -----------------------------------------------------------

    def _say(self, msg: str) -> None:
        if self.echo:
            print(f"[supervisor] {msg}", file=sys.stderr, flush=True)

    def _log(self, record: dict) -> None:
        """Append one flat schema-stamped record to resilience.jsonl (the
        stream the JAX package's schema linter and tail tools read).
        Best-effort — supervision must survive a full disk."""
        record = dict(record)
        record.setdefault("schema", SCHEMA_VERSION)
        record.setdefault("time", time.time())
        try:
            os.makedirs(self.workdir, exist_ok=True)
            with open(self._jsonl_path, "a") as f:
                f.write(json.dumps(record) + "\n")
        except OSError:
            pass

    def request_stop(self, sig: int = signal.SIGTERM) -> None:
        """Forward ``sig`` to the child and end supervision after it exits
        (no further restarts).  Safe from signal handlers and threads."""
        self._stop.set()
        child = self._child
        if child is not None and child.poll() is None:
            try:
                child.send_signal(sig)
            except (ProcessLookupError, OSError):
                pass

    def backoff_s(self, fail_streak: int) -> float:
        """Full-jitter backoff for the Nth consecutive no-progress failure
        (delegates to :class:`RestartPolicy` — one impl for both
        supervisors)."""
        return self.policy.backoff_s(fail_streak)

    # -- the loop -----------------------------------------------------------

    def run(self) -> SupervisorResult:
        attempt = 0
        restarts: Dict[str, int] = {}
        installed = []
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    prev = signal.signal(
                        sig, lambda s, f: self.request_stop(signal.SIGTERM)
                    )
                    installed.append((sig, prev))
                except (ValueError, OSError):
                    pass
        try:
            while True:
                step_before = latest_checkpoint_step(self.ckpt_dir)
                env = self.env_fn(attempt) if self.env_fn is not None else None
                self._say(
                    f"attempt {attempt}: launching {' '.join(self.cmd[:3])}... "
                    f"(ckpt step {step_before})"
                )
                self._child = self._popen(self.cmd, env=env)
                child_pid = getattr(self._child, "pid", None)
                rc = self._child.wait()
                crumb = read_breadcrumb(self.workdir)
                if (
                    crumb is not None
                    and child_pid is not None
                    and crumb.get("pid") != child_pid
                ):
                    # Stale: written by a PREVIOUS attempt's process.  A
                    # child that crashed before its first breadcrumb (bad
                    # config, import error) must not inherit the old
                    # phase — a crash misread as "preempted" would reset
                    # the crash-loop counter forever.  (A launcher that
                    # forks before exec'ing python breaks the pid match;
                    # classification then falls back to the exit status,
                    # which still carries 42/43 through a forwarding
                    # shell.)
                    crumb = None
                cause = classify_exit(rc, crumb)
                step_after = latest_checkpoint_step(self.ckpt_dir)
                progressed = step_after is not None and (
                    step_before is None or step_after > step_before
                )
                self._log(
                    {
                        "kind": "supervisor_attempt",
                        "attempt": attempt,
                        "rc": rc,
                        "cause": cause,
                        "breadcrumb_phase": (crumb or {}).get("phase"),
                        "ckpt_step_before": step_before,
                        "ckpt_step_after": step_after,
                        "progressed": progressed,
                    }
                )
                self._say(
                    f"attempt {attempt}: exit {rc} ({cause}), checkpoint "
                    f"{step_before} -> {step_after}"
                )
                if cause == "clean":
                    return SupervisorResult(EXIT_CLEAN, attempt + 1, restarts)
                if self._stop.is_set():
                    # The operator/scheduler preempted the whole unit: the
                    # child already ran its graceful path; do not relaunch.
                    return SupervisorResult(
                        rc, attempt + 1, restarts,
                        reason="stopped by signal",
                    )
                attempt += 1
                # Only a restart that PROGRESSED, or a preemption whose
                # breadcrumb confirms the graceful path completed (phase
                # "preempted" — the emergency checkpoint is durable),
                # resets the no-progress streak.  A 43 whose grace window
                # expired (phase "preempt_timeout", e.g. a dead checkpoint
                # store) must keep counting toward backoff + give-up, or a
                # persistently failing graceful path relaunches in a tight
                # loop forever.
                graceful = (
                    cause == "preempted"
                    and (crumb or {}).get("phase") == "preempted"
                )
                decision = self.policy.record_exit(progressed or graceful)
                if decision != "restart":
                    if decision == "give_up_crash_loop":
                        msg = (
                            f"crash loop: {self.policy.fail_streak} "
                            f"consecutive exits ({cause} last, rc {rc}) "
                            f"without checkpoint progress (stuck at step "
                            f"{step_after}) — giving up. "
                            f"Fix the run; restarting cannot."
                        )
                    else:
                        msg = f"restart budget exhausted ({self.max_restarts})"
                    self._say(msg)
                    self._log(
                        {
                            "kind": "supervisor_give_up",
                            "severity": "critical",
                            "message": msg,
                            "attempts": attempt,
                            "rc": rc,
                        }
                    )
                    return SupervisorResult(
                        rc, attempt, restarts, gave_up=True, reason=msg
                    )
                restarts[cause] = restarts.get(cause, 0) + 1
                self._restarts.inc(cause=cause)
                delay = self.policy.delay_s()
                if delay > 0:
                    self._say(
                        f"backing off {delay:.2f}s (no-progress streak "
                        f"{self.policy.fail_streak})"
                    )
                    self._sleep(delay)
        finally:
            self._child = None
            for sig, prev in installed:
                try:
                    signal.signal(sig, prev)
                except (ValueError, OSError):
                    pass


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ddlpc_tpu_torch.resilience.supervisor",
        description="Supervise a training command: restart on stall/crash/"
        "preemption, resume from checkpoints, give up on crash loops.",
    )
    p.add_argument("--workdir", required=True, help="run directory (breadcrumb, resilience.jsonl, checkpoints/)")
    p.add_argument("--ckpt-dir", help="checkpoint dir (default <workdir>/checkpoints)")
    p.add_argument("--max-restarts", type=int, default=100)
    p.add_argument("--crash-loop-limit", type=int, default=3)
    p.add_argument("--backoff-base-s", type=float, default=1.0)
    p.add_argument("--backoff-cap-s", type=float, default=60.0)
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="-- then the training command to supervise")
    args = p.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        p.error("no command given (put it after --)")
    sup = Supervisor(
        cmd,
        workdir=args.workdir,
        ckpt_dir=args.ckpt_dir,
        max_restarts=args.max_restarts,
        crash_loop_limit=args.crash_loop_limit,
        backoff_base_s=args.backoff_base_s,
        backoff_cap_s=args.backoff_cap_s,
    )
    result = sup.run()
    return 0 if result.ok else (result.final_status if result.final_status > 0 else 1)


if __name__ == "__main__":
    sys.exit(main())
