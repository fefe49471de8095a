"""Env-var-driven fault injection — the chaos harness behind the soak test.

A fault schedule is one string in ``DDLPC_CHAOS``, semicolon-separated:

  ``kill@N``        SIGKILL this process at train step N (no cleanup at
                    all — the hard-crash case)
  ``stall@N[:S]``   sleep S seconds (default 3600) at step N with no
                    heartbeat — the hung-collective case the watchdog
                    turns into EXIT_STALL
  ``preempt@N``     request graceful preemption at step N — deterministic
                    SIGTERM-equivalent without signal-delivery races
  ``nan@N``         at step N, poison the next epoch record's loss with
                    NaN (drives the obs/health.py critical alert)
  ``flip_ckpt@K``   flip one byte in the blob of the Kth checkpoint write
                    — the on-disk corruption the CRC manifest must catch
  ``disk_full@K``   the Kth checkpoint write raises ENOSPC before writing
                    — surfaces through the AsyncCheckpointer's
                    re-raise-on-training-thread contract
  ``slow_loader:MS``  every data fetch sleeps MS milliseconds

Serve-side faults, triggered by batched-forward count in the
serving engine instead of optimizer steps:

  ``serve_kill@N``    SIGKILL the serving process at its Nth batched
                      forward — the replica-death case the fleet router
                      must retry around
  ``serve_stall@N[:S]``  sleep S seconds (default 60) inside the Nth
                      forward — the response-stall case that must surface
                      as a router timeout, not a hung client
  ``serve_err@N[:K]`` raise :class:`ChaosFault` from forwards N..N+K-1
                      (default K=1) — the error burst that must trip the
                      router's per-replica circuit breaker
  ``reload_corrupt@K``  before the Kth checkpoint hot-reload, flip one
                      byte of the newest checkpoint blob — the reader
                      quarantines it and falls back, which a rolling
                      fleet reload must treat as a fleet-wide abort

Step numbers count optimizer-step loop iterations **since process start**
(a restarted process counts from 0 again — the supervisor's per-attempt
``env_fn`` is how a schedule avoids re-killing itself forever); serve
triggers count batched forwards since process start the same way.
One-shot faults fire at most once per process.  Injections print a
``[chaos]`` line to stderr so a survival report can be audited against
the schedule.

Stdlib-only on purpose: ``train/checkpoint.py`` calls the checkpoint hooks
and must not gain a heavyweight (or circular) import for a harness that is
inert unless the env var is set.

The port's own copy of ``ddlpc_tpu/resilience/chaos.py`` (stdlib only), kept line for line
so the two read alike.
"""

from __future__ import annotations

import errno
import os
import signal
import sys
import time
from typing import Dict, List, Optional, Set

ENV = "DDLPC_CHAOS"

_cache_spec: Optional[str] = None
_cache_monkey: Optional["ChaosMonkey"] = None


class ChaosError(ValueError):
    """A malformed DDLPC_CHAOS spec — raised at parse time, loudly, so a
    typo'd schedule cannot silently run a chaos-free soak."""


class ChaosFault(RuntimeError):
    """An injected serve-side failure (``serve_err``): raised out of the
    engine's forward so it rides the real error path — batcher fails the
    batch, frontend answers 500, the router's breaker counts it."""


def _log(msg: str) -> None:
    print(f"[chaos] {msg}", file=sys.stderr, flush=True)


class ChaosMonkey:
    """Parsed fault schedule + one-shot firing state for this process."""

    KINDS = (
        "kill", "stall", "preempt", "nan", "flip_ckpt", "disk_full",
        "slow_loader", "serve_kill", "serve_stall", "serve_err",
        "reload_corrupt",
    )

    def __init__(self, spec: str):
        self.spec = spec
        # kind -> trigger (step or nth-event); stall also keeps a duration.
        self.step_faults: Dict[int, List[dict]] = {}
        self.ckpt_faults: Dict[str, int] = {}  # kind -> nth write (1-based)
        # Serve-side: nth batched forward -> faults; nth reload -> corrupt.
        self.serve_faults: Dict[int, List[dict]] = {}
        self.reload_corrupt_at = 0  # 1-based reload count; 0 = unscheduled
        self.slow_loader_ms = 0.0
        self.fired: List[dict] = []
        self._nan_armed = False
        self._ckpt_writes = 0
        self._serve_forwards = 0
        self._reloads = 0
        self._err_burst_left = 0
        for part in filter(None, (p.strip() for p in spec.split(";"))):
            self._parse(part)

    def _parse(self, part: str) -> None:
        dur = None
        if ":" in part:
            part, _, tail = part.partition(":")
            try:
                dur = float(tail)
            except ValueError:
                raise ChaosError(f"bad duration in chaos fault {part!r}:{tail!r}")
        if part.startswith("slow_loader"):
            if dur is None:
                raise ChaosError("slow_loader needs :MS, e.g. slow_loader:50")
            self.slow_loader_ms = dur
            return
        kind, sep, at = part.partition("@")
        if not sep or kind not in self.KINDS:
            raise ChaosError(
                f"unknown chaos fault {part!r} (kinds: {', '.join(self.KINDS)})"
            )
        try:
            n = int(at)
        except ValueError:
            raise ChaosError(f"bad trigger in chaos fault {part!r}")
        if kind in ("flip_ckpt", "disk_full"):
            self.ckpt_faults[kind] = n
        elif kind == "reload_corrupt":
            self.reload_corrupt_at = n
        elif kind.startswith("serve_"):
            self.serve_faults.setdefault(n, []).append(
                {"kind": kind, "dur": dur}
            )
        else:
            self.step_faults.setdefault(n, []).append(
                {"kind": kind, "dur": dur}
            )

    # -- hooks (all no-ops unless a matching fault is scheduled) ------------

    def on_step(self, step: int) -> Set[str]:
        """Called once per optimizer-step loop iteration.  ``kill`` and
        ``stall`` act here; ``preempt``/``nan`` are returned/armed for the
        trainer to act on (preemption must run the trainer's own graceful
        path — that is the point of the fault)."""
        faults = self.step_faults.pop(step, None)
        actions: Set[str] = set()
        if not faults:
            return actions
        for f in faults:
            kind = f["kind"]
            self.fired.append({"kind": kind, "step": step})
            _log(f"{kind} at step {step}")
            if kind == "kill":
                os.kill(os.getpid(), signal.SIGKILL)
            elif kind == "stall":
                time.sleep(f["dur"] if f["dur"] is not None else 3600.0)
            elif kind == "nan":
                self._nan_armed = True
            else:
                actions.add(kind)
        return actions

    def on_data_fetch(self) -> None:
        if self.slow_loader_ms > 0:
            time.sleep(self.slow_loader_ms / 1000.0)

    def corrupt_record(self, record: dict) -> dict:
        """Armed by ``nan@N``: poison the loss of the next epoch record."""
        if self._nan_armed and "loss" in record:
            self._nan_armed = False
            self.fired.append({"kind": "nan_record"})
            _log("poisoning epoch record loss with NaN")
            record = dict(record, loss=float("nan"))
        return record

    def on_checkpoint_save(self) -> None:
        """Before a checkpoint blob write; raises ENOSPC on the scheduled
        write.  The counter counts save ATTEMPTS, so the failing write and
        a flip on a later write can share one schedule."""
        self._ckpt_writes += 1
        if self.ckpt_faults.get("disk_full") == self._ckpt_writes:
            del self.ckpt_faults["disk_full"]
            self.fired.append(
                {"kind": "disk_full", "write": self._ckpt_writes}
            )
            _log(f"injecting ENOSPC on checkpoint write {self._ckpt_writes}")
            raise OSError(errno.ENOSPC, "chaos: no space left on device")

    def on_checkpoint_written(self, path: str) -> None:
        """After a blob landed under its final name: flip one mid-file byte
        on the scheduled write — exactly the corruption the per-chunk CRCs
        (train/checkpoint.py) must catch and quarantine on restore."""
        if self.ckpt_faults.get("flip_ckpt") != self._ckpt_writes:
            return
        del self.ckpt_faults["flip_ckpt"]
        try:
            size = os.path.getsize(path)
            pos = size // 2
            with open(path, "r+b") as f:
                f.seek(pos)
                b = f.read(1)
                f.seek(pos)
                f.write(bytes([b[0] ^ 0xFF]))
            self.fired.append(
                {"kind": "flip_ckpt", "path": path, "offset": pos}
            )
            _log(f"flipped byte {pos} of {path}")
        except OSError as e:
            _log(f"flip_ckpt failed on {path}: {e}")

    # -- serve-side hooks ---------------------------------------------------

    def on_serve_forward(self) -> None:
        """Called once per batched forward in the serving engine
        (serve/engine.py:forward_windows).  ``serve_kill`` and
        ``serve_stall`` act in place; ``serve_err`` arms a burst of
        :class:`ChaosFault` raises covering this and the next K-1
        forwards — the real 500 path the router's breaker must count."""
        self._serve_forwards += 1
        n = self._serve_forwards
        for f in self.serve_faults.pop(n, ()):
            kind = f["kind"]
            self.fired.append({"kind": kind, "forward": n})
            _log(f"{kind} at forward {n}")
            if kind == "serve_kill":
                os.kill(os.getpid(), signal.SIGKILL)
            elif kind == "serve_stall":
                time.sleep(f["dur"] if f["dur"] is not None else 60.0)
            elif kind == "serve_err":
                self._err_burst_left = int(f["dur"] or 1)
        if self._err_burst_left > 0:
            self._err_burst_left -= 1
            raise ChaosFault(f"chaos: injected error burst (forward {n})")

    def on_serve_reload(self, ckpt_dir: str) -> None:
        """Called at the top of every checkpoint hot-reload; on the Kth,
        flips one mid-file byte of the NEWEST live blob so the CRC reader
        quarantines it and falls back — the corrupt-reload case a rolling
        fleet update must abort on."""
        self._reloads += 1
        if self.reload_corrupt_at != self._reloads:
            return
        self.reload_corrupt_at = 0
        from ddlpc_tpu_torch.resilience.protocol import _CKPT_RE

        try:
            names = [n for n in os.listdir(ckpt_dir) if _CKPT_RE.match(n)]
        except OSError as e:
            _log(f"reload_corrupt: cannot list {ckpt_dir}: {e}")
            return
        if not names:
            _log(f"reload_corrupt: no checkpoints in {ckpt_dir}")
            return
        newest = max(names, key=lambda n: int(_CKPT_RE.match(n).group(1)))
        path = os.path.join(ckpt_dir, newest)
        try:
            size = os.path.getsize(path)
            pos = size // 2
            with open(path, "r+b") as f:
                f.seek(pos)
                b = f.read(1)
                f.seek(pos)
                f.write(bytes([b[0] ^ 0xFF]))
            self.fired.append(
                {"kind": "reload_corrupt", "path": path, "offset": pos,
                 "reload": self._reloads}
            )
            _log(f"reload_corrupt: flipped byte {pos} of {path}")
        except OSError as e:
            _log(f"reload_corrupt failed on {path}: {e}")


def active() -> Optional[ChaosMonkey]:
    """The process's ChaosMonkey, or None when ``DDLPC_CHAOS`` is unset.

    One instance per distinct spec value: one-shot firing state persists
    across call sites (trainer step loop, checkpoint writer), and a test
    that rewrites the env var gets a fresh schedule.
    """
    global _cache_spec, _cache_monkey
    spec = os.environ.get(ENV)
    if not spec:
        _cache_spec, _cache_monkey = None, None
        return None
    if spec != _cache_spec:
        _cache_monkey = ChaosMonkey(spec)
        _cache_spec = spec
    return _cache_monkey
