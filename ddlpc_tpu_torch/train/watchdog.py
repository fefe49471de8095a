"""Stall watchdog: a hung step or collective becomes a bounded, diagnosed
failure — the port's copy of ``ddlpc_tpu/train/watchdog.py``.

- the training loop ``beat()``s at every data fetch and step, and per eval
  batch;
- a daemon thread checks the heartbeat's age; past ``timeout_s`` it writes
  a diagnosis (the last beat's tag, its age, and every thread's Python
  stack through ``faulthandler``) to stderr and ``<workdir>/stall.log``,
  and calls ``on_stall`` (the trainer writes the ``stalled`` breadcrumb);
- ``action='abort'`` then ends the process with status 42
  (``resilience/protocol.EXIT_STALL``) through ``os._exit``, which a
  daemon thread can call while the main thread is blocked in
  ``torch.cuda.synchronize()`` or a collective, both of which release the
  interpreter lock.  A supervisor restarts the run, which resumes from its
  newest checkpoint.

``action='dump'`` (the default) only diagnoses, at most once a window.
Phases that are legitimately long and unbeaten (a checkpoint, the image
dump, the eval's fetch) run inside :meth:`StallWatchdog.paused`.

The health monitor (``obs/health.py``) hands its alerts to
:meth:`StallWatchdog.record_alert`; the diagnosis prints the recent ones
(a bounded ring of 32) beside the stacks, so a stall shows what health
saw just before it.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Callable, Iterator, Optional

from ddlpc_tpu_torch.resilience.protocol import EXIT_STALL


class StallWatchdog:
    """Detects a heartbeat quiet for longer than ``timeout_s``.

    Use as a context manager around the training loop; call :meth:`beat`
    from the loop.  ``timeout_s <= 0`` disables it (no thread)."""

    def __init__(
        self,
        timeout_s: float,
        action: str = "dump",  # dump | abort
        log_path: Optional[str] = None,
        on_stall: Optional[Callable[[float, str], None]] = None,
        exit_code: int = EXIT_STALL,
        _exit=os._exit,  # injectable for tests
    ):
        if action not in ("dump", "abort"):
            raise ValueError(f"unknown watchdog action {action!r}")
        self.timeout_s = float(timeout_s)
        self.action = action
        self.log_path = log_path
        self.on_stall = on_stall
        self.exit_code = exit_code
        self._exit = _exit
        self._last = time.monotonic()
        self._tag = "init"
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._pause_depth = 0
        self._pause_lock = threading.Lock()
        self.stall_count = 0
        # The health monitor's recent alerts, from any thread.
        self._alerts: deque = deque(maxlen=32)
        self._alerts_lock = threading.Lock()

    def beat(self, tag: str = "") -> None:
        """Mark liveness; ``tag`` names the phase for the diagnosis."""
        self._last = time.monotonic()
        if tag:
            self._tag = tag

    def record_alert(self, record: dict) -> None:
        """Keep a health alert (its flat record) for the next diagnosis.
        Never raises: diagnostics must not break the loop they watch."""
        try:
            with self._alerts_lock:
                self._alerts.append(dict(record))
        except Exception:  # noqa: BLE001
            pass

    def recent_alerts(self) -> list:
        with self._alerts_lock:
            return list(self._alerts)

    @contextlib.contextmanager
    def paused(self, tag: str = "paused") -> Iterator[None]:
        """Suspend detection for a long, unbeaten phase whose length has
        nothing to do with a step's.  Nests; re-arms with a fresh beat."""
        with self._pause_lock:
            self._pause_depth += 1
        self._tag = tag
        try:
            yield
        finally:
            # Beat under the lock, with the decrement: the monitor reads the
            # depth under it, so it never sees depth 0 beside a beat as old
            # as the whole pause.
            with self._pause_lock:
                self.beat(f"after_{tag}")
                self._pause_depth -= 1

    def start(self) -> "StallWatchdog":
        if self.timeout_s > 0 and self._thread is None:
            self.beat("start")
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, name="stall-watchdog", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "StallWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        poll = max(self.timeout_s / 10.0, 0.05)
        while not self._stop.wait(poll):
            with self._pause_lock:
                if self._pause_depth > 0:
                    continue
            age = time.monotonic() - self._last
            if age < self.timeout_s:
                continue
            self.stall_count += 1
            self._diagnose(age)
            if self.on_stall is not None:
                self.on_stall(age, self._tag)
            if self.action == "abort":
                self._exit(self.exit_code)
            # dump: re-arm, so the next window diagnoses again rather than
            # every poll.
            self.beat()

    def _diagnose(self, age: float) -> None:
        msg = (
            f"[watchdog] no heartbeat for {age:.1f}s "
            f"(timeout {self.timeout_s:.1f}s); last phase: {self._tag!r}. "
            f"Process {os.getpid()} thread stacks follow."
        )
        alerts = self.recent_alerts()
        streams = [sys.stderr]
        fh = None
        try:
            if self.log_path:
                fh = open(self.log_path, "a")
                streams.append(fh)
            for s in streams:
                print(msg, file=s, flush=True)
                if alerts:
                    print(f"[watchdog] {len(alerts)} recent health alert(s) before the stall:",
                          file=s, flush=True)
                    for rec in alerts:
                        try:
                            print("  " + json.dumps(rec), file=s, flush=True)
                        except (TypeError, ValueError):
                            pass
                try:
                    # Every thread's stack: a device fetch, a collective, or
                    # host code.
                    faulthandler.dump_traceback(file=s)
                except (OSError, ValueError, RuntimeError):
                    pass
        finally:
            if fh is not None:
                fh.close()
