"""On-demand ``torch.profiler`` capture → the committed top-ops report —
the port of ``ddlpc_tpu/obs/profiling.py``.

The JAX module captures with ``jax.profiler`` and aggregates the XPlane
self-times (``obs/xplane.py``).  Here a capture is one
``torch.profiler.profile`` over the CPU and, where a card is present, the
CUDA activities; at its stop the capture writes its ``key_averages()``
(``ops.json``) and its Chrome trace (``trace.json``) into the trace
directory, and :func:`aggregate` turns ``ops.json`` into the same report
fields (``tag``, ``trace_dir``, ``planes``, ``steps_traced``,
``device_total_ms``, ``per_step_ms``, ``top_self_time``).  The ops are
ranked by their device self-time; where no op has any (a CPU run, or a
profiler that traced no kernel) by their CPU self-time, and ``planes``
says which.

Unlike ``jax.profiler``, ``torch.profiler`` records the CPU ops of the
thread that started the capture only; a card's kernels it records from
every thread (CUPTI).  So on a card a serve capture sees the forwards the
batcher's slot threads launch, by their kernels; on the CPU it sees none
of them, and the report comes back with an empty ``top_self_time``.

Two live triggers share the module, as in the JAX package:

- the trainer's SIGUSR2 and its telemetry endpoint's
  ``/debug/trace?steps=N`` arm :class:`OnDemandProfiler`, and the step loop
  drives :meth:`OnDemandProfiler.step_done`: the capture spans exactly N
  steps, ends with a device sync so that the last step's kernels are in
  it, and ``profile_<n>/`` and ``top_ops_<n>.json`` land in the workdir;
- the serve frontend's ``/debug/trace?steps=N`` route uses :func:`capture`
  around its forward counter.

Every trigger, and the per-epoch ``train.profile_epoch`` capture
(``train/observability.maybe_profile``), captures through
:func:`session`, which holds the module's one capture lock, so that two
captures meet as :class:`CaptureBusy`.

JAX's ``obs/xplane.py`` has no counterpart module: its job, the per-op
self-times of a device trace, is what :func:`top_ops_report` does from
``torch.profiler``'s own ``key_averages()``.

Failure discipline: profiling is diagnostics, never the run's critical
path.  A profiler that cannot start, a second concurrent capture, or an
unreadable summary all degrade to an ``error`` field in the returned
report — they never raise into the loop or the request handler.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import ExitStack, contextmanager
from typing import Callable, Optional

from ddlpc_tpu_torch.utils.fsio import atomic_write_json

# One capture at a time per process: the profiler supports a single active
# session, and a trainer trigger and a serve endpoint may share a process.
_capture_lock = threading.Lock()

OPS_FILE = "ops.json"


class CaptureBusy(RuntimeError):
    """Another profiler capture is already running in this process."""


class ProfilerFailed(RuntimeError):
    """The profiler could not start."""


def _start_profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _device_us(ev) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(ev, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def _stop_profiler(prof, trace_dir: str) -> None:
    """Stop ``prof`` and write its per-op self-times and its Chrome trace
    into ``trace_dir``."""
    prof.stop()
    os.makedirs(trace_dir, exist_ok=True)
    ops = [
        {
            "op": ev.key,
            "device_us": _device_us(ev),
            "cpu_us": float(ev.self_cpu_time_total),
            "count": int(ev.count),
        }
        for ev in prof.key_averages()
    ]
    atomic_write_json(os.path.join(trace_dir, OPS_FILE), ops, indent=None)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def top_ops_report(trace_dir: str, top: int = 30, steps: int = 1, tag: str = "") -> dict:
    """The committed top-ops JSON format from a capture's ``ops.json``;
    ``steps`` normalizes to per-step milliseconds."""
    steps = max(int(steps), 1)
    with open(os.path.join(trace_dir, OPS_FILE)) as f:
        ops = json.load(f)
    plane = "device" if any(o["device_us"] > 0 for o in ops) else "cpu"
    key = "device_us" if plane == "device" else "cpu_us"
    ranked = sorted((o for o in ops if o[key] > 0), key=lambda o: -o[key])
    total_us = sum(o[key] for o in ranked)
    return {
        "tag": tag,
        "trace_dir": os.path.abspath(trace_dir),
        "planes": [plane],
        "steps_traced": steps,
        "device_total_ms": round(total_us / 1e3, 3),
        "per_step_ms": round(total_us / 1e3 / steps, 3),
        "top_self_time": [
            {
                "op": o["op"][:160],
                "self_ms_per_step": round(o[key] / 1e3 / steps, 4),
                "count": o["count"],
            }
            for o in ranked[:top]
        ],
    }


def aggregate(trace_dir: str, steps: int, top: int = 30, tag: str = "") -> dict:
    """Top-ops report for a finished capture; an unreadable summary
    becomes a report-level ``error`` (the raw trace stays on disk)."""
    try:
        return top_ops_report(trace_dir, top=top, steps=steps, tag=tag)
    except Exception as e:
        return {
            "tag": tag,
            "trace_dir": os.path.abspath(trace_dir),
            "steps_traced": steps,
            "error": f"{type(e).__name__}: {e}",
        }


@contextmanager
def session(trace_dir: str):
    """One guarded capture around a block, the one start/stop sequence of
    every trigger: it takes the module's capture lock (:class:`CaptureBusy`
    when it is held), starts the profiler (:class:`ProfilerFailed` when it
    cannot), runs the block, and stops the profiler into ``trace_dir``
    even when the block raises; the lock is released in every case.  It
    yields a dict that, after the block, holds ``error`` where the
    profiler failed to stop; an exception of the block propagates."""
    if not _capture_lock.acquire(blocking=False):
        raise CaptureBusy("a profiler capture is already running")
    try:
        try:
            prof = _start_profiler()
        except Exception as e:
            raise ProfilerFailed(f"profiler failed to start: {e}") from e
        outcome: dict = {}
        try:
            yield outcome
        finally:
            try:
                _stop_profiler(prof, trace_dir)
            except Exception as e:
                outcome["error"] = f"profiler failed to stop: {e}"
    finally:
        _capture_lock.release()


def capture(
    trace_dir: str,
    until: Callable[[], bool],
    timeout_s: float = 30.0,
    poll_s: float = 0.01,
) -> dict:
    """Run one profiler capture until ``until()`` (or timeout); returns
    ``{"trace_dir", "seconds", "timed_out"}`` or ``{"error"}``.  Raises
    :class:`CaptureBusy` when a capture is already active."""
    t0 = time.perf_counter()
    timed_out = False
    try:
        with session(trace_dir) as outcome:
            deadline = t0 + timeout_s
            while not until():
                if time.perf_counter() >= deadline:
                    timed_out = True
                    break
                time.sleep(poll_s)
    except ProfilerFailed as e:
        return {"error": str(e)}
    if "error" in outcome:
        return {"error": outcome["error"]}
    return {
        "trace_dir": trace_dir,
        "seconds": round(time.perf_counter() - t0, 4),
        "timed_out": timed_out,
    }


class OnDemandProfiler:
    """Arm from anywhere, capture in the loop: the trainer's profiler.

    ``arm()`` only sets an event, so a signal handler or another thread
    may call it.  The training loop calls ``step_done(sync)`` once a step;
    the profiler starts a capture on the first armed step, counts ``steps``
    more, calls ``sync()`` (the step's device work must end inside the
    capture), stops, aggregates, and writes ``top_ops_<n>.json`` and
    ``profile_<n>/`` under ``out_dir``.  A capture already running in the
    process (:class:`CaptureBusy`) or a profiler that cannot start comes
    back as a report whose ``error`` says so; nothing raises."""

    def __init__(self, out_dir: str, steps: int = 20, top: int = 30, logger=None,
                 enabled: bool = True):
        self.out_dir = out_dir
        self.steps = max(int(steps), 1)
        self.top = top
        self.logger = logger
        self.enabled = enabled
        self._armed = threading.Event()
        self._active = False
        self._steps_left = 0
        self._capture_n = 0
        self._trace_dir: Optional[str] = None
        self._session: Optional[ExitStack] = None
        self._outcome: dict = {}
        self._t0 = 0.0
        self.last_report: Optional[dict] = None

    def arm(self, steps: Optional[int] = None) -> None:
        """Request a capture of the next ``steps`` training steps."""
        if steps is not None:
            self.steps = max(int(steps), 1)
        self._armed.set()

    @property
    def armed(self) -> bool:
        return self._armed.is_set() or self._active

    def step_done(self, sync: Optional[Callable[[], None]] = None) -> Optional[dict]:
        """Drive the capture; call once a step.  Returns the report when a
        capture completes or could not start, else None."""
        if not self.enabled:
            return None
        if self._active:
            self._steps_left -= 1
            if self._steps_left > 0:
                return None
            return self._finish(sync)
        if not self._armed.is_set():
            return None
        self._armed.clear()
        return self._start()

    def finalize(self, sync: Optional[Callable[[], None]] = None) -> Optional[dict]:
        """Close a capture the run ended in the middle of: stop it and
        aggregate over the steps that did run, so that no run exits with
        the profiler open and the arm lost."""
        if not self._active:
            return None
        requested = self.steps
        self.steps = max(self.steps - self._steps_left, 1)
        try:
            return self._finish(sync)
        finally:
            self.steps = requested

    def _start(self) -> Optional[dict]:
        trace_dir = os.path.join(self.out_dir, f"profile_{self._capture_n + 1:03d}")
        stack = ExitStack()
        try:
            self._outcome = stack.enter_context(session(trace_dir))
        except CaptureBusy as e:
            return self._failed(f"{CaptureBusy.__name__}: {e}")
        except ProfilerFailed as e:  # the profiler is diagnostics
            self._capture_n += 1
            return self._failed(str(e))
        self._capture_n += 1
        self._trace_dir = trace_dir
        os.makedirs(trace_dir, exist_ok=True)
        self._session = stack
        self._active = True
        self._steps_left = self.steps
        self._t0 = time.perf_counter()
        return None

    def _failed(self, error: str) -> dict:
        self.last_report = {"error": error}
        self._log(self.last_report)
        return self.last_report

    def _finish(self, sync: Optional[Callable[[], None]]) -> dict:
        sync_error = None
        try:
            if sync is not None:
                # The capture must hold the last step's kernels; a failed
                # sync still stops the profiler (a profiler left running
                # would refuse every later capture).
                try:
                    sync()
                except Exception as e:  # noqa: BLE001
                    sync_error = f"sync failed: {e}"
        finally:
            self._session.close()
            self._session = None
            self._active = False
        if "error" in self._outcome:
            self.last_report = {"error": self._outcome["error"]}
            return self.last_report
        wall = time.perf_counter() - self._t0
        report = aggregate(self._trace_dir, steps=self.steps, top=self.top,
                           tag=f"ondemand_{self._capture_n:03d}")
        report["wall_s"] = round(wall, 4)
        report["wall_ms_per_step"] = round(wall * 1e3 / self.steps, 3)
        if sync_error is not None:
            report.setdefault("error", sync_error)
        path = os.path.join(self.out_dir, f"top_ops_{self._capture_n:03d}.json")
        try:
            from ddlpc_tpu_torch.utils.fsio import atomic_write_json

            atomic_write_json(path, report)
            report["report_path"] = path
        except OSError as e:  # a full disk must not kill the training loop
            report.setdefault("error", f"report not written: {e}")
        self.last_report = report
        self._log(report)
        return report

    def _log(self, report: dict) -> None:
        if self.logger is None:
            return
        try:
            self.logger.log({
                "kind": "profile",
                "report_path": report.get("report_path"),
                "steps_traced": self.steps,
                "per_step_ms": report.get("per_step_ms"),
                "wall_ms_per_step": report.get("wall_ms_per_step"),
                "error": report.get("error"),
            }, echo=False)
        except Exception:  # noqa: BLE001 — diagnostics never break the loop
            pass
