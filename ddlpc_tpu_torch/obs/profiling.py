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

The serve frontend's ``/debug/trace?steps=N`` route uses :func:`capture`
around its forward counter.  (The JAX module's ``OnDemandProfiler``, the
trainer's SIGUSR2 trigger, comes with the trainer's profiling.)

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
from typing import Callable

# One capture at a time per process: the profiler supports a single active
# session, and a trainer trigger and a serve endpoint may share a process.
_capture_lock = threading.Lock()

OPS_FILE = "ops.json"


class CaptureBusy(RuntimeError):
    """Another profiler capture is already running in this process."""


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
    with open(os.path.join(trace_dir, OPS_FILE), "w") as f:
        json.dump(ops, f)
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


def capture(
    trace_dir: str,
    until: Callable[[], bool],
    timeout_s: float = 30.0,
    poll_s: float = 0.01,
) -> dict:
    """Run one profiler capture until ``until()`` (or timeout); returns
    ``{"trace_dir", "seconds", "timed_out"}`` or ``{"error"}``.  Raises
    :class:`CaptureBusy` when a capture is already active."""
    if not _capture_lock.acquire(blocking=False):
        raise CaptureBusy("a profiler capture is already running")
    try:
        t0 = time.perf_counter()
        try:
            prof = _start_profiler()
        except Exception as e:
            return {"error": f"profiler failed to start: {e}"}
        timed_out = False
        try:
            deadline = t0 + timeout_s
            while not until():
                if time.perf_counter() >= deadline:
                    timed_out = True
                    break
                time.sleep(poll_s)
        finally:
            try:
                _stop_profiler(prof, trace_dir)
            except Exception as e:
                return {"error": f"profiler failed to stop: {e}"}
        return {
            "trace_dir": trace_dir,
            "seconds": round(time.perf_counter() - t0, 4),
            "timed_out": timed_out,
        }
    finally:
        _capture_lock.release()
