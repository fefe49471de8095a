"""Continuous batching: refill the device pipeline as slots free.

The coalescing :class:`~ddlpc_tpu_torch.serve.batching.MicroBatcher` is
coalesce-and-wait: ONE worker takes a batch (waiting up to
``max_wait_ms`` for it to fill), runs the forward to completion, and only
then looks at the queue again.  Two structural costs under ragged
traffic (the gap flagged at the engine's jit-cache counters):

- every lightly-loaded request pays the coalescing wait — a timer, not
  work — before its forward is even dispatched;
- while a forward executes, the queue builds but nothing is dispatched:
  the host-side stitch/np conversion tail of batch N serializes with the
  device work of batch N+1.

:class:`ContinuousBatcher` replaces the timer with *slots*: ``slots``
worker threads each assemble-and-dispatch whatever is queued (up to
``max_batch``, padded by the engine to the power-of-two bucket) the
moment they are free.  There is no coalescing wait at all — batching
emerges from concurrency: while every slot is busy, arrivals accumulate
and the next freed slot takes them as one batch.  Under light load a
request's forward dispatches immediately (batch of 1, the smallest
bucket); under saturation batches fill to ``max_batch`` with zero timer
latency.  A freed slot REFILLS from the queue without draining anything
— the continuous-batching admission loop of the TPU serving literature
(PAPERS.md: Gemma-on-TPU serving), applied to fixed-size tile requests.

Priority classes
----------------

Every payload carries a class: ``interactive`` (latency-sensitive scene
requests) or ``batch`` (bulk tiling work that wants throughput, not p99).
Each class has its own bounded admission queue — bulk work queues deeply
(``batch_queue_limit``) without consuming interactive admission, and
sheds independently.  Assembly order is interactive-first with a
starvation bound: every ``starvation_every``-th assembly seats at least
one batch-class item first, so an interactive flood cannot starve bulk
work forever (the bound is test-pinned).

The typed error contract, deadlines, drain semantics, and the
``forward``/``Future`` API are exactly the MicroBatcher's, so the
frontend swaps one for the other on a config knob
(``ServeConfig.batcher``).

The port's own copy of ``ddlpc_tpu/serve/cbatch.py`` (stdlib only), kept line for line
so the two read alike.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional, Sequence

from ddlpc_tpu_torch.analysis import lockcheck
from ddlpc_tpu_torch.serve.batching import (
    DeadlineExceeded,
    EngineClosed,
    Overloaded,
    _fail,
)

_NULL_CTX = nullcontext()

PRIORITIES = ("interactive", "batch")


def check_priority(priority: str) -> str:
    if priority not in PRIORITIES:
        raise ValueError(
            f"unknown priority class {priority!r} "
            f"(expected one of {PRIORITIES})"
        )
    return priority


class _Item:
    __slots__ = (
        "payload", "future", "enqueued", "deadline", "t_trace", "refill",
        "trace_id",
    )

    def __init__(
        self,
        payload,
        deadline: Optional[float],
        now: float,
        t_trace: float = 0.0,
        refill: bool = False,
        trace_id: Optional[str] = None,
    ):
        self.payload = payload
        self.future: Future = Future()
        self.enqueued = now
        self.deadline = deadline
        self.t_trace = t_trace
        # Request trace id captured on the SUBMITTING thread (the one
        # holding the tracer binding) — batch spans execute on a worker
        # thread and name every request trace they served via this.
        self.trace_id = trace_id
        # True when this item arrived while a forward was executing: the
        # assembly that takes it is a pipeline REFILL (work admitted
        # without waiting for the previous batch's world to drain) — the
        # property the continuous-batching tests pin.
        self.refill = refill


@lockcheck.guarded
class ContinuousBatcher:
    """Slot-based continuous batcher with priority classes.

    ``forward(list_of_payloads) -> sequence_of_results`` runs on a slot
    thread; it must be thread-safe for ``slots > 1`` (the engine's
    ``forward_windows`` is — state snapshot + locked jit cache).

    Shared state is guarded by ``_cond`` (``# guarded-by:`` annotations
    enforced under ``DDLPC_LOCKCHECK=1`` — docs/ANALYSIS.md).
    """

    def __init__(
        self,
        forward: Callable[[List], Sequence],
        max_batch: int = 8,
        queue_limit: int = 64,
        batch_queue_limit: int = 256,
        slots: int = 2,
        starvation_every: int = 4,
        metrics=None,
        tracer=None,
        start: bool = True,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        if batch_queue_limit < 1:
            raise ValueError(
                f"batch_queue_limit must be >= 1, got {batch_queue_limit}"
            )
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self._forward = forward
        self.max_batch = int(max_batch)
        self.queue_limit = int(queue_limit)
        self.batch_queue_limit = int(batch_queue_limit)
        self.slots = int(slots)
        self.starvation_every = max(1, int(starvation_every))
        self.metrics = metrics
        self.tracer = tracer
        self._cond = lockcheck.condition("ContinuousBatcher._cond")
        self._queues: Dict[str, deque] = {  # guarded-by: _cond
            "interactive": deque(),
            "batch": deque(),
        }
        self._closing = False  # guarded-by: _cond
        self._busy = 0  # slots currently inside forward  # guarded-by: _cond
        self._assemblies = 0  # guarded-by: _cond
        # batched forward calls issued (read cross-thread by tests/
        # metrics/the frontend's profiler — locked like the queue)
        self.forward_count = 0  # guarded-by: _cond
        # assemblies that seated at least one item enqueued while a
        # forward was in flight: the pipeline stayed hot instead of
        # draining (the continuous-batching property, test-pinned)
        self.refills = 0  # guarded-by: _cond
        # Per-slot utilization accounting: cumulative
        # busy seconds per slot + the in-flight forward's start, read out
        # windowed by slot_busy_fractions() so sizing `slots` stops being
        # guesswork (published as ddlpc_serve_slot_busy_fraction{slot}).
        now0 = time.monotonic()
        self._slot_busy_s = [0.0] * self.slots  # guarded-by: _cond
        self._slot_t0: List[Optional[float]] = (
            [None] * self.slots
        )  # guarded-by: _cond
        self._slot_mark = [(now0, 0.0)] * self.slots  # guarded-by: _cond
        self._threads: List[threading.Thread] = []
        self._started = False
        if start:
            self.start()

    # ---- admission ---------------------------------------------------------

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        for i in range(self.slots):
            t = threading.Thread(
                target=self._run, args=(i,), name=f"serve-cbatch-{i}",
                daemon=True,
            )
            self._threads.append(t)
            t.start()

    def submit(
        self,
        payload,
        deadline_ms: Optional[float] = None,
        priority: str = "interactive",
    ) -> Future:
        """Enqueue one payload; raises typed :class:`Overloaded` /
        :class:`EngineClosed` instead of blocking, like the MicroBatcher."""
        return self.submit_many(
            [payload], deadline_ms=deadline_ms, priority=priority
        )[0]

    def submit_many(
        self,
        payloads: Sequence,
        deadline_ms: Optional[float] = None,
        priority: str = "interactive",
    ) -> List[Future]:
        """All-or-nothing admission into one priority class's queue."""
        check_priority(priority)
        if not payloads:
            return []
        now = time.monotonic()
        deadline = None if not deadline_ms else now + deadline_ms / 1000.0
        limit = (
            self.queue_limit
            if priority == "interactive"
            else self.batch_queue_limit
        )
        with self._cond:
            if self._closing:
                raise EngineClosed("batcher is draining; not accepting work")
            q = self._queues[priority]
            if len(q) + len(payloads) > limit:
                if self.metrics is not None:
                    self.metrics.record_shed(len(payloads), priority=priority)
                raise Overloaded(
                    f"{priority} queue full ({len(q)}/{limit} + "
                    f"{len(payloads)} new); retry with backoff"
                )
            t_trace = 0.0
            trace_id = None
            if self.tracer is not None and self.tracer.enabled:
                t_trace = self.tracer.now()
                trace_id = self.tracer.current_trace_id()
            refill = self._busy > 0
            items = [
                _Item(p, deadline, now, t_trace, refill, trace_id)
                for p in payloads
            ]
            q.extend(items)
            self._publish_depths_locked()
            self._cond.notify_all()
        return [it.future for it in items]

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return sum(len(q) for q in self._queues.values())

    def queue_depths(self) -> Dict[str, int]:
        """Per-priority-class queue depths — what ``/healthz`` carries so
        the router's one-scrape contract covers priority-aware dispatch."""
        with self._cond:
            return {p: len(q) for p, q in self._queues.items()}

    def _publish_depths_locked(self) -> None:
        if self.metrics is None:
            return
        depths = {p: len(q) for p, q in self._queues.items()}
        self.metrics.set_queue_depth(sum(depths.values()))
        set_prio = getattr(self.metrics, "set_priority_queue_depth", None)
        if set_prio is not None:
            set_prio(depths)

    # ---- slot workers ------------------------------------------------------

    def _assemble_locked(self) -> List[_Item]:
        """Take up to ``max_batch`` items: interactive first, then batch —
        except every ``starvation_every``-th assembly, which seats one
        batch-class item FIRST (the starvation bound)."""
        self._assemblies += 1
        order = ["interactive", "batch"]
        batch: List[_Item] = []
        if (
            self._assemblies % self.starvation_every == 0
            and self._queues["batch"]
        ):
            batch.append(self._queues["batch"].popleft())
        for p in order:
            q = self._queues[p]
            while q and len(batch) < self.max_batch:
                batch.append(q.popleft())
        return batch

    def _take_batch(self) -> Optional[List[_Item]]:
        """Block until work exists (then take it IMMEDIATELY — no
        coalescing timer; batching emerges from busy slots) or the
        batcher is closed and drained (None)."""
        with self._cond:
            while not self._closing and not any(
                self._queues[p] for p in PRIORITIES
            ):
                self._cond.wait(0.05)
            if not any(self._queues[p] for p in PRIORITIES):
                return None  # closing and drained
            batch = self._assemble_locked()
            if any(it.refill for it in batch):
                self.refills += 1
            self._busy += 1
            self._publish_depths_locked()
            return batch

    def _run(self, slot: int) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            t0 = time.monotonic()
            with self._cond:
                self._slot_t0[slot] = t0
            try:
                self._execute(batch)
            finally:
                with self._cond:
                    self._busy -= 1
                    self._slot_busy_s[slot] += time.monotonic() - t0
                    self._slot_t0[slot] = None

    def slot_busy_fractions(self) -> Dict[int, float]:
        """Per-slot busy fraction since the PREVIOUS readout (an in-flight
        forward counts up to now).  The caller's cadence defines the
        window — the frontend's metrics emitter reads this every
        ``metrics_every_s`` and publishes
        ``ddlpc_serve_slot_busy_fraction{slot}``."""
        now = time.monotonic()
        out: Dict[int, float] = {}
        with self._cond:
            for i in range(self.slots):
                busy = self._slot_busy_s[i]
                if self._slot_t0[i] is not None:
                    busy += now - self._slot_t0[i]
                last_t, last_busy = self._slot_mark[i]
                dt = max(now - last_t, 1e-9)
                out[i] = min(max((busy - last_busy) / dt, 0.0), 1.0)
                self._slot_mark[i] = (now, busy)
        return out

    def _execute(self, batch: List[_Item]) -> None:
        now = time.monotonic()
        live: List[_Item] = []
        for it in batch:
            if it.deadline is not None and now > it.deadline:
                if self.metrics is not None:
                    self.metrics.record_deadline()
                _fail(
                    it.future,
                    DeadlineExceeded(
                        f"queued {now - it.enqueued:.3f}s, past deadline"
                    ),
                )
            elif not it.future.set_running_or_notify_cancel():
                continue  # client cancelled while queued
            else:
                live.append(it)
        if not live:
            return
        with self._cond:
            self.forward_count += 1
        tracer = self.tracer
        # The request trace ids this batch serves (flat list of scalars —
        # schema-legal): how obs/merge.py attributes worker-thread batch
        # spans to the cross-process request timelines they belong to.
        tids = sorted({it.trace_id for it in live if it.trace_id})
        if tracer is not None and tracer.enabled:
            tracer.add_span(
                "batch_coalesce",
                live[0].t_trace,
                tracer.now(),
                batch=len(live),
                **({"trace_ids": tids} if tids else {}),
            )
        span = (
            tracer.span(
                "jit_execute", batch=len(live),
                **({"trace_ids": tids} if tids else {}),
            )
            if tracer is not None
            else _NULL_CTX
        )
        try:
            with span:
                results = list(self._forward([it.payload for it in live]))
            if len(results) != len(live):
                raise RuntimeError(
                    f"forward returned {len(results)} results for "
                    f"{len(live)} payloads"
                )
        except Exception as e:  # fail the batch, keep serving
            for it in live:
                _fail(it.future, e)
            return
        for it, res in zip(live, results):
            it.future.set_result(res)
        if self.metrics is not None:
            self.metrics.record_batch(len(live), self.max_batch)

    # ---- shutdown ----------------------------------------------------------

    def close(self, drain: bool = True, timeout: Optional[float] = 30.0) -> None:
        """Stop admission; drain (default) or abandon the queues; join."""
        if drain and not self._started:
            self.start()  # a deferred-start batcher still owes a drain
        with self._cond:
            self._closing = True
            if not drain:
                for q in self._queues.values():
                    while q:
                        _fail(
                            q.popleft().future,
                            EngineClosed("batcher closed without drain"),
                        )
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout)

    def __enter__(self) -> "ContinuousBatcher":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=True)
