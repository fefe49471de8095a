"""Dynamic micro-batcher: bounded queue, coalescing, deadlines, shedding.

The serving equivalent of the train loop's gradient-accumulation window:
individual requests (one fixed-size tile each) queue up, a single worker
thread coalesces up to ``max_batch`` of them or waits at most
``max_wait_ms`` from the oldest entry — whichever comes first — and runs ONE
forward for the whole batch.  Under light load a request pays at most
``max_wait_ms`` of coalescing latency; under heavy load batches fill
instantly and the wait never triggers.

Backpressure is explicit and typed, never implicit and unbounded:

- admission control: the queue is bounded at ``queue_limit``; a submit that
  would exceed it raises :class:`Overloaded` immediately (load-shedding —
  the client gets a fast typed "retry later", not a slow request);
- per-request deadlines: a request that is still queued past its deadline
  completes with :class:`DeadlineExceeded` instead of occupying a batch
  slot it can no longer use;
- graceful drain: ``close(drain=True)`` stops admission, lets the worker
  finish everything already queued, then joins — in-flight work is never
  dropped on shutdown.

The port's own copy of ``ddlpc_tpu/serve/batching.py`` (stdlib only), kept line for line
so the two read alike.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from contextlib import nullcontext
from typing import Callable, List, Optional, Sequence

from ddlpc_tpu_torch.analysis import lockcheck

_NULL_CTX = nullcontext()


class Overloaded(RuntimeError):
    """Admission queue full — request shed; retry with backoff."""


class DeadlineExceeded(RuntimeError):
    """Request expired in queue before a batch slot reached it."""


class EngineClosed(RuntimeError):
    """Batcher is shutting down; no new work accepted."""


class _Item:
    __slots__ = ("payload", "future", "enqueued", "deadline", "t_trace",
                 "trace_id")

    def __init__(
        self, payload, deadline: Optional[float], now: float,
        t_trace: float = 0.0, trace_id: Optional[str] = None,
    ):
        self.payload = payload
        self.future: Future = Future()
        self.enqueued = now
        self.deadline = deadline
        # Enqueue time on the tracer's clock (tracing enabled only): the
        # worker records the cross-thread enqueue→batch-take wait with it.
        self.t_trace = t_trace
        # Request trace id captured on the submitting thread (the one
        # holding the tracer binding) — worker-thread batch spans name
        # the request traces they serve via this (obs/merge.py).
        self.trace_id = trace_id


def _fail(future: Future, exc: Exception) -> None:
    """set_exception tolerating a concurrent client cancel().

    A PENDING future can be cancelled by its client between any
    ``cancelled()`` check and the ``set_exception`` call (check-then-act
    race); the resulting InvalidStateError must never kill the worker
    thread — a cancelled future needs no completion anyway."""
    try:
        future.set_exception(exc)
    except Exception:
        pass


@lockcheck.guarded
class MicroBatcher:
    """Coalesce submitted payloads into batched ``forward`` calls.

    ``forward(list_of_payloads) -> sequence_of_results`` runs on the worker
    thread; result ``i`` resolves the future of payload ``i``.  A forward
    exception fails every request in that batch (the typed errors above
    never reach ``forward``).

    Shared state is guarded by ``_cond`` (``# guarded-by:`` annotations
    below are enforced under ``DDLPC_LOCKCHECK=1`` — docs/ANALYSIS.md).
    """

    def __init__(
        self,
        forward: Callable[[List], Sequence],
        max_batch: int = 8,
        max_wait_ms: float = 5.0,
        queue_limit: int = 64,
        metrics=None,
        tracer=None,
        start: bool = True,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        self._forward = forward
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.queue_limit = int(queue_limit)
        self.metrics = metrics
        # Optional span tracer (obs/tracing.py): the worker records one
        # cross-thread ``batch_coalesce`` span per batch (oldest member's
        # enqueue → batch take) and a ``jit_execute`` span around forward.
        self.tracer = tracer
        self._q: deque = deque()  # guarded-by: _cond
        self._cond = lockcheck.condition("MicroBatcher._cond")
        self._closing = False  # guarded-by: _cond
        # batched forward calls issued (read by tests/metrics/chaos hooks
        # from other threads, so the increment holds the lock too)
        self.forward_count = 0  # guarded-by: _cond
        self._thread = threading.Thread(
            target=self._run, name="serve-batcher", daemon=True
        )
        self._started = False
        if start:
            self.start()

    # ---- admission ---------------------------------------------------------

    def start(self) -> None:
        if not self._started:
            self._started = True
            self._thread.start()

    def submit(self, payload, deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one payload; returns its Future.

        Raises :class:`Overloaded` (queue full) or :class:`EngineClosed`
        (draining/closed) instead of blocking — admission never waits.
        """
        return self.submit_many([payload], deadline_ms=deadline_ms)[0]

    def submit_many(
        self, payloads: Sequence, deadline_ms: Optional[float] = None
    ) -> List[Future]:
        """All-or-nothing admission for a multi-tile request.

        A scene that tiles into k windows either gets all k queue slots or
        is shed whole — partial admission would burn forward capacity on
        windows whose request can no longer complete.
        """
        if not payloads:
            return []
        now = time.monotonic()
        deadline = None if not deadline_ms else now + deadline_ms / 1000.0
        with self._cond:
            if self._closing:
                raise EngineClosed("batcher is draining; not accepting work")
            if len(self._q) + len(payloads) > self.queue_limit:
                if self.metrics is not None:
                    self.metrics.record_shed(len(payloads))
                raise Overloaded(
                    f"queue full ({len(self._q)}/{self.queue_limit} + "
                    f"{len(payloads)} new); retry with backoff"
                )
            t_trace = 0.0
            trace_id = None
            if self.tracer is not None and self.tracer.enabled:
                t_trace = self.tracer.now()
                trace_id = self.tracer.current_trace_id()
            items = [
                _Item(p, deadline, now, t_trace, trace_id) for p in payloads
            ]
            self._q.extend(items)
            if self.metrics is not None:
                self.metrics.set_queue_depth(len(self._q))
            self._cond.notify_all()
        return [it.future for it in items]

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._q)

    # ---- worker ------------------------------------------------------------

    def _take_batch(self) -> Optional[List[_Item]]:
        """Block until a batch is ready (full, aged past max_wait, or
        draining) or the batcher is closed and empty (returns None)."""
        with self._cond:
            while not self._q and not self._closing:
                self._cond.wait(0.05)
            if not self._q:
                return None  # closing and drained
            # Coalesce: wait for a full batch, but never hold the OLDEST
            # request past max_wait.  Draining flushes immediately.
            target = self._q[0].enqueued + self.max_wait_s
            while len(self._q) < self.max_batch and not self._closing:
                remaining = target - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            batch = [
                self._q.popleft()
                for _ in range(min(self.max_batch, len(self._q)))
            ]
            if self.metrics is not None:
                self.metrics.set_queue_depth(len(self._q))
            return batch

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
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
                    # Client cancelled while queued (e.g. a sibling window
                    # of its scene already failed) — don't burn a slot.
                    continue
                else:
                    live.append(it)
            if not live:
                continue
            with self._cond:
                self.forward_count += 1
            tracer = self.tracer
            tids = sorted({it.trace_id for it in live if it.trace_id})
            if tracer is not None and tracer.enabled:
                # Cross-thread coalesce wait: the oldest live member's
                # enqueue (client thread) → this batch take (worker).
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
                    # A short/long result list would otherwise leave some
                    # futures unresolved FOREVER — turn the contract breach
                    # into a typed batch failure instead of a silent hang.
                    raise RuntimeError(
                        f"forward returned {len(results)} results for "
                        f"{len(live)} payloads"
                    )
            except Exception as e:  # fail the batch, keep serving
                for it in live:
                    _fail(it.future, e)
                continue
            for it, res in zip(live, results):
                it.future.set_result(res)
            # Latency is recorded per REQUEST by the frontend (a scene is
            # one request, many tiles); the batcher owns batch-shape stats.
            if self.metrics is not None:
                self.metrics.record_batch(len(live), self.max_batch)

    # ---- shutdown ----------------------------------------------------------

    def close(self, drain: bool = True, timeout: Optional[float] = 30.0) -> None:
        """Stop admission; drain (default) or abandon the queue; join.

        With ``drain=False`` queued requests fail with :class:`EngineClosed`
        — still a typed completion, never a hang.
        """
        if drain and not self._started:
            # A deferred-start batcher (tests) still owes its queue a drain.
            self.start()
        with self._cond:
            self._closing = True
            if not drain:
                while self._q:
                    it = self._q.popleft()
                    _fail(
                        it.future, EngineClosed("batcher closed without drain")
                    )
            self._cond.notify_all()
        if self._started:
            self._thread.join(timeout)

    def __enter__(self) -> "MicroBatcher":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=True)
