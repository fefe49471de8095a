"""Span-based tracing with JSONL and Chrome-trace-event exporters.

A :class:`Tracer` names a run (one trace id); a :class:`Span` names a timed
phase within it (data wait, step dispatch, loader gather, serve coalesce,
jit execute, ...).  Spans nest per thread — the parent id comes from a
thread-local stack — and cross-thread phases whose start and end are
observed on different threads (the serve batcher's enqueue→coalesce wait)
are recorded with the explicit :meth:`Tracer.add_span`.

Two exporters, both always on when the tracer is enabled:

- **JSONL**: one flat record per span appended to ``jsonl_path`` as the
  span closes — the same stream shape as ``metrics.jsonl`` (schema-stamped,
  one flat JSON object per line) so ``scripts/obs_tail.py`` tails spans and
  metrics with the same code;
- **Chrome trace events**: complete ("ph": "X") events buffered in memory
  and written by :meth:`flush`/:meth:`close` as a ``trace.json`` loadable
  directly in Perfetto / chrome://tracing.  Buffering is bounded at
  ``max_events``; overflow increments ``dropped_events`` instead of growing
  without bound on a week-long run (the JSONL stream is the durable
  record).

Overhead discipline (the tentpole bar: ~0 disabled, ≤2% of step time
enabled — measured numbers in docs/OBSERVABILITY.md):

- disabled, ``span()`` returns a shared no-op context manager after one
  attribute test — no allocation, no clock read, no lock;
- enabled, a span costs two ``perf_counter`` reads, one dict/list append
  under the lock, and one buffered file write.

Cross-process trace context (the fleet router's): a request's
identity is a W3C-style pair — a 32-hex ``trace_id`` plus a 16-hex span
id — carried between processes on the ``traceparent`` HTTP header
(``00-<trace_id>-<span_id>-01``).  :meth:`Tracer.bind` installs a
(trace_id, remote parent) pair on the CURRENT THREAD; every span recorded
under the binding stamps that ``trace_id`` into its JSONL record instead
of the tracer's own run id, and a binding's ROOT spans (no local parent)
additionally record ``remote_parent`` — the hex span id of the upstream
process's span — so ``obs/merge.py`` can stitch the per-process streams
into one fleet timeline.

The port's own copy of ``ddlpc_tpu/obs/tracing.py`` (stdlib only), kept line for line
so the two read alike.
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
import uuid
from contextlib import contextmanager, nullcontext
from typing import List, Optional, Tuple

from ddlpc_tpu_torch.analysis import lockcheck
from ddlpc_tpu_torch.obs.schema import SCHEMA_VERSION

# -- cross-process trace context (W3C traceparent shape) ---------------------

TRACEPARENT_HEADER = "traceparent"

_NULL_BIND = nullcontext()


def new_trace_id() -> str:
    """32 lowercase hex chars — one per REQUEST, shared across processes."""
    return uuid.uuid4().hex


def new_span_hex() -> str:
    """16 lowercase hex chars — a globally-unique span id for spans that
    must be referenced from ANOTHER process (the router's attempt spans)."""
    return uuid.uuid4().hex[:16]


def format_traceparent(trace_id: str, span_hex: str) -> str:
    """``00-<trace_id>-<span_id>-01`` (version 00, sampled flag)."""
    return f"00-{trace_id}-{span_hex}-01"


_HEX_DIGITS = frozenset("0123456789abcdef")


def _is_hex(s: str, n: int) -> bool:
    # Explicit charset, not int(s, 16): the W3C shape is LOWERCASE hex,
    # and int() would wave through '+'/'_'-decorated strings.
    return len(s) == n and all(c in _HEX_DIGITS for c in s)


def parse_traceparent(value: Optional[str]) -> Optional[Tuple[str, str]]:
    """(trace_id, parent span hex) from a ``traceparent`` header, or None
    for anything malformed — a bad header must degrade to a fresh local
    trace, never into a request error."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) != 4:
        return None
    _, trace_id, span_hex, _ = parts
    if not _is_hex(trace_id, 32) or not _is_hex(span_hex, 16):
        return None
    if trace_id == "0" * 32 or span_hex == "0" * 16:
        return None
    return trace_id, span_hex


class _NullSpan:
    """Shared no-op stand-in returned by a disabled tracer.  A singleton:
    ``tracer.span(...)`` on a disabled tracer allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One timed, named phase.  Use as a context manager; ``set(**attrs)``
    attaches attributes (flat scalars) any time before exit."""

    __slots__ = ("_tracer", "name", "attrs", "span_id", "parent_id", "_t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.span_id = 0
        self.parent_id = 0
        self._t0 = 0.0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        tr = self._tracer
        stack = tr._stack()
        self.parent_id = stack[-1] if stack else 0
        self.span_id = tr._next_id()
        stack.append(self.span_id)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        stack = self._tracer._stack()
        if stack and stack[-1] == self.span_id:
            stack.pop()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._tracer._record(
            self.name,
            self._t0,
            t1,
            self.span_id,
            self.parent_id,
            threading.get_ident(),
            self.attrs,
        )
        return False


@lockcheck.guarded
class Tracer:
    """Trace/span-id issuing clock + exporters; thread-safe throughout.

    ``enabled=False`` (the default) makes every public method a near-free
    no-op — construct one unconditionally and let config decide.
    """

    def __init__(
        self,
        enabled: bool = False,
        service: str = "train",
        jsonl_path: Optional[str] = None,
        chrome_path: Optional[str] = None,
        max_events: int = 200_000,
    ):
        self.enabled = bool(enabled)
        self.service = service
        self.jsonl_path = jsonl_path
        self.chrome_path = chrome_path
        self.dropped_events = 0  # guarded-by: _lock
        if not self.enabled:
            return
        self.trace_id = uuid.uuid4().hex[:16]
        self.max_events = int(max_events)
        self._lock = lockcheck.lock("Tracer._lock")
        self._id = 0  # guarded-by: _lock
        self._pid = os.getpid()
        self._tls = threading.local()
        self._events: list = []  # guarded-by: _lock
        self._thread_names: dict = {}  # guarded-by: _lock
        # perf_counter is the span clock (monotonic, ns resolution); the
        # wall-clock anchor converts span starts to epoch seconds for the
        # JSONL stream so spans and metrics sort on one time axis.
        self._t0 = time.perf_counter()
        self._epoch0 = time.time() - self._t0
        self._jsonl: Optional[io.TextIOBase] = None  # guarded-by: _lock
        self._jsonl_flushed = self._t0  # guarded-by: _lock
        if jsonl_path is not None:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._jsonl = open(jsonl_path, "a")

    # -- span API ----------------------------------------------------------

    def span(self, name: str, **attrs):
        """Context manager timing a phase on the current thread."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, attrs)

    def add_span(
        self, name: str, start: float, end: float, **attrs
    ) -> None:
        """Record a phase whose start was observed on another thread (times
        from :meth:`now`).  No implicit parent — cross-thread spans are
        roots on their recording thread."""
        if not self.enabled:
            return
        self._record(
            name, start, end, self._next_id(), 0, threading.get_ident(), attrs
        )

    def now(self) -> float:
        """The tracer's clock (pair with :meth:`add_span`)."""
        return time.perf_counter() if self.enabled else 0.0

    # -- cross-process trace context ---------------------------------------

    def bind(self, trace_id: Optional[str], parent_hex: Optional[str] = None):
        """Context manager installing a request's cross-process identity on
        the CURRENT THREAD: spans recorded inside stamp ``trace_id`` into
        their JSONL records, and root spans (no local parent) record
        ``remote_parent=parent_hex`` — how a replica's ``serve_request``
        points back at the router attempt that dispatched it.  No-op when
        disabled or ``trace_id`` is None (a request with no/invalid
        ``traceparent`` keeps the tracer's own run id)."""
        if not self.enabled or trace_id is None:
            return _NULL_BIND
        return self._bind_ctx(trace_id, parent_hex)

    @contextmanager
    def _bind_ctx(self, trace_id: str, parent_hex: Optional[str]):
        prev = getattr(self._tls, "ctx", None)
        self._tls.ctx = (trace_id, parent_hex)
        try:
            yield self
        finally:
            self._tls.ctx = prev

    def current_trace_id(self) -> Optional[str]:
        """The bound request trace id on this thread, or None.  The
        batchers capture it at submit so batch spans executed on a worker
        thread can name every request trace they served."""
        if not self.enabled:
            return None
        ctx = getattr(self._tls, "ctx", None)
        return ctx[0] if ctx is not None else None

    # -- internals ---------------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _next_id(self) -> int:
        with self._lock:
            self._id += 1
            return self._id

    def _record(
        self,
        name: str,
        t0: float,
        t1: float,
        span_id: int,
        parent_id: int,
        tid: int,
        attrs: dict,
    ) -> None:
        flat = {}
        for k, v in attrs.items():
            if isinstance(v, (str, int, float, bool, type(None))):
                flat[k] = v
            elif isinstance(v, (list, tuple)) and all(
                isinstance(x, (str, int, float, bool, type(None))) for x in v
            ):
                # Lists of scalars are schema-legal (check_record) — the
                # batchers' trace_ids attribute rides through as-is.
                flat[k] = list(v)
            else:
                flat[k] = str(v)
        line = None
        if self._jsonl is not None:
            # A thread bound to a request's cross-process context stamps
            # the REQUEST trace id (and, on root spans, the remote parent)
            # instead of the tracer's run id — the field obs/merge.py
            # groups on.  ctx belongs to the RECORDING thread: add_span
            # callers (batcher workers) carry request identity via attrs.
            ctx = getattr(self._tls, "ctx", None)
            rec = {
                "schema": SCHEMA_VERSION,
                "kind": "span",
                "service": self.service,
                "trace_id": ctx[0] if ctx is not None else self.trace_id,
                "span_id": span_id,
                "parent_id": parent_id,
                "name": name,
                "time": round(self._epoch0 + t0, 6),
                "dur_s": round(t1 - t0, 9),
                "pid": self._pid,
                "tid": tid,
                **flat,
            }
            if ctx is not None and parent_id == 0 and ctx[1]:
                rec["remote_parent"] = ctx[1]
            line = json.dumps(rec) + "\n"
        ev = {
            "name": name,
            "ph": "X",
            "ts": (t0 - self._t0) * 1e6,  # microseconds, trace-relative
            "dur": max((t1 - t0) * 1e6, 0.0),
            # cached: getpid() is a real syscall (~17 us under gVisor) and
            # this is the per-span hot path
            "pid": self._pid,
            "tid": tid,
        }
        if flat:
            ev["args"] = flat
        with self._lock:
            if len(self._events) < self.max_events:
                self._events.append(ev)
            else:
                self.dropped_events += 1
            if tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name
            # Re-check under the lock: close() nulls _jsonl while in-flight
            # request threads may still be exiting spans (the serve
            # frontend stops admission before the tracer, but queued work
            # finishes after).
            if line is not None and self._jsonl is not None:
                self._jsonl.write(line)
                # Flush at most every 0.25 s: live enough for obs_tail -f,
                # without one fsync-ish syscall per span on the hot path
                # (per-span flush measured ~2.5% of a 41 ms CPU step).
                if t1 - self._jsonl_flushed > 0.25:
                    self._jsonl.flush()
                    self._jsonl_flushed = t1

    # -- exporters ---------------------------------------------------------

    def chrome_events(self) -> List[dict]:
        """The buffered Chrome events plus process/thread metadata."""
        if not self.enabled:
            return []
        with self._lock:
            events = list(self._events)
            names = dict(self._thread_names)
        pid = self._pid  # must match the per-event pid (cached at init)
        meta = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "args": {"name": f"ddlpc_{self.service}"},
            }
        ]
        for tid, tname in sorted(names.items()):
            meta.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": tname},
                }
            )
        return meta + events

    def flush(self, chrome_path: Optional[str] = None) -> Optional[str]:
        """Write the Chrome trace (``{"traceEvents": [...]}``) and flush the
        JSONL stream.  Safe to call repeatedly (each call rewrites the whole
        file — span volume is bounded by ``max_events``).  Returns the path
        written, or None when disabled / no path configured."""
        if not self.enabled:
            return None
        with self._lock:
            if self._jsonl is not None:
                self._jsonl.flush()
        path = chrome_path or self.chrome_path
        if path is None:
            return None
        doc = {
            "traceEvents": self.chrome_events(),
            "displayTimeUnit": "ms",
            "metadata": {
                "service": self.service,
                "trace_id": self.trace_id,
                "dropped_events": self.dropped_events,
            },
        }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        # Rename-atomic, not fsynced: flush() runs on live cadences and a
        # trace is diagnostics, not state — readers never see a torn
        # trace.json, and that is the whole contract here.
        os.replace(tmp, path)
        return path

    def close(self) -> None:
        if not self.enabled:
            return
        self.flush()
        with self._lock:
            if self._jsonl is not None:
                self._jsonl.close()
                self._jsonl = None
