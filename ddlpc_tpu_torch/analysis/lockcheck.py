"""Lock-order race detector: instrumented locks + ``# guarded-by:`` checks.

Two dynamic invariants, enforced while real threaded code runs (the
existing MicroBatcher / Tracer / StageTimer / router tests, or the bounded
smoke in :mod:`lock_fixtures`):

1. **Lock order** — every acquisition taken while other instrumented locks
   are held records an edge ``held → acquired`` (by lock *name*, so two
   MicroBatcher instances share a node).  A cycle in that graph is a
   lock-order inversion: two threads CAN deadlock even if this run did
   not.  ``cycles()`` finds them; ``scripts/ddlpc_check.py`` fails on any.

2. **Guarded attributes** — classes decorated with :func:`guarded` may
   annotate attribute assignments ``self._q = deque()  # guarded-by:
   _cond``.  While enabled, any post-``__init__`` rebind of an annotated
   attribute — or any mutation of an annotated dict/list/deque through the
   installed proxy — without the named lock held by the current thread is
   recorded as a violation.  ``# guarded-by: <owner-thread>`` instead pins
   the attribute to one mutating thread (single-writer hand-off designs
   like AsyncCheckpointer, where the barrier — not a lock — is the fence).

Cost when disabled (the default): the factories return plain ``threading``
primitives, and :func:`guarded`'s injected ``__setattr__`` is one global
flag test — no source inspection, no proxies, no graph.  Enable with
``DDLPC_LOCKCHECK=1`` in the environment (before the instrumented classes
are *instantiated*) or :func:`enable` in tests.

The port's own copy of ``ddlpc_tpu/analysis/lockcheck.py`` (stdlib only), kept line for line
so the two read alike.
"""

from __future__ import annotations

import collections as _collections
import os
import re
import threading
import traceback
from typing import Dict, List, Optional, Tuple

__all__ = [
    "enable",
    "disable",
    "enabled",
    "reset",
    "lock",
    "rlock",
    "condition",
    "guarded",
    "OWNER_THREAD",
    "edges",
    "cycles",
    "guard_violations",
    "violations",
    "report",
]

OWNER_THREAD = "<owner-thread>"

_enabled = os.environ.get("DDLPC_LOCKCHECK", "") not in ("", "0")

# Global acquisition-graph + violation state, guarded by _STATE_LOCK
# (a plain threading.Lock — the detector must not instrument itself).
_STATE_LOCK = threading.Lock()
_edges: Dict[Tuple[str, str], str] = {}  # (held_name, acquired_name) -> site
_guard_violations: List[str] = []
_owner_threads: Dict[Tuple[int, str], int] = {}  # (id(obj), attr) -> tid
_tls = threading.local()


def enabled() -> bool:
    return _enabled


def enable() -> None:
    """Turn instrumentation on (construct instrumented objects AFTER)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Drop all recorded edges/violations (test isolation)."""
    with _STATE_LOCK:
        _edges.clear()
        _guard_violations.clear()
        _owner_threads.clear()


def _held() -> list:
    st = getattr(_tls, "held", None)
    if st is None:
        st = _tls.held = []
    return st


def _site() -> str:
    # The caller of acquire(): skip this helper, _note_acquire, and the
    # acquire wrapper itself.
    for frame in reversed(traceback.extract_stack(limit=8)[:-3]):
        if os.path.basename(frame.filename) != "lockcheck.py":
            return f"{frame.filename}:{frame.lineno}"
    return "?"


def _note_acquire(lk: "_InstrumentedBase") -> None:
    st = _held()
    first = all(h is not lk for h in st)
    if first:
        new_pairs = [
            (h.name, lk.name)
            for h in st
            if h.name != lk.name and (h.name, lk.name) not in _edges
        ]
        if new_pairs:
            site = _site()
            with _STATE_LOCK:
                for pair in new_pairs:
                    _edges.setdefault(pair, site)
    st.append(lk)


def _note_release(lk: "_InstrumentedBase") -> None:
    st = _held()
    for i in range(len(st) - 1, -1, -1):
        if st[i] is lk:
            del st[i]
            return


class _InstrumentedBase:
    """Common acquire/release bookkeeping over an inner primitive."""

    def __init__(self, name: str, inner):
        self.name = name
        self._inner = inner

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            _note_acquire(self)
        return got

    def release(self) -> None:
        self._inner.release()
        _note_release(self)

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    def locked_by_current_thread(self) -> bool:
        return any(h is self for h in _held())

    # threading.Condition protocol --------------------------------------
    def _is_owned(self) -> bool:
        return self.locked_by_current_thread()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class InstrumentedLock(_InstrumentedBase):
    def __init__(self, name: str):
        super().__init__(name, threading.Lock())


class InstrumentedRLock(_InstrumentedBase):
    def __init__(self, name: str):
        super().__init__(name, threading.RLock())

    # Condition.wait() fully releases a reentrant lock and restores its
    # depth afterwards; mirror that in the held stack so attribute checks
    # during the wait correctly see the lock NOT held.
    def _release_save(self):
        state = self._inner._release_save()
        st = _held()
        _tls_count = sum(1 for h in st if h is self)
        for i in range(len(st) - 1, -1, -1):
            if st[i] is self:
                del st[i]
        return (state, _tls_count)

    def _acquire_restore(self, saved) -> None:
        state, count = saved
        self._inner._acquire_restore(state)
        st = _held()
        st.extend([self] * max(count, 1))

    def _is_owned(self) -> bool:
        return self._inner._is_owned()


def lock(name: str):
    """A ``threading.Lock`` — instrumented when lockcheck is enabled."""
    return InstrumentedLock(name) if _enabled else threading.Lock()


def rlock(name: str):
    return InstrumentedRLock(name) if _enabled else threading.RLock()


def condition(name: Optional[str] = None, lock=None):
    """A ``threading.Condition`` over an instrumented (R)Lock.

    Pass ``lock=`` to share an existing (instrumented) lock — the
    FleetRouter's ``_drain_cond`` waits on the router lock itself."""
    if lock is not None:
        return threading.Condition(lock)
    if not _enabled:
        return threading.Condition()
    return threading.Condition(InstrumentedRLock(name or "condition"))


# -- guarded attributes ------------------------------------------------------

_GUARD_RE = re.compile(
    r"self\.(\w+)\s*(?::[^=#\n]+)?=[^#\n]*#\s*guarded-by:\s*([\w<>-]+)"
)


def _guard_map(cls) -> Dict[str, str]:
    gm = cls.__dict__.get("_lc_guard_map")
    if gm is None:
        import inspect

        try:
            src = inspect.getsource(cls)
        except (OSError, TypeError):  # frozen/interactive: nothing to parse
            src = ""
        gm = {m.group(1): m.group(2) for m in _GUARD_RE.finditer(src)}
        cls._lc_guard_map = gm
    return gm


def _lock_of(obj, lockname: str):
    lk = getattr(obj, lockname, None)
    if isinstance(lk, threading.Condition):
        lk = lk._lock
    return lk if isinstance(lk, _InstrumentedBase) else None


def _record_guard_violation(msg: str) -> None:
    with _STATE_LOCK:
        if len(_guard_violations) < 200:  # bounded: a hot loop can't OOM us
            _guard_violations.append(msg)


def _check_guard(obj, attr: str, lockname: str, via: str) -> None:
    if lockname == OWNER_THREAD:
        tid = threading.get_ident()
        key = (id(obj), attr)
        with _STATE_LOCK:
            owner = _owner_threads.setdefault(key, tid)
        if owner != tid:
            _record_guard_violation(
                f"{type(obj).__name__}.{attr} {via} from thread "
                f"{threading.current_thread().name!r} but is owner-thread "
                f"confined (first mutated on tid {owner}) [{_site()}]"
            )
        return
    lk = _lock_of(obj, lockname)
    if lk is None:
        return  # lock not built yet, or not instrumented — nothing to prove
    if not lk._is_owned():
        _record_guard_violation(
            f"{type(obj).__name__}.{attr} {via} without {lockname} "
            f"({lk.name}) held [thread {threading.current_thread().name!r}, "
            f"{_site()}]"
        )


class _GuardedMutator:
    """Mixin: container ops that mutate check the guard first."""

    def _lc_bind(self, owner, attr: str, lockname: str):
        self._lc_owner = owner
        self._lc_attr = attr
        self._lc_lockname = lockname
        return self

    def _lc_check(self) -> None:
        owner = getattr(self, "_lc_owner", None)
        if owner is not None and _enabled and getattr(
            owner, "_lc_init_done", False
        ):
            _check_guard(owner, self._lc_attr, self._lc_lockname, "mutated")


class GuardedDict(dict, _GuardedMutator):
    pass


class GuardedList(list, _GuardedMutator):
    pass


class GuardedDeque(_collections.deque, _GuardedMutator):
    pass


def _install_mutators(cls, base, names) -> None:
    for name in names:
        base_fn = getattr(base, name)

        def op(self, *a, _fn=base_fn, **kw):
            self._lc_check()
            return _fn(self, *a, **kw)

        op.__name__ = name
        setattr(cls, name, op)


_install_mutators(
    GuardedDict, dict,
    ("__setitem__", "__delitem__", "pop", "popitem", "clear",
     "setdefault", "update"),
)
_install_mutators(
    GuardedList, list,
    ("__setitem__", "__delitem__", "append", "extend", "insert",
     "pop", "remove", "clear", "sort"),
)
_install_mutators(
    GuardedDeque, _collections.deque,
    ("__setitem__", "__delitem__", "append", "appendleft", "extend",
     "extendleft", "pop", "popleft", "remove", "clear"),
)

def _wrap_container(value, owner, attr: str, lockname: str):
    """Annotated dict/list/deque → checking proxy (exact types only; an
    already-wrapped or exotic container passes through unwrapped)."""
    t = type(value)
    if t is dict:
        return GuardedDict(value)._lc_bind(owner, attr, lockname)
    if t is list:
        return GuardedList(value)._lc_bind(owner, attr, lockname)
    if t is _collections.deque:
        # preserve maxlen — a bounded ring must stay bounded under check
        return GuardedDeque(value, value.maxlen)._lc_bind(
            owner, attr, lockname
        )
    return value


def guarded(cls):
    """Class decorator enforcing the class's ``# guarded-by:`` comments.

    Disabled: the injected ``__setattr__`` is one flag test on top of
    ``object.__setattr__`` (these classes assign attributes at
    construction and on cold paths, not per-item).  Enabled: annotated
    attribute rebinds are checked against the named lock, and annotated
    dict/list/deque values are replaced with checking proxies so item-level
    mutation (``self.totals[k] = ...``, ``self._q.popleft()``) is checked
    too.  ``__init__`` runs unchecked (single-threaded construction), like
    every guarded-by system's constructor exemption.
    """
    orig_init = cls.__init__
    orig_setattr = cls.__setattr__

    def __init__(self, *a, **kw):
        orig_init(self, *a, **kw)
        object.__setattr__(self, "_lc_init_done", True)

    def __setattr__(self, name, value):
        if _enabled:
            gm = _guard_map(type(self))
            lockname = gm.get(name)
            if lockname is not None:
                if lockname != OWNER_THREAD:
                    value = _wrap_container(value, self, name, lockname)
                if getattr(self, "_lc_init_done", False):
                    _check_guard(self, name, lockname, "rebound")
        orig_setattr(self, name, value)

    cls.__init__ = __init__
    cls.__setattr__ = __setattr__
    return cls


# -- reporting ---------------------------------------------------------------

def edges() -> Dict[Tuple[str, str], str]:
    with _STATE_LOCK:
        return dict(_edges)


def cycles() -> List[List[str]]:
    """Elementary cycles in the acquisition graph (lock-order inversions).

    Names are canonicalized so each cycle is reported once.  The graph is
    tiny (one node per lock *name*), so a DFS per node is plenty.
    """
    graph: Dict[str, List[str]] = {}
    for (a, b) in edges():
        graph.setdefault(a, []).append(b)
    found: List[List[str]] = []
    seen_keys = set()

    def dfs(start: str, node: str, path: List[str], visited: set) -> None:
        for nxt in graph.get(node, ()):
            if nxt == start:
                cyc = path[:]
                i = cyc.index(min(cyc))
                key = tuple(cyc[i:] + cyc[:i])
                if key not in seen_keys:
                    seen_keys.add(key)
                    found.append(list(key))
            elif nxt not in visited and nxt > start:
                # only explore names > start: each cycle found from its
                # smallest node exactly once
                visited.add(nxt)
                dfs(start, nxt, path + [nxt], visited)

    for n in sorted(graph):
        dfs(n, n, [n], {n})
    return found


def guard_violations() -> List[str]:
    with _STATE_LOCK:
        return list(_guard_violations)


def violations() -> List[str]:
    """Human-readable lock-order + guarded-by violations (empty = clean)."""
    out = []
    es = edges()
    for cyc in cycles():
        hops = []
        ring = cyc + [cyc[0]]
        for a, b in zip(ring, ring[1:]):
            hops.append(f"{a} -> {b} [{es.get((a, b), '?')}]")
        out.append("lock-order inversion: " + "; ".join(hops))
    out.extend(f"guarded-by: {v}" for v in guard_violations())
    return out


def report() -> dict:
    """Flat-ish summary for the analyzer's ``analysis`` record stream."""
    return {
        "edges": [f"{a} -> {b}" for (a, b) in sorted(edges())],
        "cycles": [" -> ".join(c) for c in cycles()],
        "guard_violations": guard_violations(),
    }
