"""Content-addressed response cache for the fleet router.

Repeated-scene traffic (the realistic heavy-traffic shape for aerial
imagery — the same survey tiles requested over and over) recomputes a
full forward pass per request even though the answer is a pure function
of (input bytes, serving checkpoint step, quantization mode).  This
module caches that function: the router hashes the request body together
with the fleet's serving step and quant mode, and answers repeats from
memory without touching a replica.

Design constraints, in order:

- **Correctness over hit rate.**  The serving step and quant mode are
  part of the key, so a stale entry can never answer for new weights
  even if invalidation were missed.  Invalidation (on any reload that
  changes the serving step, forward or rollback) exists to bound memory
  and keep the stats honest, not as the correctness mechanism.
- **Bounded by bytes, not entries.**  Tile responses are a few hundred
  KB of logits; an entry count says nothing about memory.  LRU eviction
  runs until the payload total is back under ``max_bytes``.
- **torch-free.**  Pure stdlib (hashlib / threading / OrderedDict) — the
  cache lives in the router process, which never imports torch.

Only 200 responses are cached: errors and shed responses are transient
routing outcomes, not values of the pure function above.

The port's own copy of ``ddlpc_tpu/serve/cache.py``; ``response_key`` is
byte-equal to the JAX package's, so a key names the same answer in both.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, Optional, Tuple

from ddlpc_tpu_torch.analysis import lockcheck

# (status, content_type, payload) — the router's Response triple.
Response = Tuple[int, str, bytes]


def response_key(
    body: bytes,
    step: int,
    quant_mode: str,
    lineage_id: Optional[str] = None,
) -> str:
    """Content address of a predict response.

    sha256 over the raw request bytes plus the serving identity
    (checkpoint step + quantization mode + lineage id when the fleet
    reports one).  Any component changing yields a different key, so
    mixed-step fleets mid-reload can simply decline to cache rather than
    risk cross-step answers — and two RUNS that happen to share a step
    number never share cache entries (the lineage id is per-save).
    ``lineage_id=None`` reproduces the pre-lineage key, so caches warm
    under old checkpoints stay valid across an upgrade.
    """
    h = hashlib.sha256()
    h.update(body)
    h.update(b"\x00step=%d" % int(step))
    h.update(b"\x00quant=" + quant_mode.encode("utf-8", "replace"))
    if lineage_id is not None:
        h.update(b"\x00lineage=" + lineage_id.encode("utf-8", "replace"))
    return h.hexdigest()


@lockcheck.guarded
class ResponseCache:
    """Byte-bounded LRU of predict responses, keyed by content address.

    Thread-safe; every public method takes the one internal lock.  The
    router calls :meth:`get` / :meth:`put` on the dispatch path and
    :meth:`invalidate` from reload/rollback notifications, so all three
    must stay O(1)-ish — eviction amortizes over the puts that caused
    the growth.
    """

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._lock = lockcheck.lock("ResponseCache._lock")
        self._entries: "OrderedDict[str, Response]" = OrderedDict()  # guarded-by: _lock
        self._bytes = 0  # guarded-by: _lock
        self._hits = 0  # guarded-by: _lock
        self._misses = 0  # guarded-by: _lock
        self._evictions = 0  # guarded-by: _lock
        self._invalidations = 0  # guarded-by: _lock

    @property
    def enabled(self) -> bool:
        return self.max_bytes > 0

    def get(self, key: str) -> Optional[Response]:
        """Return the cached response for ``key``, or None.

        A hit moves the entry to most-recently-used; a miss is counted
        so hit-rate math needs no caller bookkeeping.
        """
        with self._lock:
            resp = self._entries.get(key)
            if resp is None:
                self._misses += 1
                return None
            self._entries.move_to_end(key)
            self._hits += 1
            return resp

    def put(self, key: str, response: Response) -> bool:
        """Cache a response; returns True if stored.

        Non-200 responses, payloads larger than the whole budget, and
        disabled caches are all no-ops (not errors): the dispatch path
        calls put unconditionally on fresh responses and this is where
        the policy lives.
        """
        status, _ctype, payload = response
        size = len(payload)
        if status != 200 or not self.enabled or size > self.max_bytes:
            return False
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= len(old[2])
            self._entries[key] = response
            self._bytes += size
            while self._bytes > self.max_bytes and self._entries:
                _k, (_s, _c, victim) = self._entries.popitem(last=False)
                self._bytes -= len(victim)
                self._evictions += 1
            return True

    def invalidate(self, reason: str = "") -> int:
        """Drop every entry; returns how many were dropped.

        Called fleet-wide whenever the serving step changes — a
        completed rolling reload and a rollback after an aborted one
        both land here (the step moved either way).
        """
        del reason  # callers log it; the cache only counts
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._bytes = 0
            if n:
                self._invalidations += 1
            return n

    def stats(self) -> Dict[str, float]:
        """Flat snapshot for JSONL records and /metrics scrapes."""
        with self._lock:
            total = self._hits + self._misses
            return {
                "cache_entries": len(self._entries),
                "cache_bytes": self._bytes,
                "cache_max_bytes": self.max_bytes,
                "cache_hits": self._hits,
                "cache_misses": self._misses,
                "cache_evictions": self._evictions,
                "cache_invalidations": self._invalidations,
                "cache_hit_rate": (self._hits / total) if total else 0.0,
            }
