"""Prometheus-style metrics registry: Counter / Gauge / Histogram + labels
— the port's copy of ``ddlpc_tpu/obs/registry.py``.

One :class:`MetricsRegistry` per process side (train, serve).  The
trainer's accountants (``obs/flops.py``, ``obs/comm.py``, ``obs/hbm.py``)
publish into one; ``MetricsLogger`` (train/observability.py) and
``ServeMetrics`` (serve/metrics.py) into the serving one, which the serve
``/metrics`` route exposes as Prometheus text (content-negotiated,
obs/http.py).

Deliberately small and dependency-free — the subset of the Prometheus data
model this repo needs, not a client library:

- metric types: counter (monotonic), gauge (set/inc/dec), histogram
  (cumulative ``le`` buckets + ``_sum``/``_count``);
- labels: declared per metric (``labelnames``), passed as kwargs on every
  update; each distinct label-value tuple is an independent series;
- registration is idempotent: asking for an existing (name, type,
  labelnames) returns the existing metric, a conflicting redeclaration
  raises — so subsystems can declare their metrics where they use them;
- exposition follows the text format v0.0.4 (``# HELP``/``# TYPE`` then
  one ``name{labels} value`` line per series).

Thread-safe: all mutation goes through one registry lock (updates are
dict/float ops — contention is negligible next to the work being measured).
"""

from __future__ import annotations

import math
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Latency-oriented default buckets (seconds), Prometheus' classic set.
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)


def sanitize_name(name: str) -> str:
    """A valid Prometheus metric name from an arbitrary record key."""
    name = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not name or not _NAME_RE.match(name):
        name = "_" + name
    return name


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    kind = "untyped"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str],
        lock: threading.Lock,
    ):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._series: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: dict) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}"
            )
        return tuple(str(labels[ln]) for ln in self.labelnames)

    def _series_suffix(self, key: Tuple[str, ...], extra: str = "") -> str:
        pairs = [
            f'{ln}="{_escape_label(lv)}"'
            for ln, lv in zip(self.labelnames, key)
        ]
        if extra:
            pairs.append(extra)
        return "{" + ",".join(pairs) + "}" if pairs else ""

    def expose(self) -> List[str]:
        raise NotImplementedError

    def header(self) -> List[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        return lines


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))

    def expose(self) -> List[str]:
        with self._lock:
            items = sorted(self._series.items())
        return [
            f"{self.name}{self._series_suffix(k)} {_fmt(v)}"
            for k, v in items
        ]


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))

    def expose(self) -> List[str]:
        with self._lock:
            items = sorted(self._series.items())
        return [
            f"{self.name}{self._series_suffix(k)} {_fmt(v)}"
            for k, v in items
        ]


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames, lock, buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames, lock)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError(f"histogram {name} needs at least one bucket")
        self.buckets = bs  # +Inf is implicit

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        v = float(value)
        with self._lock:
            st = self._series.get(key)
            if st is None:
                st = self._series[key] = {
                    "counts": [0] * (len(self.buckets) + 1),
                    "sum": 0.0,
                    "count": 0,
                }
            i = len(self.buckets)
            for j, b in enumerate(self.buckets):
                if v <= b:
                    i = j
                    break
            st["counts"][i] += 1
            st["sum"] += v
            st["count"] += 1

    def expose(self) -> List[str]:
        with self._lock:
            items = sorted(
                (k, [list(v["counts"]), v["sum"], v["count"]])
                for k, v in self._series.items()
            )
        lines = []
        for key, (counts, total, count) in items:
            cum = 0
            for b, c in zip((*self.buckets, float("inf")), counts):
                cum += c
                le = self._series_suffix(key, extra=f'le="{_fmt(b)}"')
                lines.append(f"{self.name}_bucket{le} {cum}")
            lines.append(f"{self.name}_sum{self._series_suffix(key)} {_fmt(total)}")
            lines.append(f"{self.name}_count{self._series_suffix(key)} {count}")
        return lines


class MetricsRegistry:
    """Get-or-create metric factory + text exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> _Metric:
        labelnames = tuple(labelnames)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls or existing.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind} with labels {existing.labelnames}"
                    )
                return existing
            # Metrics share the registry lock: updates are tiny dict ops and
            # one lock keeps exposition consistent without lock ordering.
            m = cls(name, help, labelnames, self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self, name, help="", labelnames=(), buckets=DEFAULT_BUCKETS
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def exposition(self) -> str:
        """Prometheus text exposition format v0.0.4 for every metric."""
        lines: List[str] = []
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            lines.extend(m.header())
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, object]:
        """Flat JSON view: one key per series (``name{l="v"}`` for labeled
        series), histograms reduced to ``_sum``/``_count``."""
        out: Dict[str, object] = {}
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            if isinstance(m, Histogram):
                with self._lock:
                    items = sorted(self._series_copy(m).items())
                for key, st in items:
                    sfx = m._series_suffix(key)
                    out[f"{m.name}_sum{sfx}"] = st["sum"]
                    out[f"{m.name}_count{sfx}"] = st["count"]
            else:
                with self._lock:
                    items = sorted(m._series.items())
                for key, v in items:
                    out[f"{m.name}{m._series_suffix(key)}"] = v
        return out

    @staticmethod
    def _series_copy(m: Histogram) -> dict:
        return {k: dict(v) for k, v in m._series.items()}
