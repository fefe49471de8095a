"""Prometheus-style metrics registry: Counter and Gauge with labels — the
port's copy of ``ddlpc_tpu/obs/registry.py`` (its Histogram, which only
the serving side uses, is not copied yet).

One :class:`MetricsRegistry` a training process, held by the trainer; the
perf accountant (``obs/flops.py``), the comm accountant (``obs/comm.py``)
and the state-bytes gauges (``obs/hbm.py``) publish into it.  The port
serves no telemetry endpoint yet; :meth:`MetricsRegistry.exposition` gives
the text format v0.0.4 and :meth:`MetricsRegistry.snapshot` a flat dict.

- metric types: counter (monotonic), gauge (set/inc/dec);
- labels: declared per metric (``labelnames``), passed as kwargs on every
  update; each distinct label-value tuple is an independent series;
- registration is idempotent: asking for an existing (name, type,
  labelnames) returns the existing metric, a conflicting redeclaration
  raises.

Thread-safe: every mutation goes through one registry lock.  Stdlib only.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


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
        series)."""
        out: Dict[str, object] = {}
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
            for m in metrics:
                for key, v in sorted(m._series.items()):
                    out[f"{m.name}{m._series_suffix(key)}"] = v
        return out
