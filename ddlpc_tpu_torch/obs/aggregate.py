"""Fleet telemetry aggregation: N registries → one ``ddlpc_fleet_*`` scrape.

The router's registry answers on the fleet ``/metrics``, but every
replica's ``ddlpc_serve_*`` series live behind that replica's own
ephemeral port — no single replica's scrape answers "what is the FLEET
doing".  :class:`TelemetryAggregator` closes that gap: on a cadence it
pulls every source's Prometheus text
exposition (replica ``/metrics`` over HTTP, the router's registry
in-process), and re-publishes each ``ddlpc_<x>`` family as
``ddlpc_fleet_<x>`` with

- **per-replica series preserved** — every scraped series gains a
  ``replica`` label naming its source;
- **one rollup series** per label-set at ``replica="fleet"`` — counters
  and histograms (bucket-by-bucket, sums of cumulative counts stay
  cumulative) SUM across sources; gauges take the MAX (a queue-depth or
  busy-fraction rollup answers "how bad is the worst replica", which is
  the question a gauge's operator is asking);
- **staleness discipline** — a source whose last successful scrape is
  older than ``stale_after_s`` is flagged
  (``ddlpc_fleet_source_stale{replica}=1``) and its GAUGES leave the
  rollup (a dead replica's frozen queue depth must not pose as the
  fleet's worst); its counters/histograms keep contributing their last
  cumulative values — a counter rollup is "work the fleet has done" and
  must stay MONOTONIC, or a downstream ``rate()`` reads the dip as a
  counter reset.  For the same reason :meth:`remove_source` retires a
  departing source's summed values into offsets: a supervised replica
  restart (remove at death, fresh add at readiness) resets the
  per-replica series — which Prometheus handles per series — but never
  walks the fleet totals backwards.

Deliberately torch-free and dependency-free (stdlib only), like the
router: the aggregator runs in the fleet front-end process, which never
pays a torch import.  The text-format parser handles exactly the v0.0.4
subset ``obs/registry.py`` emits — which is the only dialect in this
system.

The port's own copy of ``ddlpc_tpu/obs/aggregate.py``: the same rollup
text from the same expositions.
"""

from __future__ import annotations

import math
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

FLEET_PREFIX = "ddlpc_fleet_"
_SOURCE_PREFIX = "ddlpc_"
ROLLUP_LABEL = "fleet"  # the aggregate series' replica label value

_SERIES_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(v: str) -> str:
    return (
        v.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")
    )


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class Family:
    """One metric family from an exposition: declared kind + help and the
    raw samples (sample name, label tuple, value).  Histogram samples keep
    their ``_bucket``/``_sum``/``_count`` suffixes and ``le`` labels."""

    def __init__(self, name: str, kind: str = "untyped", help: str = ""):
        self.name = name
        self.kind = kind
        self.help = help
        self.samples: List[Tuple[str, Tuple[Tuple[str, str], ...], float]] = []


def parse_exposition(text: str) -> Dict[str, Family]:
    """Families from a Prometheus text exposition (v0.0.4 subset —
    ``obs/registry.py``'s own output shape).  Unparseable lines are
    skipped: a torn scrape degrades, never raises."""
    families: Dict[str, Family] = {}
    # sample name -> family base name (histogram suffixes map back)
    owner: Dict[str, str] = {}

    def family(name: str) -> Family:
        fam = families.get(name)
        if fam is None:
            fam = families[name] = Family(name)
        return fam

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                fam = family(parts[2])
                if parts[1] == "TYPE":
                    fam.kind = parts[3].strip() if len(parts) > 3 else "untyped"
                    owner[parts[2]] = parts[2]
                    if fam.kind == "histogram":
                        for sfx in ("_bucket", "_sum", "_count"):
                            owner[parts[2] + sfx] = parts[2]
                else:
                    fam.help = parts[3] if len(parts) > 3 else ""
            continue
        m = _SERIES_RE.match(line)
        if m is None:
            continue
        sample_name, labels_raw, value_raw = m.groups()
        try:
            if value_raw == "+Inf":
                value = float("inf")
            elif value_raw == "-Inf":
                value = float("-inf")
            else:
                value = float(value_raw)
        except ValueError:
            continue
        labels: List[Tuple[str, str]] = []
        if labels_raw:
            for lm in _LABEL_RE.finditer(labels_raw):
                labels.append((lm.group(1), _unescape(lm.group(2))))
        base = owner.get(sample_name, sample_name)
        family(base).samples.append((sample_name, tuple(labels), value))
    return families


class _Source:
    def __init__(self, name: str, fetch: Callable[[], str]):
        self.name = name
        self.fetch = fetch
        self.families: Dict[str, Family] = {}
        self.last_ok: Optional[float] = None  # clock of last good scrape
        self.failures = 0


def _is_summed(kind: str, sample_name: str) -> bool:
    """True for sample kinds whose rollup is a SUM of cumulative values
    (counters, histogram buckets/sums/counts, untyped); gauges roll up as
    the max of FRESH sources."""
    return kind != "gauge" or sample_name.endswith(
        ("_sum", "_count", "_bucket")
    )


def _fleet_samples(fam: Family):
    """(out_name, kind, help, out_sample, labels, value) for one scraped
    family's re-publication as ``ddlpc_fleet_*``.  A source label already
    named ``replica`` (the router's own per-replica families) renames to
    ``src_replica`` — the aggregator OWNS the ``replica`` label and the
    text format forbids two labels with one name."""
    if not fam.name.startswith(_SOURCE_PREFIX):
        return
    if fam.name.startswith(FLEET_PREFIX):
        return  # never re-aggregate an aggregate
    out_name = FLEET_PREFIX + fam.name[len(_SOURCE_PREFIX):]
    suffix_shift = len(fam.name)
    for sample_name, labels, value in fam.samples:
        out_sample = out_name + sample_name[suffix_shift:]
        labels = tuple(
            ("src_replica" if ln == "replica" else ln, lv)
            for ln, lv in labels
        )
        yield out_name, fam.kind, fam.help, out_sample, labels, value


class TelemetryAggregator:
    """Scrape-and-rollup engine for the fleet ``/metrics``.

    ``add_source(name, fetch)`` registers one telemetry source — ``fetch``
    returns a Prometheus text exposition (an HTTP replica's
    ``metrics_text``, or ``registry.exposition`` for the in-process
    router).  ``scrape_once()`` pulls every source;
    ``exposition()``/``snapshot()`` render the current rollups.  The
    optional background loop (:meth:`start`) runs the scrape on a cadence
    so a fleet scrape is always at most ``every_s`` old.

    Thread-safe: sources come and go as replicas restart (the fleet
    supervisor registers them at readiness, exactly like the router).
    """

    def __init__(
        self,
        stale_after_s: float = 15.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.stale_after_s = float(stale_after_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._sources: Dict[str, _Source] = {}
        # Cumulative offsets from REMOVED sources, per rollup key — what
        # keeps counter/histogram rollups monotonic across the supervised
        # remove-at-death / add-at-readiness replica lifecycle.
        self._retired: Dict[Tuple[str, str, Tuple], float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- sources -------------------------------------------------------------

    def add_source(self, name: str, fetch: Callable[[], str]) -> None:
        with self._lock:
            self._sources[name] = _Source(name, fetch)

    def remove_source(self, name: str) -> None:
        """Drop a source, retiring its last SUMMED values (counters,
        histogram buckets/sums/counts, untyped) into rollup offsets —
        the fleet's cumulative totals never decrease because one replica
        process ended."""
        with self._lock:
            src = self._sources.pop(name, None)
            if src is None:
                return
            for fam in src.families.values():
                for out_name, kind, _, out_sample, labels, value in (
                    _fleet_samples(fam)
                ):
                    if _is_summed(kind, out_sample):
                        key = (out_name, out_sample, labels)
                        self._retired[key] = (
                            self._retired.get(key, 0.0) + value
                        )

    def source_names(self) -> List[str]:
        with self._lock:
            return sorted(self._sources)

    # -- scraping ------------------------------------------------------------

    def scrape_once(self) -> Dict[str, bool]:
        """One pass over every source; per-source success map.  A failed
        fetch keeps the source's LAST families (the stale flag and the
        rollup exclusion say so — see class docstring)."""
        with self._lock:
            sources = list(self._sources.values())
        out: Dict[str, bool] = {}
        for src in sources:
            try:
                families = parse_exposition(src.fetch())
            except Exception:
                with self._lock:
                    src.failures += 1
                out[src.name] = False
                continue
            with self._lock:
                src.families = families
                src.last_ok = self._clock()
            out[src.name] = True
        return out

    def start(self, every_s: float) -> "TelemetryAggregator":
        if self._thread is None and every_s > 0:
            def loop() -> None:
                while not self._stop.wait(every_s):
                    try:
                        self.scrape_once()
                    except Exception:
                        pass  # aggregation must never kill the front end

            self._thread = threading.Thread(
                target=loop, name="fleet-aggregate", daemon=True
            )
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- rollup --------------------------------------------------------------

    def _collect(self, now: float):
        """(merged families, per-source freshness, retired offsets) under
        one lock pass."""
        with self._lock:
            sources = [
                (s.name, s.families, s.last_ok) for s in self._sources.values()
            ]
            retired = dict(self._retired)
        fresh: Dict[str, bool] = {}
        for name, _, last_ok in sources:
            fresh[name] = (
                last_ok is not None and now - last_ok <= self.stale_after_s
            )
        merged: Dict[str, dict] = {}
        for sname, families, _ in sources:
            for fam in families.values():
                for out_name, kind, help_, out_sample, labels, value in (
                    _fleet_samples(fam)
                ):
                    slot = merged.setdefault(
                        out_name,
                        {"kind": kind, "help": help_, "samples": []},
                    )
                    if slot["kind"] == "untyped" and kind != "untyped":
                        slot["kind"] = kind
                    slot["samples"].append(
                        (out_sample, labels, value, sname)
                    )
        return merged, fresh, retired

    def _rollups(
        self, slot: dict, fresh: Dict[str, bool],
        retired: Dict[Tuple[str, str, Tuple], float], out_name: str,
    ) -> Dict[Tuple[str, Tuple], float]:
        """One aggregate value per (sample, label-set).  Summed kinds
        (counters, histogram buckets/sums/counts, untyped) sum EVERY
        present source — stale ones included, their frozen values are
        still cumulative truth — plus the retired offsets, so the series
        is monotonic across replica restarts.  Gauges take the max of
        FRESH sources only (a dead replica's frozen queue depth must not
        pose as the fleet's worst) and vanish with their last fresh
        source."""
        kind = slot["kind"]
        summed: Dict[Tuple[str, Tuple], float] = {}
        gauge_vals: Dict[Tuple[str, Tuple], List[float]] = {}
        for sample_name, labels, value, sname in slot["samples"]:
            key = (sample_name, labels)
            if _is_summed(kind, sample_name):
                summed[key] = summed.get(key, 0.0) + value
            elif fresh.get(sname):
                gauge_vals.setdefault(key, []).append(value)
        for (rname, rsample, rlabels), offset in retired.items():
            if rname == out_name:
                key = (rsample, rlabels)
                summed[key] = summed.get(key, 0.0) + offset
        out = dict(summed)
        for key, values in gauge_vals.items():
            out[key] = max(values)
        return out

    def render(self, now: Optional[float] = None) -> List[str]:
        """The ``ddlpc_fleet_*`` exposition lines: per-replica series plus
        one rollup series per label-set, plus the aggregator's own
        freshness series."""
        now = self._clock() if now is None else now
        merged, fresh, retired = self._collect(now)
        lines: List[str] = []
        for out_name in sorted(merged):
            slot = merged[out_name]
            kind = slot["kind"]
            if slot["help"]:
                lines.append(f"# HELP {out_name} {slot['help']} (fleet rollup)")
            # Everything re-exposes as untyped except gauges: the
            # per-replica + rollup mixture under one name is a federation
            # shape, and a counter rollup spanning restarting sources is
            # monotonic by construction here but not a native counter
            # family either.
            expo_kind = "gauge" if kind == "gauge" else "untyped"
            lines.append(f"# TYPE {out_name} {expo_kind}")
            for sample_name, labels, value, sname in sorted(
                slot["samples"], key=lambda s: (s[0], s[1], s[3])
            ):
                pairs = [
                    f'{ln}="{_escape(lv)}"' for ln, lv in labels
                ] + [f'replica="{_escape(sname)}"']
                lines.append(
                    f"{sample_name}{{{','.join(pairs)}}} {_fmt(value)}"
                )
            rollup = self._rollups(slot, fresh, retired, out_name)
            for (sample_name, labels), value in sorted(rollup.items()):
                pairs = [
                    f'{ln}="{_escape(lv)}"' for ln, lv in labels
                ] + [f'replica="{ROLLUP_LABEL}"']
                lines.append(
                    f"{sample_name}{{{','.join(pairs)}}} {_fmt(value)}"
                )
        # Aggregator self-telemetry: scrape freshness per source.
        with self._lock:
            ages = {
                s.name: (
                    None if s.last_ok is None else now - s.last_ok
                )
                for s in self._sources.values()
            }
        if ages:
            lines.append(
                "# HELP ddlpc_fleet_source_stale 1 when a source's last "
                "successful scrape is older than stale_after_s (its series "
                "are excluded from rollups)."
            )
            lines.append("# TYPE ddlpc_fleet_source_stale gauge")
            for name in sorted(ages):
                stale = int(not fresh.get(name, False))
                lines.append(
                    f'ddlpc_fleet_source_stale{{replica="{_escape(name)}"}} '
                    f"{stale}"
                )
            lines.append(
                "# HELP ddlpc_fleet_scrape_age_seconds Seconds since each "
                "source's last successful scrape."
            )
            lines.append("# TYPE ddlpc_fleet_scrape_age_seconds gauge")
            for name in sorted(ages):
                age = ages[name]
                if age is not None:
                    lines.append(
                        "ddlpc_fleet_scrape_age_seconds"
                        f'{{replica="{_escape(name)}"}} {_fmt(age)}'
                    )
        return lines

    def exposition(self, now: Optional[float] = None) -> str:
        lines = self.render(now)
        return "\n".join(lines) + "\n" if lines else ""

    def snapshot(self, now: Optional[float] = None) -> Dict[str, object]:
        """Flat JSON view of the ROLLUP series only (the JSON /metrics
        fallback stays scannable; per-replica detail is the text
        exposition's job)."""
        now = self._clock() if now is None else now
        merged, fresh, retired = self._collect(now)
        out: Dict[str, object] = {}
        for out_name in sorted(merged):
            slot = merged[out_name]
            rollup = self._rollups(slot, fresh, retired, out_name)
            for (sample_name, labels), value in sorted(rollup.items()):
                sfx = (
                    "{" + ",".join(f'{ln}="{lv}"' for ln, lv in labels) + "}"
                    if labels
                    else ""
                )
                out[f"{sample_name}{sfx}"] = value
        out["ddlpc_fleet_sources_fresh"] = sum(
            1 for v in fresh.values() if v
        )
        out["ddlpc_fleet_sources_total"] = len(fresh)
        return out
