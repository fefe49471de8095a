"""Stitch per-process span streams into ONE fleet timeline.

A fleet request's story is written by N+1 processes — the router's
``route_request``/``router_attempt`` spans land in
``<fleet_dir>/router_spans.jsonl`` and each replica's
``serve_request``/``batch_coalesce``/``jit_execute`` spans land in its own
``serve_spans.jsonl`` — all sharing one wall clock (the tracer's JSONL
``time`` field is epoch seconds) and one request identity (the 32-hex
``trace_id`` minted by the router and carried on the ``traceparent``
header; ``obs/tracing.py``).  This module joins them:

- :func:`read_spans` loads any number of span JSONL files;
- :func:`build_timeline` renders a Perfetto-loadable Chrome trace where
  every process is its own track (``pid`` metadata from ``service`` +
  recorded pid) and cross-process hops are FLOW arrows: a router attempt
  span carries its 16-hex ``span_hex``, the replica's ``serve_request``
  root records the same value as ``remote_parent``, and the matching
  ``s``/``f`` flow events draw the arrow from dispatch to execution — a
  hedged request shows the router attempt spans parented over BOTH
  replicas' slot work;
- :func:`attribution` reduces one request's merged spans to the
  end-to-end table (router wait / network hop / replica queue / assembly
  / device / stitch) of one request.

Deliberately torch-free and numpy-free (stdlib only): merging is an
operator/CI activity that must run anywhere the streams can be copied.

The port's own copy of ``ddlpc_tpu/obs/merge.py``: the same merged JSON
from the same span files.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ddlpc_tpu_torch.utils.fsio import atomic_write_json

# Span names with a fixed role in the attribution table.
ROUTE_SPAN = "route_request"
ATTEMPT_SPAN = "router_attempt"
SERVE_SPAN = "serve_request"
# A request answered from the router's response cache: no attempt, no
# replica — the span IS the whole story.
CACHE_SPAN = "cache_hit"


def read_spans(paths: Sequence[str]) -> List[dict]:
    """All ``kind="span"`` records from the given JSONL files, each
    annotated with its source file (``_src``, stripped before any
    re-emission).  Torn/corrupt lines are skipped — a live stream's last
    line may be mid-write."""
    out: List[dict] = []
    for path in paths:
        try:
            fh = open(path, "r", encoding="utf-8")
        except OSError:
            continue
        with fh:
            for line in fh:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and rec.get("kind") == "span":
                    rec["_src"] = os.path.basename(path)
                    out.append(rec)
    out.sort(key=lambda r: r.get("time", 0.0))
    return out


def read_records(paths: Sequence[str]) -> List[dict]:
    """EVERY record from the given JSONL files — spans, metrics, fleet
    events, lineage, autoscale — annotated with ``_src`` and merged into
    one wall-clock order.  The lineage timeline needs the non-span
    streams too (``checkpoint_saved`` and ``fleet_serving`` are flat
    ``kind="lineage"`` records, reloads are ``kind="serve_reload"``), so
    this is :func:`read_spans` without the kind filter."""
    out: List[dict] = []
    for path in paths:
        try:
            fh = open(path, "r", encoding="utf-8")
        except OSError:
            continue
        with fh:
            for line in fh:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    rec["_src"] = os.path.basename(path)
                    out.append(rec)
    out.sort(key=lambda r: r.get("time", 0.0))
    return out


def fleet_span_files(fleet_dir: str) -> List[str]:
    """The standard fleet layout: the router's stream plus one
    ``serve_spans.jsonl`` per replica home (``<fleet_dir>/r<idx>/``)."""
    paths = [os.path.join(fleet_dir, "router_spans.jsonl")]
    try:
        entries = sorted(os.listdir(fleet_dir))
    except OSError:
        entries = []
    for entry in entries:
        p = os.path.join(fleet_dir, entry, "serve_spans.jsonl")
        if os.path.isfile(p):
            paths.append(p)
    return [p for p in paths if os.path.isfile(p)]


def span_trace_ids(rec: dict) -> Set[str]:
    """Every request trace id a span belongs to: its own ``trace_id``
    plus the batcher's ``trace_ids`` list (a worker-thread batch span
    serves several requests at once)."""
    out: Set[str] = set()
    tid = rec.get("trace_id")
    if isinstance(tid, str):
        out.add(tid)
    tids = rec.get("trace_ids")
    if isinstance(tids, list):
        out.update(str(t) for t in tids)
    return out


def filter_trace(records: Iterable[dict], trace_id: str) -> List[dict]:
    return [r for r in records if trace_id in span_trace_ids(r)]


def trace_ids(records: Iterable[dict]) -> List[str]:
    """Request trace ids in first-seen order, roots (``route_request`` /
    ``serve_request`` / ``cache_hit``) first so callers can iterate real
    requests rather than every process's run id."""
    seen: List[str] = []
    for r in records:
        if r.get("name") not in (ROUTE_SPAN, SERVE_SPAN, CACHE_SPAN):
            continue
        t = r.get("trace_id")
        if isinstance(t, str) and t not in seen:
            seen.append(t)
    return seen


def filter_lineage(records: Iterable[dict], lineage_id: str) -> List[dict]:
    """Every record attributed to one checkpoint save — the trainer's
    ``checkpoint_saved`` event, serve-side reloads, the fleet's
    ``fleet_serving`` event, and any span stamped with the id."""
    return [r for r in records if r.get("lineage_id") == lineage_id]


def _process_key(rec: dict) -> Tuple[str, object]:
    # service + recorded OS pid identifies a process; streams predating
    # the pid field fall back to their source file.
    return (
        str(rec.get("service", "?")),
        rec.get("pid", rec.get("_src", "?")),
    )


def build_timeline(
    records: Sequence[dict], trace_id: Optional[str] = None
) -> dict:
    """A Chrome-trace document (``{"traceEvents": [...]}``) over the given
    span records — optionally filtered to one request's ``trace_id`` —
    with one track per source process and flow arrows across the
    router→replica hops.  Loadable directly in Perfetto."""
    if trace_id is not None:
        records = filter_trace(records, trace_id)
    records = sorted(records, key=lambda r: r.get("time", 0.0))
    if not records:
        return {"traceEvents": [], "metadata": {"spans": 0}}
    t0 = min(r.get("time", 0.0) for r in records)
    pids: Dict[Tuple[str, object], int] = {}
    meta: List[dict] = []
    events: List[dict] = []
    # remote_parent → the flow arrow's destination(s); span_hex → source.
    hop_sources: Dict[str, Tuple[int, int, float]] = {}
    hop_dests: List[Tuple[str, int, int, float]] = []
    for rec in records:
        key = _process_key(rec)
        pid = pids.get(key)
        if pid is None:
            pid = pids[key] = len(pids) + 1
            meta.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": pid,
                    "args": {"name": f"{key[0]}/{key[1]}"},
                }
            )
        ts = (rec.get("time", t0) - t0) * 1e6
        dur = max(float(rec.get("dur_s", 0.0)) * 1e6, 1.0)
        tid = int(rec.get("tid", 0))
        args = {
            k: v
            for k, v in rec.items()
            if k
            not in (
                "schema", "kind", "time", "dur_s", "pid", "tid", "_src",
                "name",
            )
        }
        events.append(
            {
                "name": str(rec.get("name", "?")),
                "ph": "X",
                "ts": ts,
                "dur": dur,
                "pid": pid,
                "tid": tid,
                "args": args,
            }
        )
        hexid = rec.get("span_hex")
        if isinstance(hexid, str):
            hop_sources[hexid] = (pid, tid, ts)
        rp = rec.get("remote_parent")
        if isinstance(rp, str):
            hop_dests.append((rp, pid, tid, ts))
    for rp, pid, tid, ts in hop_dests:
        src = hop_sources.get(rp)
        if src is None:
            continue  # the source stream wasn't part of this merge
        s_pid, s_tid, s_ts = src
        common = {"cat": "fleet", "name": "hop", "id": rp}
        events.append(
            {"ph": "s", "pid": s_pid, "tid": s_tid, "ts": s_ts, **common}
        )
        events.append(
            {
                "ph": "f", "bp": "e", "pid": pid, "tid": tid, "ts": ts,
                **common,
            }
        )
    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "metadata": {
            "spans": len(records),
            "processes": len(pids),
            "trace_id": trace_id,
            "t0_epoch_s": round(t0, 6),
        },
    }


def write_trace(doc: dict, path: str) -> str:
    """Rename-atomic trace.json write (a merged trace is an artifact —
    readers must never see a torn one)."""
    atomic_write_json(path, doc)
    return path


# ---------------------------------------------------------------------------
# per-request attribution
# ---------------------------------------------------------------------------


def _sum_dur(records: Iterable[dict], name: str) -> float:
    return sum(
        float(r.get("dur_s", 0.0)) for r in records if r.get("name") == name
    )


def attribution(records: Sequence[dict], trace_id: str) -> Dict[str, object]:
    """One request's end-to-end phase table as a FLAT record
    (``kind="fleet_trace"`` once stamped): where its wall time went —

    - ``router_wait_s``   — request arrival → first attempt dispatched
      (admission waits, zero-eligible blips, shed checks);
    - ``network_hop_s``   — winning attempt duration minus the replica's
      serve_request duration (HTTP + queue on both sides of the socket);
    - ``replica_queue_s`` — batcher admission → batch take
      (``batch_coalesce``) for batches serving this request;
    - ``assembly_s``      — window planning + enqueue on the replica;
    - ``device_s``        — ``jit_execute`` for those batches;
    - ``stitch_s``        — logits → class-map assembly.

    Batch spans serve several requests at once, so replica_queue/device
    are ATTRIBUTED, not exclusive — the table explains a latency, it does
    not bill exclusive device time."""
    recs = filter_trace(records, trace_id)
    route = next(
        (r for r in recs if r.get("name") == ROUTE_SPAN), None
    )
    if route is None:
        # Answered from the response cache: the cache_hit span is the
        # whole request — same attributable identity (model step +
        # lineage id), zero replica phases.
        hit = next((r for r in recs if r.get("name") == CACHE_SPAN), None)
        if hit is not None:
            return {
                "kind": "fleet_trace",
                "trace_id": trace_id,
                "cache_hit": True,
                "total_s": round(float(hit.get("dur_s", 0.0)), 6),
                "status": hit.get("status"),
                "model_step": hit.get("model_step"),
                "lineage_id": hit.get("lineage_id"),
                "attempts": 0,
                "retries": 0,
                "hedges": 0,
                "processes": len({_process_key(r)[1] for r in recs}),
                "spans": len(recs),
            }
    attempts = sorted(
        (r for r in recs if r.get("name") == ATTEMPT_SPAN),
        key=lambda r: r.get("time", 0.0),
    )
    serves = {
        r.get("remote_parent"): r
        for r in recs
        if r.get("name") == SERVE_SPAN and r.get("remote_parent")
    }
    out: Dict[str, object] = {
        "kind": "fleet_trace",
        "trace_id": trace_id,
        "attempts": len(attempts),
        "retries": sum(1 for a in attempts if a.get("reason") == "retry"),
        "hedges": sum(1 for a in attempts if a.get("reason") == "hedge"),
        "processes": len({_process_key(r)[1] for r in recs}),
        "spans": len(recs),
    }
    out["cache_hit"] = False
    if route is not None:
        out["total_s"] = round(float(route.get("dur_s", 0.0)), 6)
        out["status"] = route.get("status")
        if route.get("model_step") is not None:
            out["model_step"] = route.get("model_step")
        if route.get("lineage_id") is not None:
            out["lineage_id"] = route.get("lineage_id")
        if attempts:
            out["router_wait_s"] = round(
                max(attempts[0].get("time", 0.0) - route.get("time", 0.0),
                    0.0),
                6,
            )
    # The winning attempt: answered (status < 500) and not cancelled;
    # hedge losers stay in the count above but don't define the hop.
    winner = next(
        (
            a
            for a in attempts
            if isinstance(a.get("status"), int)
            and a["status"] < 500
            and not a.get("cancelled")
        ),
        None,
    )
    if winner is not None:
        out["winner_replica"] = winner.get("replica")
        out["winner_reason"] = winner.get("reason")
        serve = serves.get(winner.get("span_hex"))
        if serve is not None:
            out["network_hop_s"] = round(
                max(
                    float(winner.get("dur_s", 0.0))
                    - float(serve.get("dur_s", 0.0)),
                    0.0,
                ),
                6,
            )
    out["replica_queue_s"] = round(_sum_dur(recs, "batch_coalesce"), 6)
    out["assembly_s"] = round(
        _sum_dur(recs, "window_plan") + _sum_dur(recs, "enqueue"), 6
    )
    out["device_s"] = round(_sum_dur(recs, "jit_execute"), 6)
    out["stitch_s"] = round(_sum_dur(recs, "stitch"), 6)
    return out


def summarize_requests(records: Sequence[dict]) -> List[Dict[str, object]]:
    """Attribution rows for every request trace present in ``records``
    (only traces with a router ``route_request`` root — a replica's
    local-only traces are not fleet requests)."""
    routed = {
        r.get("trace_id")
        for r in records
        if r.get("name") in (ROUTE_SPAN, CACHE_SPAN)
        and isinstance(r.get("trace_id"), str)
    }
    return [
        attribution(records, t)
        for t in trace_ids(records)
        if t in routed
    ]


# ---------------------------------------------------------------------------
# lineage timeline
# ---------------------------------------------------------------------------

def lineage_timeline(
    records: Sequence[dict], lineage_id: str
) -> Dict[str, object]:
    """One checkpoint's life on the merged timeline: trainer save →
    per-replica reloads → whole-fleet serving → the requests it
    answered.  Works over :func:`read_records` output (mixed streams);
    derives ``deploy_latency_s`` = fleet_serving time − ``saved_at``
    when both ends are present."""
    recs = filter_lineage(records, lineage_id)
    events: List[dict] = []
    saved_at: Optional[float] = None
    fleet_at: Optional[float] = None
    served = 0
    for r in recs:
        kind, name = r.get("kind"), r.get("name")
        event = r.get("event")
        if kind == "lineage" and event == "checkpoint_saved":
            sv = r.get("lineage_saved_at")
            if isinstance(sv, (int, float)) and not isinstance(sv, bool):
                saved_at = float(sv)
        if kind == "lineage" and event == "fleet_serving":
            fleet_at = float(r.get("time", 0.0)) or fleet_at
        if kind == "span" and name in (
            ROUTE_SPAN, SERVE_SPAN, CACHE_SPAN
        ):
            served += 1
        events.append(
            {
                "time": r.get("time"),
                "kind": kind,
                "event": event or name,
                "src": r.get("_src"),
                "step": r.get("step", r.get("lineage_step")),
            }
        )
    out: Dict[str, object] = {
        "lineage_id": lineage_id,
        "events": events,
        "records": len(recs),
        "requests_served": served,
        "saved_at": saved_at,
        "fleet_serving_at": fleet_at,
    }
    if saved_at is not None and fleet_at is not None:
        out["deploy_latency_s"] = round(max(fleet_at - saved_at, 0.0), 6)
    return out
