"""The one-flat-JSON-object-per-line record contract, in code.

Every JSONL stream in the repo — ``metrics.jsonl``, ``serve_metrics.jsonl``,
``spans.jsonl``, ``serve_spans.jsonl``, ``resilience.jsonl`` — carries
records of this shape, so
one tool (``scripts/obs_tail.py``) tails any of them and one lint
(``scripts/check_metrics_schema.py``, invoked from tier-1) keeps emitters
honest.  :func:`check_record` is the single owner of what "flat" means.

The port's own copy of ``ddlpc_tpu/obs/schema.py`` (stdlib only), kept line for line
so the two read alike.
"""

from __future__ import annotations

import time
from typing import List, Optional

# Version of the flat-JSONL record schema.  Bump ONLY on a breaking shape
# change (a record stops being one flat JSON object per line); adding keys
# is not a bump.
SCHEMA_VERSION = 1

# Every record ``kind`` the repo's emitters stamp (records without a
# ``kind`` are training metrics, kind "train").  The lint rejects unknown
# kinds so a typo'd emitter cannot silently fork a new stream dialect;
# new subsystems register their kinds here first.
KNOWN_KINDS = frozenset(
    {
        "train",  # per-epoch training metrics (the kind-less default)
        "span",  # tracer (obs/tracing.py)
        "alert",  # health detectors (obs/health.py)
        "serve",  # serve metrics snapshots (serve/metrics.py)
        "serve_reload",  # hot-reload audit records (serve/server.py)
        "serve_quant",  # quantized-deploy audit: mode + resident bytes (serve/server.py)
        "profile",  # on-demand profiler reports (obs/profiling.py)
        "preempt",  # graceful-preemption record (train/trainer.py)
        "supervisor_attempt",  # resilience.jsonl (resilience/supervisor.py)
        "supervisor_give_up",
        "perf",  # goodput/MFU accounting (obs/flops.py, per epoch)
        "comm",  # communication accounting (obs/comm.py)
        "router",  # fleet router snapshots/events — router.jsonl (serve/router.py)
        "fleet",  # replica supervision events — router.jsonl (serve/fleet.py)
        "analysis",  # static-analysis reports — analysis.jsonl (scripts/ddlpc_check.py)
        "program",  # compiled-program audits — programs.jsonl (scripts/program_audit.py)
        "slo",  # error-budget ledger — router.jsonl (obs/health.py:SLOTracker)
        "fleet_trace",  # per-request cross-process attribution (obs/merge.py, scripts/fleet_report.py)
        "autoscale",  # elastic-fleet policy decisions — router.jsonl (serve/autoscale.py)
        "cache",  # response-cache stats snapshots — router.jsonl (serve/cache.py)
        "lineage",  # checkpoint provenance events — metrics.jsonl/router.jsonl (obs/lineage.py consumers)
        "prod_soak",  # train-to-serve soak audit records (scripts/prod_soak.py)
        "pipeline",  # pipeline A/B rows — docs/sharding/pipeline_ab.json (bench.py --pipeline-ab)
    }
)

_SCALAR = (str, int, float, bool, type(None))


def check_record(obj: object) -> List[str]:
    """Violations of the stream contract for one decoded JSONL record.

    A conforming record is a JSON object whose values are scalars or lists
    of scalars (``val_iou_per_class`` is a list), carrying an integer
    ``schema`` field at or below :data:`SCHEMA_VERSION` and (when present)
    a ``kind`` from :data:`KNOWN_KINDS`.  Records from OLDER schema
    versions are tolerated (long-lived runs survive an in-place tooling
    upgrade — :func:`is_stale` lets tools count and report them); records
    claiming a NEWER version than this tooling understands are violations.
    Returns human-readable violation strings; empty means conforming.
    """
    errs: List[str] = []
    if not isinstance(obj, dict):
        return [f"record is {type(obj).__name__}, not a JSON object"]
    schema = obj.get("schema")
    if schema is None:
        errs.append("missing 'schema' field")
    elif not isinstance(schema, int) or isinstance(schema, bool):
        errs.append(f"'schema' must be an integer, got {schema!r}")
    elif schema > SCHEMA_VERSION:
        errs.append(
            f"'schema' {schema} is newer than this tooling's "
            f"SCHEMA_VERSION {SCHEMA_VERSION} — upgrade the tooling"
        )
    elif schema < 0:
        # Versions start at 1 (0 grandfathers pre-stamp records); a
        # negative stamp is an emitter bug, not an old version.
        errs.append(f"'schema' {schema} is not a valid version")
    kind = obj.get("kind")
    if kind is not None and (
        not isinstance(kind, str) or kind not in KNOWN_KINDS
    ):
        errs.append(
            f"unknown record kind {kind!r} — register it in "
            f"obs/schema.py:KNOWN_KINDS"
        )
    for k, v in obj.items():
        if isinstance(v, _SCALAR):
            continue
        if isinstance(v, list) and all(isinstance(x, _SCALAR) for x in v):
            continue
        errs.append(
            f"key {k!r} holds a {type(v).__name__} — records must stay flat "
            f"(scalars or lists of scalars)"
        )
    return errs


def stamp(record: dict, kind: Optional[str] = None) -> dict:
    """Stamp ``record`` with the stream contract fields, in place.

    The one helper every JSONL emitter that builds records by hand should
    flow through (``scripts/ddlpc_check.py``'s jsonl-stamp rule looks for
    it): sets ``schema`` (and ``time``) if absent, and — when ``kind`` is
    given — a ``kind`` that must already be registered in
    :data:`KNOWN_KINDS`, so a typo'd emitter fails at the emit site
    instead of at lint time."""
    if kind is not None:
        if kind not in KNOWN_KINDS:
            raise ValueError(
                f"unregistered record kind {kind!r} — add it to "
                f"obs/schema.py:KNOWN_KINDS first"
            )
        record.setdefault("kind", kind)
    record.setdefault("schema", SCHEMA_VERSION)
    record.setdefault("time", time.time())
    return record


def is_stale(obj: object) -> bool:
    """True for a record stamped with an OLDER (still valid) schema
    version: conforming, but worth reporting — the stream predates the
    current tooling (e.g. a long-lived run tailed across an upgrade)."""
    if not isinstance(obj, dict):
        return False
    schema = obj.get("schema")
    return (
        isinstance(schema, int)
        and not isinstance(schema, bool)
        and 0 <= schema < SCHEMA_VERSION
    )
