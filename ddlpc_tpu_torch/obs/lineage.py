"""The lineage record a checkpoint carries — the part of
``ddlpc_tpu/obs/lineage.py`` that checkpoint metadata, the server and the
fleet router need.

A record is a small dict stamped into each checkpoint's manifest and JSON
sidecar at save:

- ``lineage_id``   16-hex id unique to one (run, save);
- ``run_id``       16-hex id unique to one Trainer construction;
- ``step``         the optimizer step the checkpoint holds;
- ``config_hash``  sha256[:16] of the experiment config's JSON;
- ``fingerprint``  sha256[:16] over this package's own ``*.py`` tree;
- ``saved_at``     wall-clock seconds of the durable write.

A checkpoint without one restores with :func:`unknown_lineage`, the
explicit ``lineage_unknown`` marker in every field.  Stdlib only.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import time
import uuid
from typing import Optional

LINEAGE_UNKNOWN = "lineage_unknown"

# Response header carrying the serving checkpoint step, so a client can
# attribute any prediction to a training step.
MODEL_STEP_HEADER = "X-DDLPC-Model-Step"

# The fields every lineage record carries.
LINEAGE_FIELDS = (
    "lineage_id",
    "run_id",
    "step",
    "config_hash",
    "fingerprint",
    "saved_at",
)

_CKPT_SIDECAR_RE = re.compile(r"^ckpt_(\d+)\.json$")

_fingerprint_cache: Optional[str] = None


def new_id() -> str:
    """16 lowercase hex chars — run ids and lineage ids."""
    return uuid.uuid4().hex[:16]


def config_hash(config_json: str) -> str:
    """sha256[:16] of a config's JSON text (the JAX package's hash of the
    same text)."""
    return hashlib.sha256(config_json.encode()).hexdigest()[:16]


def code_fingerprint() -> str:
    """sha256[:16] over ``ddlpc_tpu_torch``'s ``*.py`` tree (sorted relative
    path + content), computed once a process."""
    global _fingerprint_cache
    if _fingerprint_cache is not None:
        return _fingerprint_cache
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in sorted(os.walk(root)):
        dirnames.sort()
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError:
                continue
            h.update(os.path.relpath(path, root).encode())
            h.update(b"\x00")
            h.update(data)
            h.update(b"\x00")
    _fingerprint_cache = h.hexdigest()[:16]
    return _fingerprint_cache


def make_lineage(
    step: int,
    run_id: Optional[str] = None,
    config_hash_hex: Optional[str] = None,
) -> dict:
    """A fresh record for a checkpoint about to be saved (``saved_at`` is
    stamped again at the durable write)."""
    return {
        "lineage_id": new_id(),
        "run_id": run_id or LINEAGE_UNKNOWN,
        "step": int(step),
        "config_hash": config_hash_hex or LINEAGE_UNKNOWN,
        "fingerprint": code_fingerprint(),
        "saved_at": time.time(),
    }


def unknown_lineage(step: Optional[int] = None) -> dict:
    """The record of a checkpoint saved without one: every identity field
    is ``lineage_unknown`` and ``saved_at`` None; ``step`` is kept when the
    caller knows it."""
    return {
        "lineage_id": LINEAGE_UNKNOWN,
        "run_id": LINEAGE_UNKNOWN,
        "step": int(step) if step is not None else None,
        "config_hash": LINEAGE_UNKNOWN,
        "fingerprint": LINEAGE_UNKNOWN,
        "saved_at": None,
    }


def is_unknown(lineage: Optional[dict]) -> bool:
    """True when ``lineage`` is absent or the unknown marker."""
    return (
        not isinstance(lineage, dict)
        or lineage.get("lineage_id") in (None, LINEAGE_UNKNOWN)
    )


def flatten(lineage: Optional[dict], prefix: str = "lineage_") -> dict:
    """Flat-schema projection of a lineage record for JSONL emitters and
    healthz payloads: ``{lineage_id, lineage_run_id, ...}`` — scalars
    only.  ``lineage_id`` keeps its natural name."""
    src = lineage if isinstance(lineage, dict) else unknown_lineage()
    out = {}
    for field in LINEAGE_FIELDS:
        key = field if field == "lineage_id" else prefix + field
        out[key] = src.get(field)
    return out


def newest_checkpoint_lineage(workdir: str) -> Optional[dict]:
    """Lineage of the newest checkpoint under ``workdir/checkpoints``,
    read from its JSON sidecar (stdlib only: the torch-free router computes
    model age against the newest durable checkpoint without the checkpoint
    reader).  None without checkpoints; :func:`unknown_lineage` with the
    step when the newest sidecar has no lineage or cannot be read."""
    ckpt_dir = os.path.join(workdir, "checkpoints")
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return None
    steps = sorted(
        int(m.group(1))
        for m in (_CKPT_SIDECAR_RE.match(n) for n in names)
        if m
    )
    if not steps:
        return None
    step = steps[-1]
    try:
        with open(os.path.join(ckpt_dir, f"ckpt_{step}.json")) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return unknown_lineage(step)
    lin = meta.get("lineage")
    if not isinstance(lin, dict):
        return unknown_lineage(step)
    return dict(lin, step=lin.get("step", step))
