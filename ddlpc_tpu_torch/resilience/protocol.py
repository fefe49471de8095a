"""The exit-status + breadcrumb protocol of a training process — the port's
copy of ``ddlpc_tpu/resilience/protocol.py``.

A training process reports its fate through two channels that outlive it:

- **exit status**: 0 (``EXIT_CLEAN``) when every epoch ran; 42
  (``EXIT_STALL``) when the stall watchdog aborted it; 43
  (``EXIT_PREEMPTED``) after a graceful preemption — the in-flight step
  finished and an emergency checkpoint was written (or the grace window
  ran out, and the last durable checkpoint stands); a signal or any other
  status is a kill or a crash.
- **breadcrumb**: ``<workdir>/breadcrumb.json``, a small JSON file
  replaced atomically at each phase (``running``, per-checkpoint
  progress, ``preempt_requested``, ``preempted``, ``preempt_timeout``,
  ``done``), which a supervisor reads after an exit to refine the status.

Stdlib only.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from typing import Optional

EXIT_CLEAN = 0
EXIT_STALL = 42
EXIT_PREEMPTED = 43

BREADCRUMB = "breadcrumb.json"

# train/checkpoint.py's blob pattern; quarantined ``*.bad`` blobs do not
# match, since they are not progress.
_CKPT_RE = re.compile(r"^ckpt_(\d+)\.(?:msgpack\.z|dwc)$")


def write_breadcrumb(workdir: str, phase: str, **fields) -> None:
    """Atomically rewrite the breadcrumb.  Best-effort: a diagnostic never
    takes down the run it describes, so every failure is swallowed.  Not
    fsynced (rename-atomic only): a reader sees a whole crumb or the
    previous one."""
    try:
        os.makedirs(workdir, exist_ok=True)
        crumb = {"schema": 1, "phase": phase, "pid": os.getpid(), "time": time.time()}
        crumb.update(fields)
        fd, tmp = tempfile.mkstemp(dir=workdir, suffix=".crumb.tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(crumb, f)
        os.replace(tmp, os.path.join(workdir, BREADCRUMB))
    except Exception:
        pass


def read_breadcrumb(workdir: str) -> Optional[dict]:
    """The last breadcrumb, or None (missing, torn, or unreadable)."""
    try:
        with open(os.path.join(workdir, BREADCRUMB)) as f:
            return json.load(f)
    except Exception:
        return None


def latest_checkpoint_step(ckpt_dir: str) -> Optional[int]:
    """Newest live checkpoint step in ``ckpt_dir``, or None."""
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return None
    steps = [int(m.group(1)) for m in map(_CKPT_RE.match, names) if m]
    return max(steps) if steps else None
