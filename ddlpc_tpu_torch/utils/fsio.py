"""Atomic, durable small-file writes — the port's copy of ``ddlpc_tpu/utils/fsio.py``.

Write to a temp file in the destination directory, fsync, then
``os.replace``: a crash mid-write never leaves a torn or empty file where
a reader expects a whole one.  Stdlib only.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Optional


def atomic_write_text(
    path: str,
    text: str,
    durable: bool = True,
    fsync_dir: bool = False,
) -> str:
    """Write ``text`` to ``path`` via tmp + fsync + rename; returns path.

    ``durable=False`` skips the file fsync (keeping only rename
    atomicity), for advisory files rewritten on a hot path.
    ``fsync_dir=True`` also fsyncs the containing directory, so that the
    rename itself survives a power loss (the checkpoint-grade guarantee).
    """
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        # mkstemp creates 0600; restore the umask-default mode so the
        # rename cannot tighten the permissions of a file others read.
        umask = os.umask(0)
        os.umask(umask)
        os.fchmod(fd, 0o666 & ~umask)
        with os.fdopen(fd, "w") as f:
            f.write(text)
            if durable:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    if fsync_dir:
        dir_fd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
    return path


def atomic_write_json(
    path: str,
    obj: Any,
    indent: Optional[int] = 2,
    durable: bool = True,
    fsync_dir: bool = False,
) -> str:
    """``json.dump`` with the tmp + fsync + rename discipline."""
    return atomic_write_text(
        path,
        json.dumps(obj, indent=indent) + "\n",
        durable=durable,
        fsync_dir=fsync_dir,
    )
