"""Asynchronous checkpointing — the port's copy of
``ddlpc_tpu/train/async_checkpoint.py``.

The training thread pays only for the host snapshot
(``checkpoint.snapshot_state``: one copy of each flat buffer from the card
into reusable pinned host buffers).  A copy, never a view: the train step
updates the params and the Adam moments in place, and would overwrite a
snapshot that aliased them while the writer compresses it.  Everything
after it — the flax layout, chunking or the monolithic msgpack blob,
compression, fsync, prune — runs on one background writer thread.

Semantics:

- **Ordering barrier**: a save issued while the previous write is still in
  flight first waits for it, so checkpoints land in issue order with at
  most one write (and one snapshot's memory) in flight; the host buffers
  are reused only after that barrier.
- **Errors surface on the training thread**: a writer failure (disk full,
  permissions) is raised again by the next ``save()`` or ``wait()``.
- **Exit barrier**: ``Trainer.fit`` calls ``wait()`` before the next save,
  at its end, and before exit 43.
- **Replica gate**: under the chunked ZeRO levels every replica joins the
  gather of the moments (and under zero3 of the params); only replica 0
  copies to the host and writes.
"""

from __future__ import annotations

import concurrent.futures
import time
from typing import Optional

from ddlpc_tpu_torch.analysis import lockcheck
from ddlpc_tpu_torch.parallel.mesh import world_rank
from ddlpc_tpu_torch.train import checkpoint as ckpt


@lockcheck.guarded
class AsyncCheckpointer:
    """Background-threaded saves; ``background=False`` (the config's
    ``checkpoint_async=false``) runs the same write inline.

    No lock: ``save``/``wait``/``close`` are called from the training
    thread only, the future is the hand-off, and ``wait()`` orders every
    read of what the writer set (``last_write_s``, ``last_path``).  The
    ``# guarded-by: <owner-thread>`` annotations pin that shape: under
    ``DDLPC_LOCKCHECK=1`` a second mutating thread is a violation, not a
    silent race.  ``last_write_s`` and ``last_path`` are the writer
    thread's: written before the future resolves and read only after the
    ``wait()`` barrier, so they carry no annotation."""

    def __init__(
        self,
        keep: int = 3,
        format: str = "chunked",
        chunk_bytes: int = ckpt.CHUNK_BYTES,
        compression: str = "adaptive",
        background: bool = True,
    ):
        self.keep = keep
        self.format = format
        self.chunk_bytes = chunk_bytes
        self.compression = compression
        self.background = background
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None  # guarded-by: <owner-thread>
        self._inflight: Optional[concurrent.futures.Future] = None  # guarded-by: <owner-thread>
        self._host: dict = {}  # reusable host buffers of the snapshot
        # What the training thread paid for the last save (snapshot plus
        # any barrier on the previous write), and what the write cost.
        self.last_stall_s = 0.0  # guarded-by: <owner-thread>
        self.last_write_s = 0.0
        self.last_path: Optional[str] = None

    def _executor(self) -> concurrent.futures.ThreadPoolExecutor:
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="ckpt-writer")
        return self._pool

    def save(self, ckpt_dir: str, state, step: int, metadata: Optional[dict] = None) -> None:
        """Snapshot ``state`` and schedule (or perform) the write; blocks
        for the snapshot, and for the previous write if it still runs
        (raising its failure here)."""
        t0 = time.perf_counter()
        self.wait()
        writer = world_rank() == 0
        snap = ckpt.snapshot_state(state, host=self._host, to_host=writer)
        if not writer:
            self.last_stall_s = time.perf_counter() - t0
            return

        def write():
            w0 = time.perf_counter()
            self.last_path = ckpt.save_snapshot(
                ckpt_dir, snap.flat(), step, metadata=metadata, keep=self.keep,
                format=self.format, chunk_bytes=self.chunk_bytes,
                compression=self.compression,
            )
            self.last_write_s = time.perf_counter() - w0

        if self.background:
            self._inflight = self._executor().submit(write)
        else:
            write()
        self.last_stall_s = time.perf_counter() - t0

    def wait(self) -> None:
        """Barrier on the in-flight write; raises its exception here."""
        inflight, self._inflight = self._inflight, None
        if inflight is not None:
            inflight.result()

    @property
    def in_flight(self) -> bool:
        return self._inflight is not None and not self._inflight.done()

    def close(self) -> None:
        """Final barrier and writer-thread shutdown (idempotent)."""
        try:
            self.wait()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None
