"""Bounded runtime exercises for the lock-order detector — the port's copy
of ``ddlpc_tpu/analysis/lock_fixtures.py``.

``run_smoke`` drives the port's instrumented concurrency hot spots — the
MicroBatcher, Tracer, HealthMonitor, CircuitBreaker and StageTimer, and
(where torch imports) the loader's ``_Ring`` and the
``AsyncCheckpointer`` — under real thread contention for a fraction of a
second, then returns the recorded acquisition graph and guard
violations.  ``python -m ddlpc_tpu_torch.analysis.check`` runs it on every
invocation and fails on any cycle or guarded-by violation.  On a card the
ring's slots are pinned and each upload records a live CUDA event, and
the checkpointer snapshots a state on the card.

``inversion_demo`` is the committed NEGATIVE fixture: two locks taken in
opposite orders on two threads — the analyzer must fail on it
(``tests/test_torch_lockcheck.py`` pins that it does).
"""

from __future__ import annotations

import os
import tempfile
import threading
from typing import Optional

from ddlpc_tpu_torch.analysis import lockcheck


def _threads(n: int, fn) -> None:
    ts = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()


def run_smoke(workdir: Optional[str] = None, device: Optional[str] = None) -> dict:
    """Exercise the instrumented classes; returns ``lockcheck.report()``
    with the arms that ran.  ``device`` is where the torch arms put their
    tensors (default: the card when there is one, else the CPU).

    Must be called with lockcheck enabled (the CLI does).  Each arm is a
    few hundred operations: enough to cross every lock pair the classes
    can produce, cheap enough to run on every check.
    """
    from ddlpc_tpu_torch.obs.health import Alert, HealthMonitor
    from ddlpc_tpu_torch.obs.tracing import Tracer
    from ddlpc_tpu_torch.serve.batching import MicroBatcher
    from ddlpc_tpu_torch.serve.router import CircuitBreaker
    from ddlpc_tpu_torch.train.observability import StageTimer

    report: dict = {"arms": []}

    # MicroBatcher: concurrent submit/shed/drain against a live worker.
    mb = MicroBatcher(forward=lambda xs: [x * 2 for x in xs], max_batch=4,
                      max_wait_ms=1.0, queue_limit=64)

    def submit(i: int) -> None:
        for k in range(20):
            try:
                mb.submit(k).result(timeout=5)
            except Exception:
                pass  # a shed request is part of the exercise
            mb.queue_depth  # noqa: B018  — cross-thread read path

    _threads(4, submit)
    mb.close(drain=True)
    report["arms"].append("MicroBatcher")

    with tempfile.TemporaryDirectory(dir=workdir) as td:
        # Tracer: spans from several threads, cross-thread add_span, flush.
        tr = Tracer(enabled=True, jsonl_path=os.path.join(td, "spans.jsonl"),
                    chrome_path=os.path.join(td, "trace.json"))

        def trace(i: int) -> None:
            for k in range(15):
                with tr.span(f"phase{i}", k=k):
                    pass
                tr.add_span("xthread", tr.now(), tr.now())

        _threads(4, trace)
        tr.flush()
        tr.close()
        report["arms"].append("Tracer")

        # HealthMonitor: emit storm against /healthz-style snapshot reads.
        hm = HealthMonitor()

        def health(i: int) -> None:
            for k in range(20):
                hm.emit(Alert(alert="step_time_regression", severity="warn",
                              message="lockcheck smoke", value=float(k), threshold=1.0))
                hm.alerts  # noqa: B018

        _threads(3, health)
        report["arms"].append("HealthMonitor")

        # CircuitBreaker: outcome storm across the latch transitions.
        br = CircuitBreaker(window=8, min_samples=4, cooldown_s=0.0)

        def breaker(i: int) -> None:
            for k in range(30):
                if br.acquire():
                    br.record(k % 3 != 0)
                br.available()
                if k % 7 == 0:
                    br.release()

        _threads(4, breaker)
        report["arms"].append("CircuitBreaker")

        # StageTimer: the loader's producer threads and the training thread.
        st = StageTimer()

        def stages(i: int) -> None:
            for _ in range(25):
                with st.stage(f"s{i % 3}"):
                    pass
                st.summary()
                st.means()

        _threads(4, stages)
        st.reset()
        report["arms"].append("StageTimer")

        # The ring and the checkpointer live in torch-tier modules: exercise
        # them where torch imports, note the skip where it does not (the
        # analyzer itself runs on a stdlib-only install).
        try:
            import torch

            from ddlpc_tpu_torch.data.loader import _Ring, _Slot
            from ddlpc_tpu_torch.train.async_checkpoint import AsyncCheckpointer
        except ImportError as e:
            report["torch_arms_skipped"] = f"{type(e).__name__}: {e}"
        else:
            dev = torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))
            report["device"] = str(dev)
            _ring_arm(torch, _Ring, _Slot, dev)
            report["arms"].append("_Ring")
            _checkpointer_arm(torch, AsyncCheckpointer, dev, os.path.join(td, "ckpt"))
            report["arms"].append("AsyncCheckpointer")

    report.update(lockcheck.report())
    return report


def _ring_arm(torch, ring_cls, slot_cls, dev) -> None:
    """Producers churn a two-slot ring as ``ShardedLoader._produce`` does:
    acquire (which waits for the slot's last upload), fill, upload without
    blocking, record the upload's event, release."""
    cuda = dev.type == "cuda"

    def slot():
        return slot_cls(torch.zeros((2, 64), pin_memory=cuda),
                        torch.zeros((2, 16), dtype=torch.int32, pin_memory=cuda))

    ring = ring_cls([slot() for _ in range(2)])

    def churn(i: int) -> None:
        up = torch.empty((2, 64), device=dev)
        for k in range(25):
            s = ring.acquire()
            try:
                s.imgs.fill_(float(k))
                up.copy_(s.up_imgs, non_blocking=cuda)
                if cuda:
                    s.copied = torch.cuda.Event()
                    s.copied.record()
            finally:
                ring.release(s)
        if cuda:
            torch.cuda.synchronize(dev)

    _threads(4, churn)


def _checkpointer_arm(torch, ckpt_cls, dev, ckpt_dir: str) -> None:
    """Saves of a small model's state on ``dev`` from the training thread
    while the writer thread writes the previous one, and a reader thread
    polls ``in_flight`` (a read, which the owner-thread guard allows)."""
    from ddlpc_tpu_torch.config import ModelConfig
    from ddlpc_tpu_torch.models import build_model
    from ddlpc_tpu_torch.parallel.train_step import create_train_state
    from ddlpc_tpu_torch.train.optim import Adam

    model = build_model(ModelConfig(features=(4, 8), bottleneck_features=8, stem="s2d",
                                    stem_factor=2, num_classes=3)).to(dev)
    state = create_train_state(model, Adam(1e-3))
    ac = ckpt_cls(keep=2)
    done = threading.Event()

    def poll() -> None:
        while not done.is_set():
            ac.in_flight  # noqa: B018
            done.wait(0.001)

    reader = threading.Thread(target=poll)
    reader.start()
    try:
        for step in range(3):
            ac.save(ckpt_dir, state, step)
            state.params.data.add_(1.0)
    finally:
        ac.close()
        done.set()
        reader.join()


def inversion_demo() -> dict:
    """Deliberate lock-order inversion: A→B on one thread, B→A on another
    (sequenced so the demo itself cannot deadlock).  The analyzer must
    report a cycle."""
    a = lockcheck.lock("demo.A")
    b = lockcheck.lock("demo.B")
    done_ab = threading.Event()

    def t_ab() -> None:
        with a:
            with b:
                pass
        done_ab.set()

    def t_ba() -> None:
        done_ab.wait(5)
        with b:
            with a:
                pass

    t1 = threading.Thread(target=t_ab)
    t2 = threading.Thread(target=t_ba)
    t1.start(), t2.start()
    t1.join(), t2.join()
    return lockcheck.report()
