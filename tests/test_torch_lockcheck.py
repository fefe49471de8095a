"""The port's lock-order detector (``ddlpc_tpu_torch/analysis/lockcheck.py``)
and its smoke (``analysis/lock_fixtures.py``), the counterparts of
``tests/test_analysis.py``'s lockcheck tests, and the sanitizer canary of
the port's host batch kernel (``kernels/host/batch.cc``).

- guarded-by semantics: a mutation or rebind without the named lock, an
  owner-thread field mutated by a second thread, a guarded write under a
  condition's lock;
- an inversion fails the checker, and ``run_smoke`` over the real classes
  is clean, the loader's ring and the async checkpointer included;
- the ring's and the checkpointer's annotations are live (a mutation that
  breaks them is caught), and with the detector off both keep plain
  ``threading`` primitives;
- ASan and UBSan over the batch kernel's self-test and ``--stress``,
  wherever ``g++`` exists.
"""

from __future__ import annotations

import os
import shutil
import sys
import threading

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from ddlpc_tpu_torch.analysis import check, lockcheck  # noqa: E402
from ddlpc_tpu_torch.analysis.lock_fixtures import inversion_demo, run_smoke  # noqa: E402
from ddlpc_tpu_torch.data.loader import _Ring, _Slot  # noqa: E402
from ddlpc_tpu_torch.train.async_checkpoint import AsyncCheckpointer  # noqa: E402
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse


@pytest.fixture
def lc():
    was = lockcheck.enabled()
    lockcheck.enable()
    lockcheck.reset()
    yield lockcheck
    if not was:
        lockcheck.disable()
    lockcheck.reset()


def test_guarded_attribute_mutation(lc):
    @lockcheck.guarded
    class Box:
        def __init__(self):
            self._lock = lockcheck.lock("Box._lock")
            self.items: list = []  # guarded-by: _lock
            self.n = 0  # guarded-by: _lock

    b = Box()
    with b._lock:
        b.items.append(1)
        b.n = 1
    assert lc.guard_violations() == []
    b.items.append(2)  # list mutation without the lock
    b.n = 2  # rebind without the lock
    vs = lc.guard_violations()
    assert len(vs) == 2
    assert "Box.items mutated without _lock" in vs[0]
    assert "Box.n rebound without _lock" in vs[1]


def test_owner_thread_confinement(lc):
    @lockcheck.guarded
    class Owned:
        def __init__(self):
            self.counter = 0  # guarded-by: <owner-thread>

    o = Owned()
    o.counter = 1  # this thread claims ownership
    t = threading.Thread(target=lambda: setattr(o, "counter", 2))
    t.start()
    t.join(10)
    assert not t.is_alive()
    vs = lc.guard_violations()
    assert len(vs) == 1 and "owner-thread" in vs[0]


def test_condition_guards_its_writes_and_wait_releases(lc):
    @lockcheck.guarded
    class W:
        def __init__(self):
            self._cond = lockcheck.condition("W._cond")
            self.x = 0  # guarded-by: _cond

    w = W()
    with w._cond:
        w.x = 1
    assert lc.guard_violations() == []
    # While one thread waits, the lock is not its: the other thread's
    # guarded write under the condition is clean, and one without it is not.
    seen = []

    def writer():
        with w._cond:
            w.x = 2
            w._cond.notify()
        w.x = 3

    with w._cond:
        t = threading.Thread(target=writer)
        t.start()
        seen.append(w._cond.wait_for(lambda: w.x >= 2, timeout=10))
    t.join(10)
    assert seen == [True] and not t.is_alive()
    vs = lc.guard_violations()
    assert len(vs) == 1 and "W.x rebound without _cond" in vs[0]


def test_inversion_demo_fails_the_checker(capsys):
    rc = check.main(["--rules", "lock-order", "--lockcheck-fixture",
                     "ddlpc_tpu_torch.analysis.lock_fixtures:inversion_demo"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "lock-order inversion" in out and "demo.A -> demo.B" in out


def test_inversion_demo_reports_the_cycle(lc):
    assert inversion_demo()["cycles"] == ["demo.A -> demo.B"]


def test_smoke_on_the_real_classes_is_clean(lc, tmp_path):
    rep = run_smoke(workdir=str(tmp_path), device="cpu")
    assert rep["cycles"] == [], rep
    assert rep["guard_violations"] == [], rep
    assert rep["arms"] == ["MicroBatcher", "Tracer", "HealthMonitor", "CircuitBreaker",
                           "StageTimer", "_Ring", "AsyncCheckpointer"]
    assert rep["device"] == "cpu"


def _ring(n: int = 2) -> _Ring:
    return _Ring([_Slot(torch.zeros(2, 4), torch.zeros(2, 2, dtype=torch.int32))
                  for _ in range(n)])


def test_the_ring_is_guarded_by_its_condition(lc):
    ring = _ring()
    assert isinstance(ring._cv._lock, lockcheck.InstrumentedRLock)
    with ring._cv:
        ring._slots.append(ring._slots.pop())
    assert lc.guard_violations() == []
    ring._slots.pop()  # no lock
    vs = lc.guard_violations()
    assert len(vs) == 1 and "_Ring._slots mutated without _cv" in vs[0]


def test_the_ring_under_contention_hands_out_each_slot_once(lc):
    """Four threads churn a two-slot ring: a slot is never held twice at
    once, and the detector sees no violation."""
    ring = _ring()
    held, errors = set(), []
    guard = threading.Lock()

    def churn(i: int) -> None:
        for _ in range(200):
            s = ring.acquire()
            with guard:
                if id(s) in held:
                    errors.append("slot handed out twice")
                held.add(id(s))
            with guard:
                held.discard(id(s))
            ring.release(s)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=churn, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert errors == [] and len(ring._slots) == 2
    assert lc.guard_violations() == []


def test_the_checkpointer_is_owner_thread_confined(lc, tmp_path):
    """``save``, ``wait`` and ``close`` belong to the training thread: a
    ``close`` from another thread is a violation."""
    from ddlpc_tpu_torch.config import ModelConfig
    from ddlpc_tpu_torch.models import build_model
    from ddlpc_tpu_torch.parallel.train_step import create_train_state
    from ddlpc_tpu_torch.train.optim import Adam

    state = create_train_state(build_model(ModelConfig(
        features=(4, 8), bottleneck_features=8, stem="s2d", stem_factor=2, num_classes=3)),
        Adam(1e-3))
    ac = AsyncCheckpointer(keep=1)
    ac.save(str(tmp_path), state, 0)
    ac.wait()
    assert lc.guard_violations() == []
    t = threading.Thread(target=ac.close)
    t.start()
    t.join(30)
    assert not t.is_alive()
    vs = lc.guard_violations()
    assert vs and all("AsyncCheckpointer." in v and "owner-thread" in v for v in vs)


def test_plain_primitives_when_the_detector_is_off():
    was = lockcheck.enabled()
    lockcheck.disable()
    try:
        ring = _ring()
        assert type(ring._slots) is list
        assert not isinstance(ring._cv._lock, lockcheck._InstrumentedBase)
        ring.release(ring.acquire())
        ac = AsyncCheckpointer()
        ac._inflight = None
        assert lockcheck.guard_violations() == []
    finally:
        if was:
            lockcheck.enable()


def test_sanitize_canary_asan_ubsan():
    """With a compiler present, the sanitized self-test and its threaded
    stress MUST pass: a g++-equipped machine cannot silently skip it.  The
    TSan arm runs under ``--sanitize`` and may skip with a logged reason."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ — the sanitizer canary needs a compiler")
    logged = []
    assert check.sanitize(REPO, arms=("asan", "ubsan"), log=logged.append) == []
    assert logged == ["asan: batch_check stress OK; batch_check OK",
                      "ubsan: batch_check stress OK; batch_check OK"]
