"""The port's batchers and serve metrics against the JAX package's.

The batchers are stdlib code in both packages.  The JAX package's own
behaviour tests of them (``tests/test_serve.py`` and
``tests/test_cbatch.py``: coalescing, backpressure, deadlines, drain,
slot refill, priority classes, the starvation bound) run here unchanged
with every class they name rebound to the port's; ``ServeMetrics`` gives
the same snapshots and quantiles as JAX's for the same timings.
"""

import types

import numpy as np
import pytest

import test_cbatch as jcbatch_tests
import test_serve as jserve_tests
from ddlpc_tpu.serve.metrics import ServeMetrics as JServeMetrics
from ddlpc_tpu_torch.serve import batching, cbatch
from ddlpc_tpu_torch.serve.metrics import ServeMetrics
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

PORT_NAMES = {
    "MicroBatcher": batching.MicroBatcher,
    "Overloaded": batching.Overloaded,
    "DeadlineExceeded": batching.DeadlineExceeded,
    "EngineClosed": batching.EngineClosed,
    "ContinuousBatcher": cbatch.ContinuousBatcher,
    "check_priority": cbatch.check_priority,
    "ServeMetrics": ServeMetrics,
}

SERVE_TESTS = [
    "test_batcher_coalesces_fewer_forwards_than_requests",
    "test_batcher_coalesces_under_real_concurrency",
    "test_bounded_queue_sheds_with_typed_overloaded",
    "test_submit_many_is_all_or_nothing",
    "test_deadline_exceeded_is_typed_not_a_hang",
    "test_close_without_drain_fails_queued_typed",
    "test_graceful_drain_completes_all_queued",
    "test_forward_error_fails_batch_but_keeps_serving",
]
CBATCH_TESTS = [
    "test_refill_admits_queued_work_the_moment_a_slot_frees",
    "test_two_slots_overlap_forwards",
    "test_light_load_dispatches_without_coalescing_wait",
    "test_interactive_seated_before_batch_class",
    "test_starvation_bound_serves_batch_class_under_interactive_flood",
    "test_batch_class_sheds_independently_of_interactive",
    "test_priority_validation_is_typed",
    "test_queue_depths_reported_per_class",
    "test_metrics_see_priority_depths_and_sheds",
    "test_deadline_exceeded_is_typed_not_a_hang",
    "test_close_without_drain_fails_queued_typed",
    "test_graceful_drain_completes_all_queued_both_classes",
    "test_forward_error_fails_batch_but_keeps_serving",
]


def _against_the_port(fn):
    """``fn`` with the batcher classes it names taken from the port."""
    names = set(fn.__code__.co_names) & set(PORT_NAMES)
    assert names, f"{fn.__name__} names none of the port's classes"
    env = dict(fn.__globals__, **{k: PORT_NAMES[k] for k in names})
    return types.FunctionType(fn.__code__, env, fn.__name__, fn.__defaults__, fn.__closure__)


@pytest.mark.parametrize(
    "module,name",
    [(jserve_tests, n) for n in SERVE_TESTS] + [(jcbatch_tests, n) for n in CBATCH_TESTS],
    ids=[f"serve-{n}" for n in SERVE_TESTS] + [f"cbatch-{n}" for n in CBATCH_TESTS],
)
def test_jax_batcher_behaviour_test_passes_on_the_port(module, name):
    _against_the_port(getattr(module, name))()


def test_rebinding_reaches_the_port():
    fn = _against_the_port(jserve_tests.test_submit_many_is_all_or_nothing)
    assert fn.__globals__["MicroBatcher"] is batching.MicroBatcher
    assert fn.__globals__["Overloaded"] is batching.Overloaded


def _feed(m):
    rng = np.random.default_rng(0)
    for i in range(300):
        m.record_batch(int(rng.integers(1, 9)), 8)
        m.record_request(float(rng.uniform(0.002, 0.3)), tiles=int(rng.integers(1, 6)),
                         priority="batch" if i % 3 == 0 else "interactive")
        if i % 50 == 0:
            m.record_shed(priority="batch" if i % 100 else "interactive")
            m.record_deadline()
        m.set_queue_depth(i % 7)
        m.set_priority_queue_depth({"interactive": i % 7, "batch": i % 3})
    m.set_slot_busy({0: 0.25, 1: 0.75})


@pytest.mark.parametrize("window", [16, 2048])
def test_serve_metrics_snapshots_and_quantiles_equal_jax(monkeypatch, window):
    """The same timings through both classes: every snapshot field equal
    (the clock pinned, so the rates are too), the quantiles included, and
    the registry's exposition text (the latency histogram's too)."""
    import ddlpc_tpu.serve.metrics as jm
    import ddlpc_tpu_torch.serve.metrics as tm
    from ddlpc_tpu.obs.registry import MetricsRegistry as JRegistry
    from ddlpc_tpu_torch.obs.registry import MetricsRegistry

    t = [1000.0]
    for mod in (jm, tm):
        monkeypatch.setattr(mod.time, "monotonic", lambda: t[0])
    jreg, treg = JRegistry(), MetricsRegistry()
    j, p = JServeMetrics(window=window, registry=jreg), ServeMetrics(window=window, registry=treg)
    _feed(j)
    _feed(p)
    t[0] += 2.5
    js, ps = j.snapshot(), p.snapshot()
    assert ps == js
    assert p.occupancy() == j.occupancy()
    assert {"p50_ms", "p95_ms", "p99_ms", "interactive_p99_ms", "batch_p99_ms"} <= set(ps)
    assert treg.exposition() == jreg.exposition()
    assert "_bucket{" in treg.exposition()
