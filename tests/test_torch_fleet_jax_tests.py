"""The JAX package's own fleet-tier behaviour tests, run on the port.

The fleet tier is stdlib code in both packages.  The JAX package's tests
of it (``tests/test_router.py``: dispatch, retries, breakers, hedges,
drains, scraping, shedding, the warming grace; ``tests/test_cache.py``;
``tests/test_autoscale.py``; the SLO, aggregation and hedged-trace tests
of ``tests/test_obs_fleet.py``; the restart policy, configs and rolling
reloads of ``tests/test_fleet.py``) run here unchanged, with every class
and function they name taken from the port instead: the module's globals
are rebound, and what a test imports inside its body is read from the
JAX module's attribute, which is pointed at the port's for the call.
"""

import inspect
import types

import pytest

import ddlpc_tpu.serve.fleet as jfleet
import ddlpc_tpu.serve.metrics as jmetrics
import ddlpc_tpu.serve.router as jrouter
import ddlpc_tpu.serve.server as jserver
import test_autoscale as jautoscale_tests
import test_cache as jcache_tests
import test_fleet as jfleet_tests
import test_obs_fleet as jobs_fleet_tests
import test_router as jrouter_tests
from ddlpc_tpu_torch import config as tconfig
from ddlpc_tpu_torch.obs import aggregate as taggregate
from ddlpc_tpu_torch.obs import health as thealth
from ddlpc_tpu_torch.obs import merge as tmerge
from ddlpc_tpu_torch.obs import registry as tregistry
from ddlpc_tpu_torch.obs import tracing as ttracing
from ddlpc_tpu_torch.resilience import supervisor as tsupervisor
from ddlpc_tpu_torch.serve import autoscale as tautoscale
from ddlpc_tpu_torch.serve import cache as tcache
from ddlpc_tpu_torch.serve import cbatch as tcbatch
from ddlpc_tpu_torch.serve import fleet as tfleet
from ddlpc_tpu_torch.serve import metrics as tmetrics
from ddlpc_tpu_torch.serve import router as trouter
from ddlpc_tpu_torch.serve import server as tserver
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

# Module-level names of the JAX tests → the port's objects.
PORT_NAMES = {
    "FleetConfig": tconfig.FleetConfig,
    "ServeConfig": tconfig.ServeConfig,
    "CircuitBreaker": trouter.CircuitBreaker,
    "FleetRouter": trouter.FleetRouter,
    "HTTPReplicaClient": trouter.HTTPReplicaClient,
    "ReplicaClient": trouter.ReplicaClient,
    "ReplicaError": trouter.ReplicaError,
    "_percentile": trouter._percentile,
    "ResponseCache": tcache.ResponseCache,
    "response_key": tcache.response_key,
    "Autoscaler": tautoscale.Autoscaler,
    "RestartPolicy": tsupervisor.RestartPolicy,
    "TelemetryAggregator": taggregate.TelemetryAggregator,
    "parse_exposition": taggregate.parse_exposition,
    "merge": tmerge,
    "BurnRateLatch": thealth.BurnRateLatch,
    "HealthMonitor": thealth.HealthMonitor,
    "SLOTracker": thealth.SLOTracker,
    "MetricsRegistry": tregistry.MetricsRegistry,
    "Tracer": ttracing.Tracer,
    "format_traceparent": ttracing.format_traceparent,
    "new_span_hex": ttracing.new_span_hex,
    "new_trace_id": ttracing.new_trace_id,
    "parse_traceparent": ttracing.parse_traceparent,
    "ContinuousBatcher": tcbatch.ContinuousBatcher,
    "ServingFrontend": tserver.ServingFrontend,
    "make_server": tserver.make_server,
}

# What the tests import inside their bodies: (JAX module, attribute, port's).
LOCAL_IMPORTS = (
    (jfleet, "ReplicaSupervisor", tfleet.ReplicaSupervisor),
    (jfleet, "make_fleet_server", tfleet.make_fleet_server),
    (jrouter, "FleetRouter", trouter.FleetRouter),
    (jserver, "ServingFrontend", tserver.ServingFrontend),
    (jserver, "make_server", tserver.make_server),
    (jserver, "drain_and_close", tserver.drain_and_close),
    (jmetrics, "ServeMetrics", tmetrics.ServeMetrics),
)


def _names(module, prefix="test_"):
    return [n for n, f in vars(module).items()
            if n.startswith(prefix) and isinstance(f, types.FunctionType)]


ROUTER_TESTS = _names(jrouter_tests)
CACHE_TESTS = _names(jcache_tests)
AUTOSCALE_TESTS = _names(jautoscale_tests)
OBS_FLEET_TESTS = [
    "test_e2e_trace_propagation_with_hedge",
    "test_aggregator_counter_sum_gauge_max_histogram_merge",
    "test_aggregator_dead_replica_goes_stale_and_leaves_gauge_rollup",
    "test_aggregator_counter_rollup_monotonic_across_replica_restart",
    "test_aggregator_renames_preexisting_replica_label",
    "test_fleet_metrics_endpoint_includes_rollups",
    "test_burn_rate_alert_fires_latches_and_rearms",
    "test_slo_latency_objective_counts_slow_requests_as_bad",
    "test_slo_quiet_below_min_requests",
    "test_slo_status_rides_router_healthz_and_emit",
    "test_burn_rate_latch_validates",
]
FLEET_TESTS = [
    "test_restart_policy_crash_loop_and_progress_reset",
    "test_restart_policy_budget",
    "test_restart_policy_backoff_is_full_jitter",
    "test_fleet_config_roundtrip_and_unknown_key",
    "test_fleet_replica_serve_config_forwards_knobs",
    "test_fleet_vaihingen_config_parses",
    "test_fleet_config_forwards_quantize_and_batcher_knobs",
    "test_healthz_carries_occupancy_and_queue_limit",
    "test_reload_accepts_explicit_step",
    "test_rolling_reload_quantized_fleet_rolls_back_on_quarantine",
    "test_rolling_reload_quantized_fleet_success_path",
]


def on_the_port(module, name):
    """``module.name`` with every function of ``module`` re-made over one
    copy of its globals in which the port's objects replace the JAX
    package's (helpers a test calls see the port's names too)."""
    ns = dict(vars(module))
    ns.update({k: v for k, v in PORT_NAMES.items() if k in ns})
    for k, v in list(ns.items()):
        if isinstance(v, types.FunctionType) and v.__module__ == module.__name__:
            fn = types.FunctionType(v.__code__, ns, v.__name__, v.__defaults__, v.__closure__)
            fn.__kwdefaults__ = v.__kwdefaults__
            ns[k] = fn
    return ns[name]


def _run(module, name, request, monkeypatch):
    for mod, attr, port in LOCAL_IMPORTS:
        monkeypatch.setattr(mod, attr, port)
    fn = on_the_port(module, name)
    fixtures = {p: request.getfixturevalue(p) for p in inspect.signature(fn).parameters}
    fn(**fixtures)


@pytest.mark.parametrize(
    "module,name",
    [(jrouter_tests, n) for n in ROUTER_TESTS]
    + [(jcache_tests, n) for n in CACHE_TESTS]
    + [(jautoscale_tests, n) for n in AUTOSCALE_TESTS]
    + [(jobs_fleet_tests, n) for n in OBS_FLEET_TESTS]
    + [(jfleet_tests, n) for n in FLEET_TESTS],
    ids=[f"router-{n}" for n in ROUTER_TESTS]
    + [f"cache-{n}" for n in CACHE_TESTS]
    + [f"autoscale-{n}" for n in AUTOSCALE_TESTS]
    + [f"obs_fleet-{n}" for n in OBS_FLEET_TESTS]
    + [f"fleet-{n}" for n in FLEET_TESTS],
)
def test_jax_fleet_behaviour_test_passes_on_the_port(module, name, request, monkeypatch):
    _run(module, name, request, monkeypatch)


def test_rebinding_reaches_the_port(monkeypatch):
    fn = on_the_port(jrouter_tests, "test_dispatch_reaches_a_replica_and_answers")
    assert fn.__globals__["FleetRouter"] is trouter.FleetRouter
    # The helper the test calls builds the port's router.
    router = fn.__globals__["make_router"]([])
    assert type(router) is trouter.FleetRouter
    for mod, attr, port in LOCAL_IMPORTS:
        monkeypatch.setattr(mod, attr, port)
    from ddlpc_tpu.serve.fleet import ReplicaSupervisor

    assert ReplicaSupervisor is tfleet.ReplicaSupervisor
