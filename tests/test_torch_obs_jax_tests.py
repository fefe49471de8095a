"""The JAX package's own training-observability tests, run on the port.

The tests of ``tests/test_obs.py`` that hold the telemetry endpoint, the
health monitor's fan-out, ``MetricsLogger``, ``StageTimer``, the watchdog's
alert ring and the stream lint run here unchanged, with every class and
function they name taken from the port: the module's globals are rebound,
and what a test imports inside its body is read from the JAX module's
attribute, which is pointed at the port's for the call (the pattern of
``tests/test_torch_fleet_jax_tests.py``).

The JAX profiler tests time ``jax.jit`` steps, so each has a counterpart
below that times a torch function's steps and asserts the same files and
fields.  ``test_xplane_unavailable_is_actionable`` has none: the port has
no ``obs/xplane.py`` and no XPlane proto to miss, since its captures are
``torch.profiler``'s, whose per-op self-times ``obs/profiling.py`` reads
from the capture's own ``key_averages()`` (``ops.json``); an unreadable
one is the report-level ``error`` that ``test_unreadable_capture_is_a_report_error``
holds.
"""

import inspect
import json
import os
import threading
import types

import pytest
import torch

import ddlpc_tpu.train.observability as jobservability
import ddlpc_tpu.train.watchdog as jwatchdog
import test_obs as jobs_tests
from ddlpc_tpu_torch.obs import health as thealth
from ddlpc_tpu_torch.obs import http as thttp
from ddlpc_tpu_torch.obs import profiling as tprofiling
from ddlpc_tpu_torch.obs import registry as tregistry
from ddlpc_tpu_torch.obs import schema as tschema
from ddlpc_tpu_torch.obs import tracing as ttracing
from ddlpc_tpu_torch.train import observability as tobservability
from ddlpc_tpu_torch.train import watchdog as twatchdog
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

# Module-level names of the JAX tests → the port's objects.
PORT_NAMES = {
    "SCHEMA_VERSION": tschema.SCHEMA_VERSION,
    "check_record": tschema.check_record,
    "EwmaRegressionDetector": thealth.EwmaRegressionDetector,
    "HealthMonitor": thealth.HealthMonitor,
    "LossDetector": thealth.LossDetector,
    "QueueSaturationDetector": thealth.QueueSaturationDetector,
    "TelemetryServer": thttp.TelemetryServer,
    "render_metrics": thttp.render_metrics,
    "wants_prometheus": thttp.wants_prometheus,
    "MetricsRegistry": tregistry.MetricsRegistry,
    "sanitize_name": tregistry.sanitize_name,
    "NULL_SPAN": ttracing.NULL_SPAN,
    "Tracer": ttracing.Tracer,
}

# What the tests import inside their bodies: (JAX module, attribute, port's).
LOCAL_IMPORTS = (
    (jobservability, "MetricsLogger", tobservability.MetricsLogger),
    (jobservability, "StageTimer", tobservability.StageTimer),
    (jwatchdog, "StallWatchdog", twatchdog.StallWatchdog),
)

OBS_TESTS = [
    "test_telemetry_server_routes",
    "test_telemetry_server_trace_route_without_profiler_501",
    "test_health_monitor_fans_out_to_logger_registry_watchdog",
    "test_metrics_logger_stamps_schema_and_publishes_gauges",
    "test_stage_timer_concurrent_producers",
    "test_watchdog_diagnose_dumps_stacks_and_alerts",
    "test_watchdog_record_alert_bounded",
    "test_schema_lint_script_green_on_real_streams",
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


@pytest.mark.parametrize("name", OBS_TESTS, ids=[f"obs-{n}" for n in OBS_TESTS])
def test_jax_obs_test_passes_on_the_port(name, request, monkeypatch):
    for mod, attr, port in LOCAL_IMPORTS:
        monkeypatch.setattr(mod, attr, port)
    fn = on_the_port(jobs_tests, name)
    fixtures = {p: request.getfixturevalue(p) for p in inspect.signature(fn).parameters}
    fn(**fixtures)


def test_rebinding_reaches_the_port(monkeypatch):
    fn = on_the_port(jobs_tests, "test_telemetry_server_routes")
    assert fn.__globals__["TelemetryServer"] is thttp.TelemetryServer
    assert fn.__globals__["MetricsRegistry"] is tregistry.MetricsRegistry
    for mod, attr, port in LOCAL_IMPORTS:
        monkeypatch.setattr(mod, attr, port)
    from ddlpc_tpu.train.observability import MetricsLogger
    from ddlpc_tpu.train.watchdog import StallWatchdog

    assert MetricsLogger is tobservability.MetricsLogger
    assert StallWatchdog is twatchdog.StallWatchdog


# ---- the profiler tests, on a torch function's steps ------------------------


def _step():
    x = torch.ones(128, 128)
    return (x @ x).sum()


def test_ondemand_profiler_round_trip(tmp_path):
    """Arm → N ``step_done`` calls → capture → the top-ops JSON on disk:
    the trigger path the Trainer drives, minus the Trainer (the JAX test's
    counterpart, over a torch matmul)."""
    prof = tprofiling.OnDemandProfiler(out_dir=str(tmp_path), steps=2)
    assert prof.step_done() is None  # unarmed: a free no-op
    prof.arm(steps=2)
    assert prof.armed
    _step()
    assert prof.step_done(sync=lambda: None) is None  # starts
    _step()
    assert prof.step_done(sync=lambda: None) is None
    _step()
    report = prof.step_done(sync=lambda: None)
    assert report is not None and not prof.armed
    assert os.path.isdir(tmp_path / "profile_001")
    assert (tmp_path / "profile_001" / "trace.json").is_file()
    path = tmp_path / "top_ops_001.json"
    assert path.exists()
    on_disk = json.load(open(path))
    assert on_disk["steps_traced"] == 2
    assert "error" not in on_disk
    # The capturing thread's CPU ops are all a CPU run has.
    assert on_disk["planes"] == ["cpu"]
    assert on_disk["top_self_time"], "no ops aggregated from the capture"
    assert any("mm" in o["op"] for o in on_disk["top_self_time"])
    assert on_disk["per_step_ms"] >= 0 and on_disk["wall_ms_per_step"] > 0
    assert on_disk["tag"] == "ondemand_001" and report["report_path"] == str(path)


def test_profiler_finalize_closes_short_capture(tmp_path):
    prof = tprofiling.OnDemandProfiler(out_dir=str(tmp_path), steps=100)
    prof.arm()
    _step()
    prof.step_done(sync=lambda: None)  # the capture starts
    report = prof.finalize(sync=lambda: None)
    assert report is not None  # the arm was not silently lost
    assert (tmp_path / "top_ops_001.json").exists()
    assert prof.steps == 100  # the requested count restored
    # The capture lock is free again: a second capture runs.
    prof.arm(steps=1)
    prof.step_done()
    assert prof.step_done()["tag"] == "ondemand_002"


def test_epoch_capture_and_armed_capture_meet_as_capture_busy(tmp_path):
    """A ``train.profile_epoch`` capture and an armed capture in the same
    epoch: the second finds the one capture lock taken and comes back as
    a report whose ``error`` names ``CaptureBusy``; nothing raises, and
    the epoch's capture is written."""

    class Logged:
        records = []

        def log(self, rec, echo=True):
            self.records.append(rec)

    logger = Logged()
    prof = tprofiling.OnDemandProfiler(out_dir=str(tmp_path), steps=1, logger=logger)
    with tobservability.maybe_profile(str(tmp_path / "profile"), enabled=True):
        prof.arm()
        _step()
        report = prof.step_done()
        assert report is not None and "CaptureBusy" in report["error"]
        assert not prof.armed
    assert (tmp_path / "profile" / "ops.json").is_file()
    assert (tmp_path / "profile" / "trace.json").is_file()
    assert logger.records[-1]["kind"] == "profile" and "CaptureBusy" in logger.records[-1]["error"]
    # And the other way round: an armed capture running, the epoch's warns.
    prof.arm()
    prof.step_done()
    assert prof.armed
    with pytest.warns(UserWarning, match="already running"):
        with tobservability.maybe_profile(str(tmp_path / "profile2"), enabled=True):
            _step()
    assert not (tmp_path / "profile2").exists()
    # The busy attempt took no capture number.
    assert prof.step_done()["tag"] == "ondemand_001"


def test_maybe_profile_lets_the_body_raise_and_releases_the_lock(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with tobservability.maybe_profile(str(tmp_path / "p"), enabled=True):
            1 / 0
    assert (tmp_path / "p" / "ops.json").is_file()
    assert tprofiling._capture_lock.acquire(blocking=False)
    tprofiling._capture_lock.release()
    with tobservability.maybe_profile(str(tmp_path / "q"), enabled=False):
        _step()
    assert not (tmp_path / "q").exists()


def test_unreadable_capture_is_a_report_error(tmp_path):
    """What the JAX package's xplane test holds, in the port's terms: a
    capture whose summary cannot be read degrades to a report-level
    ``error``, the trace directory kept."""
    report = tprofiling.aggregate(str(tmp_path), steps=4, tag="t")
    assert "error" in report and "ops.json" in report["error"]
    assert report["steps_traced"] == 4 and report["tag"] == "t"


def test_profiler_arm_from_another_thread(tmp_path):
    prof = tprofiling.OnDemandProfiler(out_dir=str(tmp_path), steps=1)
    t = threading.Thread(target=prof.arm, kwargs={"steps": 1})
    t.start()
    t.join()
    assert prof.armed
    prof.step_done()
    assert prof.step_done()["steps_traced"] == 1
