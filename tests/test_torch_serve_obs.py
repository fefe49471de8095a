"""The port's copies of the chaos harness and the observability modules
against the JAX package's, and the serve-side faults on the port's engine,
server, trainer and checkpoint writer.

- chaos: the same ``DDLPC_CHAOS`` schedules parse to the same plans and
  refusals; ``serve_err@N`` fails the Nth forward and the frontend
  answers 500; ``reload_corrupt@1`` quarantines and falls back;
  ``flip_ckpt@1`` and ``disk_full@1`` act on the port's checkpoint writer
  as on JAX's; ``nan@1`` poisons the port trainer's epoch record;
- tracing: the same spans give the same JSONL records apart from ids and
  clocks; health: the same series give the same alerts; registry: the
  same content renders the same exposition text, histograms included;
- the profiler's capture writes the top-ops report's fields.
"""

import errno
import json
import os
import threading
import warnings

import numpy as np
import pytest

from ddlpc_tpu.obs import health as jhealth
from ddlpc_tpu.obs import registry as jregistry
from ddlpc_tpu.obs import tracing as jtracing
from ddlpc_tpu.resilience import chaos as jchaos
from ddlpc_tpu_torch.obs import health as thealth
from ddlpc_tpu_torch.obs import profiling as tprofiling
from ddlpc_tpu_torch.obs import registry as tregistry
from ddlpc_tpu_torch.obs import tracing as ttracing
from ddlpc_tpu_torch.resilience import chaos as tchaos
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

SPECS = [
    "kill@3",
    "stall@2:0.5;preempt@5",
    "nan@1;flip_ckpt@2;disk_full@1",
    "slow_loader:25",
    "serve_kill@4;serve_stall@2:1.5;serve_err@3:2;reload_corrupt@1",
    " serve_err@1 ; ; kill@9 ",
]


def _plan(m):
    return (m.step_faults, m.ckpt_faults, m.serve_faults, m.reload_corrupt_at,
            m.slow_loader_ms)


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_schedules_parse_as_jax(spec):
    assert _plan(tchaos.ChaosMonkey(spec)) == _plan(jchaos.ChaosMonkey(spec))


@pytest.mark.parametrize("spec", ["boom@1", "kill", "kill@x", "stall@1:y", "slow_loader"])
def test_bad_chaos_schedules_refused_as_jax(spec):
    with pytest.raises(jchaos.ChaosError) as je:
        jchaos.ChaosMonkey(spec)
    with pytest.raises(tchaos.ChaosError) as te:
        tchaos.ChaosMonkey(spec)
    assert str(te.value) == str(je.value)


def test_active_follows_the_env_var(monkeypatch):
    monkeypatch.delenv(tchaos.ENV, raising=False)
    assert tchaos.active() is None
    monkeypatch.setenv(tchaos.ENV, "serve_err@2")
    m = tchaos.active()
    assert m is tchaos.active() and m.serve_faults == {2: [{"kind": "serve_err", "dur": None}]}


@pytest.fixture()
def run_dir(tmp_path):
    from test_torch_serve import write_run

    return write_run(str(tmp_path / "run"))


def test_serve_err_fails_the_nth_forward_and_the_frontend_answers_500(run_dir, monkeypatch):
    from test_torch_serve_http import _npy, _Served

    from ddlpc_tpu.config import ServeConfig as JServeConfig
    from ddlpc_tpu.serve import server as jserver
    from ddlpc_tpu_torch.config import ServeConfig
    from ddlpc_tpu_torch.serve import server as tserver
    from test_torch_serve import TILE, engines

    body = _npy(np.zeros((TILE, TILE, 3), np.float32))
    codes = []
    for which, (mod, cfg_cls) in enumerate(((jserver, JServeConfig), (tserver, ServeConfig))):
        eng = engines(run_dir)[which]
        monkeypatch.setenv("DDLPC_CHAOS", "serve_err@2")
        jchaos._cache_spec = tchaos._cache_spec = None  # a fresh schedule each
        s = _Served(mod, cfg_cls, eng, max_batch=1, slots=1, deadline_ms=5000.0)
        try:
            got = [s.request("POST", "/predict", body) for _ in range(3)]
        finally:
            s.close()
        codes.append([g[0] for g in got])
        err = json.loads(got[1][2])["error"]
        assert err.startswith("ChaosFault: chaos: injected error burst (forward 2)")
    assert codes[1] == codes[0] == [200, 500, 200]


def test_reload_corrupt_quarantines_and_falls_back_as_jax(tmp_path, monkeypatch):
    from test_torch_serve import engines, write_run

    d = write_run(str(tmp_path / "run"), seed=0, step=1)
    jd = str(tmp_path / "jrun")
    write_run(jd, seed=0, step=1)
    je, te = engines(jd)[0], engines(d)[1]
    write_run(d, seed=7, step=2)
    write_run(jd, seed=7, step=2)
    monkeypatch.setenv("DDLPC_CHAOS", "reload_corrupt@1")
    metas = []
    for eng in (je, te):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            metas.append(eng.reload())
    assert metas[1]["step"] == metas[0]["step"] == 1
    assert metas[1]["quarantined_steps"] == metas[0]["quarantined_steps"] == [2]
    assert sorted(os.listdir(os.path.join(d, "checkpoints"))) == sorted(
        os.listdir(os.path.join(jd, "checkpoints")))
    assert tchaos.active().fired[0]["kind"] == "reload_corrupt"


@pytest.mark.parametrize("spec", ["disk_full@1", "flip_ckpt@1", "disk_full@1;flip_ckpt@2"])
def test_checkpoint_faults_act_on_the_port_writer_as_on_jax(tmp_path, monkeypatch, spec):
    """Two saves under the schedule in each package: the same save fails
    with ENOSPC, the same blob is flipped mid-file and then quarantined by
    the restore, which falls back as JAX's does."""
    from test_torch_checkpoint import jax_state, jax_target, small_tree

    from ddlpc_tpu.train import checkpoint as jckpt
    from ddlpc_tpu_torch.train import checkpoint as tckpt

    outcomes = []
    for name, save, restore in (
        ("jax", lambda d, s: jckpt.save_checkpoint(d, jax_state(s), s, keep=5),
         lambda d: jckpt.restore_checkpoint(d, jax_target())[1]),
        ("port", lambda d, s: tckpt.save_snapshot(d, tckpt.flatten_tree(small_tree(s)), s, keep=5),
         lambda d: tckpt.restore_checkpoint(d)[1]),
    ):
        monkeypatch.setenv("DDLPC_CHAOS", spec)
        jchaos._cache_spec = tchaos._cache_spec = None  # a fresh schedule each
        d = str(tmp_path / name)
        errs = []
        for step in (1, 2):
            try:
                save(d, step)
            except OSError as e:
                errs.append((step, e.errno))
        blobs = sorted(n for n in os.listdir(d) if n.endswith((".dwc", ".msgpack.z")))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                meta = restore(d)
                restored = (meta.get("step"), meta.get("quarantined_steps"))
            except ValueError:
                restored = "nothing restorable"
        fired = [f["kind"] for f in (jchaos if name == "jax" else tchaos).active().fired]
        outcomes.append((errs, blobs, restored, fired))
    assert outcomes[1] == outcomes[0]
    if "disk_full" in spec:
        assert outcomes[1][0] == [(1, errno.ENOSPC)]


def test_nan_fault_poisons_the_port_trainers_epoch_record(tmp_path, monkeypatch):
    from test_torch_watchdog import _tiny_config

    from ddlpc_tpu_torch.train.__main__ import parse_args
    from ddlpc_tpu_torch.train.trainer import Trainer

    monkeypatch.setenv("DDLPC_CHAOS", "nan@1;slow_loader:1")
    tchaos._cache_spec = None
    cfg, _, device, _ = parse_args([
        "--config", _tiny_config(tmp_path), "--device", "cpu", "--workdir", str(tmp_path / "run"),
    ])
    rec = Trainer(cfg, resume=False, device=device).fit()
    assert rec["loss"] != rec["loss"]
    assert [f["kind"] for f in tchaos.active().fired] == ["nan", "nan_record"]
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        first = json.loads(f.readline())
    assert first["loss"] != first["loss"]


def test_preempt_fault_runs_the_port_trainers_graceful_path(tmp_path, monkeypatch):
    from test_torch_watchdog import _tiny_config

    from ddlpc_tpu_torch.train.__main__ import parse_args
    from ddlpc_tpu_torch.train.trainer import Trainer

    monkeypatch.setenv("DDLPC_CHAOS", "preempt@1")
    tchaos._cache_spec = None
    cfg, _, device, _ = parse_args([
        "--config", _tiny_config(tmp_path, epochs=3), "--device", "cpu",
        "--workdir", str(tmp_path / "run"),
    ])
    trainer = Trainer(cfg, resume=False, device=device)
    trainer.fit()
    assert trainer.preempted
    with open(tmp_path / "run" / "breadcrumb.json") as f:
        assert json.load(f)["phase"] == "preempted"


# ---- observability copies ------------------------------------------------------


def _spans(mod, tmp_path, name):
    path = str(tmp_path / f"{name}.jsonl")
    tr = mod.Tracer(enabled=True, service="serve", jsonl_path=path,
                    chrome_path=str(tmp_path / f"{name}.json"))
    with tr.span("serve_request", tiles=3) as s:
        with tr.span("window_plan"):
            pass
        s.set(extra="x")
    t0 = tr.now()
    tr.add_span("jit_execute", t0, t0 + 0.01, batch=2)
    with tr.bind("0123456789abcdef0123456789abcdef", "0123456789abcdef"):
        with tr.span("stitch", windows=2):
            pass
    try:
        with tr.span("fails"):
            raise KeyError("k")
    except KeyError:
        pass
    tr.close()
    with open(path) as f:
        recs = [json.loads(ln) for ln in f]
    with open(str(tmp_path / f"{name}.json")) as f:
        chrome = json.load(f)
    return recs, chrome


_CLOCKS = {"trace_id", "span_id", "parent_id", "ts", "start", "end", "dur_ms", "dur_s", "time",
           "pid", "tid", "thread", "span_hex", "parent_hex", "dur", "wall_start"}


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in _CLOCKS}


def test_the_same_spans_give_the_same_records(tmp_path):
    jrecs, jchrome = _spans(jtracing, tmp_path, "jax")
    trecs, tchrome = _spans(ttracing, tmp_path, "port")
    assert [sorted(r) for r in trecs] == [sorted(r) for r in jrecs]
    assert [_strip(r) for r in trecs] == [_strip(r) for r in jrecs]
    assert len(trecs) == 5
    jev = jchrome["traceEvents"] if isinstance(jchrome, dict) else jchrome
    tev = tchrome["traceEvents"] if isinstance(tchrome, dict) else tchrome
    assert [e.get("name") for e in tev] == [e.get("name") for e in jev]


@pytest.mark.parametrize("value", [None, "", "00-0123456789abcdef0123456789abcdef-0123456789abcdef-01",
                                   "00-xyz-0123456789abcdef-01", "01-0123456789abcdef0123456789abcdef-0123456789abcdef-01"])
def test_traceparent_parses_as_jax(value):
    assert ttracing.parse_traceparent(value) == jtracing.parse_traceparent(value)


def _alerts(mod):
    reg = (jregistry if mod is jhealth else tregistry).MetricsRegistry()
    hm = mod.HealthMonitor(registry=reg, service="serve")
    rng = np.random.default_rng(0)
    for i in range(40):
        loss = float(rng.uniform(0.9, 1.1)) if i != 30 else float("nan")
        hm.observe_train({"epoch": i, "loss": loss, "step_time_s": 0.5 if i < 20 else 1.5})
        hm.observe_queue(60 if i > 25 else 3, 64)
    strip = lambda a: {k: v for k, v in a.items() if k not in ("time", "ts")}  # noqa: E731
    return [strip(a) for a in hm.alerts], reg.exposition()


def test_the_same_series_give_the_same_health_alerts():
    (ja, jexp), (ta, texp) = _alerts(jhealth), _alerts(thealth)
    assert ta == ja and len(ta) >= 3
    assert texp == jexp


def test_the_same_registry_content_renders_the_same_exposition():
    regs = []
    for mod in (jregistry, tregistry):
        r = mod.MetricsRegistry()
        r.counter("ddlpc_x_total", "x.", labelnames=("kind",)).inc(3, kind='a"b\\c')
        r.gauge("ddlpc_g", "g.").set(float("inf"))
        h = r.histogram("ddlpc_h_seconds", "h.", labelnames=("route",), buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 5.0, 1.0):
            h.observe(v, route="/predict")
        r.histogram("ddlpc_lat_seconds", "lat.").observe(0.003)
        regs.append(r)
    assert regs[1].exposition() == regs[0].exposition()
    assert regs[1].snapshot() == regs[0].snapshot()
    assert tregistry.sanitize_name("a.b-c") == jregistry.sanitize_name("a.b-c")
    with pytest.raises(ValueError):
        regs[1].gauge("ddlpc_x_total")


def test_metrics_logger_publishes_the_jsonl_stream_as_jax(tmp_path):
    from ddlpc_tpu.train.observability import MetricsLogger as JLogger
    from ddlpc_tpu_torch.train.observability import MetricsLogger

    out = []
    for cls, mod, name in ((JLogger, jregistry, "j"), (MetricsLogger, tregistry, "t")):
        reg = mod.MetricsRegistry()
        lg = cls(str(tmp_path / name), basename="serve_metrics")
        lg.attach_registry(reg)
        lg.log({"kind": "serve", "requests": 3, "p99_ms": 1.5, "mode": "int8", "ok": True,
                "time": 1.0}, echo=False)
        with open(tmp_path / name / "serve_metrics.jsonl") as f:
            rec = json.loads(f.read())
        with open(tmp_path / name / "serve_metrics.txt") as f:
            txt = f.read()
        out.append((rec, txt, reg.exposition()))
    assert out[1] == out[0]


def test_profiler_capture_writes_the_top_ops_report(tmp_path):
    """torch.profiler records the CPU ops of the thread that started it
    (a card's kernels from every thread): the work here runs in ``until``,
    on the capturing thread."""
    import torch

    n = [0]

    def until():
        torch.ones(64, 64) @ torch.ones(64, 64)
        n[0] += 1
        return n[0] >= 5

    res = tprofiling.capture(str(tmp_path / "p"), until=until, timeout_s=10)
    assert res["timed_out"] is False and "error" not in res
    rep = tprofiling.aggregate(str(tmp_path / "p"), steps=5, tag="t")
    assert set(rep) == {"tag", "trace_dir", "planes", "steps_traced", "device_total_ms",
                        "per_step_ms", "top_self_time"}
    assert rep["planes"] == ["cpu"] and rep["top_self_time"]
    assert {"op", "self_ms_per_step", "count"} == set(rep["top_self_time"][0])
    assert any(o["op"] == "aten::mm" and o["count"] == 5 for o in rep["top_self_time"])
    assert os.path.exists(tmp_path / "p" / "trace.json")
    bad = tprofiling.aggregate(str(tmp_path / "missing"), steps=1, tag="x")
    assert "error" in bad


def test_a_second_capture_is_busy():
    started = threading.Event()
    release = threading.Event()

    def first():
        tprofiling.capture("/nonexistent-never-written", until=lambda: started.set() or release.is_set(),
                           timeout_s=10)

    t = threading.Thread(target=first)
    t.start()
    started.wait(5)
    try:
        with pytest.raises(tprofiling.CaptureBusy):
            tprofiling.capture("unused", until=lambda: True)
    finally:
        release.set()
        t.join()
