"""The port's fleet tier against the JAX package's, on the same inputs.

Each test drives both packages through the same script — the same
configs, fake replicas, clocks, seeds and files — and compares what comes
out: router decisions (the replica each attempt went to), statuses,
counters, breaker states and ``router.jsonl`` records; SLO budgets, burn
rates and alerts; autoscaler decisions; cache keys and evictions;
telemetry rollups; merged traces; the fleet front end's protocol; the
rolling reload's answers; the supervisor's exit classification and
backoff.  Time fields are dropped; timing-bound behaviour is compared as
outcomes.
"""

import dataclasses
import functools
import http.client
import json
import os
import random
import signal
import threading

import pytest

from ddlpc_tpu import config as jconfig
from ddlpc_tpu.obs import aggregate as jaggregate
from ddlpc_tpu.obs import health as jhealth
from ddlpc_tpu.obs import merge as jmerge
from ddlpc_tpu.obs import registry as jregistry
from ddlpc_tpu.resilience import supervisor as jsupervisor
from ddlpc_tpu.serve import autoscale as jautoscale
from ddlpc_tpu.serve import cache as jcache
from ddlpc_tpu.serve import fleet as jfleet
from ddlpc_tpu.serve import router as jrouter
from ddlpc_tpu_torch import config as tconfig
from ddlpc_tpu_torch.obs import aggregate as taggregate
from ddlpc_tpu_torch.obs import health as thealth
from ddlpc_tpu_torch.obs import merge as tmerge
from ddlpc_tpu_torch.obs import registry as tregistry
from ddlpc_tpu_torch.resilience import supervisor as tsupervisor
from ddlpc_tpu_torch.serve import autoscale as tautoscale
from ddlpc_tpu_torch.serve import cache as tcache
from ddlpc_tpu_torch.serve import fleet as tfleet
from ddlpc_tpu_torch.serve import router as trouter
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = dict(config=jconfig, router=jrouter, health=jhealth, autoscale=jautoscale, cache=jcache,
           aggregate=jaggregate, merge=jmerge, registry=jregistry, supervisor=jsupervisor,
           fleet=jfleet)
PORT = dict(config=tconfig, router=trouter, health=thealth, autoscale=tautoscale, cache=tcache,
            aggregate=taggregate, merge=tmerge, registry=tregistry, supervisor=tsupervisor,
            fleet=tfleet)


TIMED = ("time", "p50_ms", "p95_ms", "p99_ms", "requests_per_sec", "uptime_s",
         "deploy_latency_s")


class Logger:
    """Collects the records a component logs (``router.jsonl``'s lines),
    without their time fields."""

    def __init__(self):
        self.records = []

    def log(self, rec, echo=True):
        self.records.append({k: v for k, v in rec.items() if k not in TIMED})


# ---- configs ----------------------------------------------------------------


def test_fleet_config_fields_defaults_and_refusal_equal_jax():
    j = [(f.name, f.default) for f in dataclasses.fields(jconfig.FleetConfig)]
    t = [(f.name, f.default) for f in dataclasses.fields(tconfig.FleetConfig)]
    assert t == j
    errors = []
    for cls in (jconfig.FleetConfig, tconfig.FleetConfig):
        with pytest.raises(ValueError) as e:
            cls.from_dict({"replicas": 2, "replicaz": 3, "device": "cuda"})
        errors.append(str(e.value))
    assert errors[0] == errors[1] == "unknown config key FleetConfig.device"


def test_fleet_vaihingen_config_and_replica_serve_config_equal_jax(tmp_path):
    with open(os.path.join(REPO, "configs", "fleet_vaihingen.json")) as f:
        text = f.read()
    j, t = jconfig.FleetConfig.from_json(text), tconfig.FleetConfig.from_json(text)
    assert t.to_dict() == j.to_dict()
    assert t.resolved_fleet_dir() == j.resolved_fleet_dir()
    for kw in ({}, {"quantize": "int8", "trace": True, "slots": 3, "fleet_dir": "x"}):
        jj, tt = j.replace(**kw), t.replace(**kw)
        assert (tt.replica_serve_config(str(tmp_path)).to_dict()
                == jj.replica_serve_config(str(tmp_path)).to_dict())
        assert tt.resolved_fleet_dir() == jj.resolved_fleet_dir()


# ---- the router ----------------------------------------------------------------

OK = (200, "application/x-npy", b"ok")
ERR = (500, "application/json", b'{"error": "boom"}')


class ScriptedReplica:
    """A fake replica whose answers follow a script keyed by the global
    call number; every call lands in the shared log."""

    def __init__(self, name, log, script, error_cls, health=None):
        self.name, self.log, self.script, self.error_cls = name, log, script, error_cls
        self.health = dict(health or {})

    def predict(self, body, query, timeout_s, cancel=None):
        n = len(self.log)
        self.log.append(self.name)
        out = self.script(self.name, n)
        if out == "timeout":
            raise self.error_cls(f"{self.name}: timed out")
        return out

    def healthz(self, timeout_s):
        h = {"status": "ok", "queue_depth": 0, "queue_limit": 64, "batch_occupancy": 0.5,
             "checkpoint_step": 1, "version": 0, "quant_mode": "int8"}
        h.update(self.health)
        return h

    def reload(self, payload, timeout_s):
        return 200, {"step": payload.get("step", 2), "version": 1}


def _script(name, n):
    """Answers by call number: a 5xx burst on ``a``, timeouts on ``b``."""
    if name == "a" and 6 <= n < 16:
        return ERR
    if name == "b" and n in (7, 11, 12):
        return "timeout"
    return OK


def _router_scenario(pkg, monkeypatch):
    """One scripted run: plain dispatches, a 5xx burst that opens a's
    breaker, transport timeouts on b, a drain and readmit, the cooldown
    and half-open probes, a scrape with a draining replica, the bounded
    zero-replica wait rescued on its third backoff, then a real outage."""
    R = pkg["router"]
    clock = [100.0]
    monkeypatch.setattr(R, "CircuitBreaker",
                        functools.partial(R.CircuitBreaker, clock=lambda: clock[0]))
    sleeps, log, logger = [], [], Logger()
    rescue = {}

    def sleep(s):
        sleeps.append(round(s, 12))
        if rescue and len(sleeps) == rescue["at"]:
            router.set_ready(rescue["name"], True)

    cfg = pkg["config"].FleetConfig(
        retries=2, hedge_ms=0.0, retry_backoff_ms=25.0, breaker_window=4,
        breaker_min_samples=4, breaker_error_rate=0.5, breaker_cooldown_s=2.0,
        breaker_half_open_probes=1, breaker_close_after=2, no_replica_wait_ms=2000.0,
        scrape_every_s=0.0, metrics_every_s=0.0, unhealthy_after=2,
    )
    router = R.FleetRouter(cfg, logger=logger, rng=random.Random(1234), sleep=sleep)
    replicas = {n: ScriptedReplica(n, log, _script, R.ReplicaError) for n in "abc"}
    for n, r in replicas.items():
        router.add_replica(n, r)
    statuses, breakers = [], []

    def go(k, query=""):
        for _ in range(k):
            statuses.append(router.dispatch(b"img", query)[0])
            breakers.append({s["name"]: s["breaker"] for s in router.replica_status()})

    go(14)
    router.drain("b", timeout_s=1.0)
    go(3)
    router.readmit("b")
    clock[0] += 2.5  # past a's cooldown: half-open probes
    go(6, "priority=batch")
    replicas["c"].health["status"] = "draining"
    router.scrape_once()
    go(3)
    for n in "abc":
        router.set_ready(n, False)
    rescue.update(at=len(sleeps) + 3, name="a")
    go(1)
    rescue.clear()
    router.set_ready("a", False)
    cfg_fast = dataclasses.replace(cfg, no_replica_wait_ms=0.0)
    router.cfg = cfg_fast
    go(1)
    snap = router.metrics.snapshot()
    counters = {k: v for k, v in snap.items() if k not in TIMED}
    expo = [ln for ln in router.registry.exposition().splitlines()
            if "latency_seconds" not in ln]
    return {"log": log, "statuses": statuses, "breakers": breakers, "sleeps": sleeps,
            "counters": counters, "records": logger.records, "exposition": expo,
            "healthz": {k: v for k, v in router.healthz().items() if k != "slo"}}


def test_router_scenario_equals_jax(monkeypatch):
    j = _router_scenario(JAX, monkeypatch)
    t = _router_scenario(PORT, monkeypatch)
    # The scenario reached every path it is about.
    assert j["counters"]["retries"] > 0 and j["counters"]["breaker_opens"] >= 1
    assert j["counters"]["breaker_half_opens"] >= 1 and j["counters"]["breaker_closes"] >= 1
    assert j["counters"]["drains"] == 1 and j["counters"]["readmissions"] == 1
    assert j["statuses"][-2] == 200 and j["statuses"][-1] == 503
    assert any(r.get("event") == "no_replicas" for r in j["records"])
    assert len(j["sleeps"]) > 3
    for key in j:
        assert t[key] == j[key], key


@pytest.mark.parametrize("seed", range(4))
def test_percentile_equals_jax(seed):
    rng = random.Random(seed)
    for n in (0, 1, 2, 7, 100, 1001):
        vals = sorted(rng.uniform(0, 10) for _ in range(n))
        for q in (0, 1, 37.5, 50, 95, 99, 99.9, 100):
            assert trouter._percentile(vals, q) == jrouter._percentile(vals, q)


# ---- SLO, autoscaler, cache ---------------------------------------------------


def _slo_trace(pkg):
    H = pkg["health"]
    t = [0.0]
    mon = H.HealthMonitor(service="router")
    reg = pkg["registry"].MetricsRegistry()
    slo = H.SLOTracker({"interactive": 0.2, "batch": 2.0}, availability=0.99,
                       budget_window_s=100.0,
                       windows=[("fast", 10.0, 5.0, "critical"), ("slow", 50.0, 1.5, "warn")],
                       min_requests=5, monitor=mon, registry=reg, clock=lambda: t[0])
    rng = random.Random(7)
    out = []
    for phase, bad_share, lat in ((0, 0.0, 0.01), (1, 1.0, 0.01), (2, 0.0, 0.5), (3, 0.3, 0.1)):
        for _ in range(60):
            t[0] += 0.37
            p = "batch" if rng.random() < 0.3 else "interactive"
            slo.observe(p, lat * rng.uniform(0.5, 2.0), rng.random() >= bad_share)
        out.append(("check", [(a.alert, a.severity, a.value, a.threshold, a.context)
                              for a in slo.check()]))
        out.append(("status", slo.status()))
        out.append(("burn", [slo.burn_rate(p, w) for p in ("interactive", "batch")
                             for w in (10.0, 50.0)]))
        out.append(("budget", [slo.error_budget_remaining(p) for p in ("interactive", "batch")]))
        t[0] += 11.0 * phase
    latch = H.BurnRateLatch("x", 10.0, 2.0, "warn")
    out.append(("latch", [latch.observe(b) for b in (0.5, 2.0, 3.0, 1.9, 2.5, 2.5)]))
    out.append(("alerts", [{k: v for k, v in a.items() if k != "time"} for a in mon.alerts]))
    out.append(("exposition", reg.exposition()))
    return out


def test_slo_tracker_and_burn_latch_equal_jax():
    j, t = _slo_trace(JAX), _slo_trace(PORT)
    assert any(kind == "check" and alerts for kind, alerts in j)
    assert t == j


def _autoscale_trace(pkg):
    class SLO:
        burn = 0.0

        def burn_rate(self, priority, window_s):
            return self.burn

    class Router:
        slo = SLO()
        statuses = []

        def replica_status(self):
            return list(self.statuses)

    class Supervisor:
        n = 2

        def replica_count(self):
            return self.n

        def scale_up(self):
            self.n += 1
            return f"r{self.n - 1}"

        def scale_down(self, name):
            self.n -= 1
            return True

    def status(i, queue, busy, breaker="closed", healthy=True):
        return {"name": f"r{i}", "ready": True, "healthy": healthy, "draining": False,
                "breaker": breaker, "queue_depth_interactive": queue, "slot_busy": busy}

    cfg = pkg["config"].FleetConfig(autoscale_min_replicas=1, autoscale_max_replicas=4,
                                     autoscale_cooldown_s=30.0)
    now = [0.0]
    router, sup, logger = Router(), Supervisor(), Logger()
    reg = pkg["registry"].MetricsRegistry()
    scaler = pkg["autoscale"].Autoscaler(cfg, router, sup, logger=logger, registry=reg,
                                         clock=lambda: now[0])
    rng = random.Random(3)
    decisions = []
    for step in range(80):
        now[0] += rng.choice((1.0, 5.0, 20.0, 40.0))
        idle = rng.random() < 0.4
        router.slo.burn = 0.0 if idle else rng.choice((0.0, 0.5, 3.0))
        router.statuses = [
            status(i, 0 if idle else rng.choice((0, 0.5, 2, 12)),
                   0.1 if idle else rng.choice((0.1, 0.5, 0.9)),
                   breaker=rng.choice(("closed", "closed", "open")),
                   healthy=rng.random() > 0.1)
            for i in range(sup.n)
        ]
        if step % 17 == 5:
            sup.n = 0  # a collapsed fleet
        decisions.append((scaler.evaluate(), sup.n))
    return decisions, logger.records, reg.exposition()


def test_autoscaler_decisions_equal_jax():
    j, t = _autoscale_trace(JAX), _autoscale_trace(PORT)
    actions = {a for a, _ in j[0]}
    assert {"scale_up", "scale_down", "suppressed_cooldown"} <= actions
    assert t == j


def test_response_key_byte_equal_jax():
    rng = random.Random(5)
    for _ in range(50):
        body = rng.randbytes(rng.randrange(0, 300))
        step = rng.randrange(0, 10**9)
        quant = rng.choice(("off", "int8", "bf16", "none", "ünï"))
        lid = rng.choice((None, "lineage_unknown", "0123456789abcdef"))
        assert (tcache.response_key(body, step, quant, lineage_id=lid)
                == jcache.response_key(body, step, quant, lineage_id=lid))


def _cache_trace(pkg):
    C = pkg["cache"]
    cache = C.ResponseCache(1000)
    rng = random.Random(9)
    out = []
    keys = [C.response_key(bytes([i]), 1, "int8") for i in range(12)]
    for i in range(200):
        k = rng.choice(keys)
        op = rng.random()
        if op < 0.5:
            out.append(("get", cache.get(k)))
        elif op < 0.95:
            status = rng.choice((200, 200, 200, 503))
            out.append(("put", cache.put(k, (status, "x", b"p" * rng.choice((10, 100, 400, 1200))))))
        else:
            out.append(("invalidate", cache.invalidate("step_change")))
        out.append(("stats", cache.stats()))
    return out


def test_cache_lru_and_invalidation_equal_jax():
    j, t = _cache_trace(JAX), _cache_trace(PORT)
    assert j[-1][1]["cache_evictions"] > 0 and j[-1][1]["cache_invalidations"] > 0
    assert t == j


def _router_cache_trace(pkg, monkeypatch):
    """The router's step-change invalidation: a cached answer, a reload
    that moves the consensus step, the invalidation record."""
    log, logger = [], Logger()
    cfg = pkg["config"].FleetConfig(cache_max_bytes=10_000, hedge_ms=0.0, scrape_every_s=0.0,
                                    metrics_every_s=0.0)
    router = pkg["router"].FleetRouter(cfg, logger=logger, rng=random.Random(0))
    reps = [ScriptedReplica(n, log, lambda n, i: OK, pkg["router"].ReplicaError) for n in "ab"]
    for r in reps:
        router.add_replica(r.name, r)
    router.scrape_once()
    info = []
    for body in (b"x", b"x", b"y", b"x"):
        d = {}
        router.dispatch(body, "", info=d)
        info.append(d)
    for r in reps:
        r.health["checkpoint_step"] = 2
    router.scrape_once()
    for body in (b"x", b"x"):
        d = {}
        router.dispatch(body, "", info=d)
        info.append(d)
    router.invalidate_cache("rolling_reload")
    router.emit()
    return log, info, logger.records, router.cache.stats()


def test_router_cache_hits_and_step_invalidation_equal_jax(monkeypatch):
    j, t = _router_cache_trace(JAX, monkeypatch), _router_cache_trace(PORT, monkeypatch)
    assert j[3]["cache_hits"] == 3 and j[3]["cache_invalidations"] >= 1
    assert t == j


# ---- aggregation and tracing -------------------------------------------------


def _aggregate_trace(pkg):
    R, A = pkg["registry"], pkg["aggregate"]
    clock = [0.0]
    regs = [R.MetricsRegistry() for _ in range(3)]
    for i, r in enumerate(regs):
        r.counter("ddlpc_serve_requests_total", "reqs", labelnames=("priority",)).inc(
            10 * (i + 1), priority="interactive")
        r.gauge("ddlpc_serve_queue_depth", "depth").set(5 * (i + 1))
        r.counter("ddlpc_router_attempts_total", "att", labelnames=("replica", "reason")).inc(
            i + 1, replica=f"r{i}", reason="primary")
        h = r.histogram("ddlpc_serve_request_latency_seconds", "lat")
        for v in (0.01, 0.2 * (i + 1), 3.0):
            h.observe(v)
    agg = A.TelemetryAggregator(stale_after_s=5.0, clock=lambda: clock[0])
    dead = {"r1": False}

    def fetch(i):
        def f():
            if dead.get(f"r{i}"):
                raise OSError("connection refused")
            return regs[i].exposition()
        return f

    for i in range(3):
        agg.add_source(f"r{i}", fetch(i))
    agg.add_source("router", lambda: "garbage line\n# TYPE x\n" + regs[0].exposition())
    out = []
    clock[0] = 1.0
    out.append(agg.scrape_once())
    out.append(agg.exposition())
    dead["r1"] = True  # r1 stops answering: stale after 5 s
    clock[0] = 8.0
    out.append(agg.scrape_once())
    out.append(agg.exposition())
    out.append(agg.snapshot())
    # r2 restarts: removed at death, a fresh process (counters from 0) added.
    agg.remove_source("r2")
    fresh = R.MetricsRegistry()
    fresh.counter("ddlpc_serve_requests_total", "reqs", labelnames=("priority",)).inc(
        1, priority="interactive")
    agg.add_source("r2", fresh.exposition)
    out.append(agg.scrape_once())
    out.append(agg.exposition())
    out.append(agg.snapshot())
    out.append(sorted(A.parse_exposition(agg.exposition())))
    return out


def test_aggregator_rollups_equal_jax():
    j, t = _aggregate_trace(JAX), _aggregate_trace(PORT)
    assert 'ddlpc_fleet_source_stale{replica="r1"} 1' in j[3]
    assert t == j


def _span_files(tmp_path):
    """Span streams of a router and two replicas (one hedged request, one
    retried request, one cache hit), plus a lineage record stream."""
    tid1, tid2, tid3 = "a" * 32, "b" * 32, "c" * 32
    recs = {
        "router_spans.jsonl": [
            {"kind": "span", "name": "route_request", "time": 10.0, "dur_s": 0.5,
             "trace_id": tid1, "service": "router", "pid": 1, "tid": 1, "status": 200,
             "model_step": 3, "lineage_id": "L3", "priority": "interactive"},
            {"kind": "span", "name": "router_attempt", "time": 10.01, "dur_s": 0.49,
             "trace_id": tid1, "service": "router", "pid": 1, "tid": 2, "replica": "r0",
             "reason": "primary", "span_hex": "1" * 16, "status": 200, "cancelled": True},
            {"kind": "span", "name": "router_attempt", "time": 10.2, "dur_s": 0.2,
             "trace_id": tid1, "service": "router", "pid": 1, "tid": 3, "replica": "r1",
             "reason": "hedge", "span_hex": "2" * 16, "status": 200, "cancelled": False},
            {"kind": "span", "name": "route_request", "time": 11.0, "dur_s": 0.3,
             "trace_id": tid2, "service": "router", "pid": 1, "tid": 1, "status": 200},
            {"kind": "span", "name": "router_attempt", "time": 11.0, "dur_s": 0.1,
             "trace_id": tid2, "service": "router", "pid": 1, "tid": 2, "replica": "r1",
             "reason": "primary", "span_hex": "3" * 16, "status": 503},
            {"kind": "span", "name": "router_attempt", "time": 11.12, "dur_s": 0.15,
             "trace_id": tid2, "service": "router", "pid": 1, "tid": 2, "replica": "r0",
             "reason": "retry", "span_hex": "4" * 16, "status": 200},
            {"kind": "span", "name": "cache_hit", "time": 12.0, "dur_s": 0.001,
             "trace_id": tid3, "service": "router", "pid": 1, "tid": 1, "status": 200,
             "model_step": 3, "lineage_id": "L3"},
        ],
        os.path.join("r0", "serve_spans.jsonl"): [
            {"kind": "span", "name": "serve_request", "time": 10.05, "dur_s": 0.4,
             "trace_id": tid1, "remote_parent": "1" * 16, "service": "serve", "pid": 2, "tid": 1},
            {"kind": "span", "name": "window_plan", "time": 10.06, "dur_s": 0.01,
             "trace_id": tid1, "service": "serve", "pid": 2, "tid": 1},
            {"kind": "span", "name": "batch_coalesce", "time": 10.1, "dur_s": 0.02,
             "trace_ids": [tid1, tid2], "service": "serve", "pid": 2, "tid": 5},
            {"kind": "span", "name": "jit_execute", "time": 10.12, "dur_s": 0.2,
             "trace_ids": [tid1, tid2], "service": "serve", "pid": 2, "tid": 5},
            {"kind": "span", "name": "serve_request", "time": 11.13, "dur_s": 0.12,
             "trace_id": tid2, "remote_parent": "4" * 16, "service": "serve", "pid": 2, "tid": 1},
            {"kind": "span", "name": "stitch", "time": 11.2, "dur_s": 0.03,
             "trace_id": tid2, "service": "serve", "pid": 2, "tid": 1},
        ],
        os.path.join("r1", "serve_spans.jsonl"): [
            {"kind": "span", "name": "serve_request", "time": 10.21, "dur_s": 0.15,
             "trace_id": tid1, "remote_parent": "2" * 16, "service": "serve", "pid": 3, "tid": 1},
            {"kind": "span", "name": "enqueue", "time": 10.22, "dur_s": 0.005,
             "trace_id": tid1, "service": "serve", "pid": 3, "tid": 1},
        ],
        "router.jsonl": [
            {"kind": "lineage", "event": "checkpoint_saved", "lineage_id": "L3",
             "lineage_saved_at": 5.0, "time": 5.1, "step": 3},
            {"kind": "serve_reload", "lineage_id": "L3", "time": 9.0, "step": 3},
            {"kind": "lineage", "event": "fleet_serving", "lineage_id": "L3", "time": 9.5},
        ],
    }
    for rel, lines in recs.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text("\n".join(json.dumps(r) for r in lines) + "\n{torn line\n")
    return tmp_path


def _merge_trace(pkg, root):
    M = pkg["merge"]
    files = M.fleet_span_files(str(root))
    spans = M.read_spans(files)
    records = M.read_records(files + [str(root / "router.jsonl")])
    out = [
        [os.path.relpath(f, root) for f in files],
        M.trace_ids(spans),
        M.build_timeline(spans),
        *[M.build_timeline(spans, trace_id=t) for t in M.trace_ids(spans)],
        *[M.attribution(spans, t) for t in M.trace_ids(spans)],
        M.summarize_requests(spans),
        M.lineage_timeline(records, "L3"),
        M.filter_lineage(records, "L3"),
    ]
    M.write_trace(out[2], str(root / f"merged_{id(M)}.json"))
    with open(root / f"merged_{id(M)}.json") as f:
        out.append(json.load(f))
    return json.loads(json.dumps(out))


def test_merge_equals_jax(tmp_path):
    root = _span_files(tmp_path)
    j, t = _merge_trace(JAX, root), _merge_trace(PORT, root)
    assert j[2]["metadata"]["processes"] == 3 and len(j[1]) == 3
    assert t == j


# ---- the fleet front end and the rolling reload -------------------------------


class ReloadClient:
    """A fake replica for the rolling reload: the step it serves, a
    scripted outcome per reload call."""

    def __init__(self, name, outcomes, log):
        self.name, self.step, self.outcomes, self.log = name, 1, list(outcomes), log

    def healthz(self, timeout_s):
        return {"status": "ok", "checkpoint_step": self.step, "queue_depth": 0,
                "quant_mode": "int8", "lineage_id": f"L{self.step}",
                "lineage_saved_at": 1000.0 + self.step}

    def reload(self, payload, timeout_s):
        self.log.append((self.name, dict(payload)))
        outcome = self.outcomes.pop(0) if self.outcomes else "ok"
        if outcome == "quarantine":
            return 200, {"step": self.step, "quarantined_steps": [self.step + 1]}
        if outcome == "error":
            return 503, {"error": "IOError: disk", "error_type": "OSError", "step": self.step}
        self.step = payload.get("step", self.step + 1)
        return 200, {"step": self.step, "version": 1,
                     "lineage": {"lineage_id": f"L{self.step}", "saved_at": None}}

    def predict(self, body, query, timeout_s, cancel=None):
        return 200, "application/x-npy", b"ok"


def _fleet(pkg, outcomes, tmp_path):
    log, logger = [], Logger()
    cfg = pkg["config"].FleetConfig(
        replicas=len(outcomes), workdir=str(tmp_path), quantize="int8", scrape_every_s=0.0,
        metrics_every_s=0.0, drain_timeout_s=0.5, scrape_timeout_s=0.2, hedge_ms=0.0,
        cache_max_bytes=1000)
    router = pkg["router"].FleetRouter(cfg, logger=logger, rng=random.Random(0))
    sup = pkg["fleet"].ReplicaSupervisor(cfg, router=router, logger=logger, echo=False)
    clients = [ReloadClient(f"r{i}", o, log) for i, o in enumerate(outcomes)]
    for rp, cl in zip(sup.replicas, clients):
        rp.client = cl
        rp.ready_evt.set()
        router.add_replica(rp.name, cl)
    return sup, router, clients, log, logger


ROLLING = {
    "success": [["ok"], ["ok"], ["ok"]],
    "quarantine_on_second": [["ok"], ["quarantine"], ["ok"]],
    "error_on_first": [["error"], ["ok"]],
    "quarantine_on_last": [["ok", "ok"], ["ok", "ok"], ["quarantine"]],
}


@pytest.mark.parametrize("case", sorted(ROLLING))
def test_rolling_reload_answers_equal_jax(case, tmp_path):
    outs = []
    for pkg in (JAX, PORT):
        sup, router, clients, log, logger = _fleet(pkg, ROLLING[case], tmp_path)
        res = sup.rolling_reload()
        res2 = sup.rolling_reload(step=1)
        router.scrape_once()
        outs.append((res, res2, log, [c.step for c in clients], logger.records,
                     router.metrics.snapshot()["reloads_ok"],
                     router.metrics.snapshot()["reloads_aborted"],
                     router.dispatch(b"img")[0], sup.status()))
    j, t = outs
    assert t == j
    if case != "success":
        res = j[0]
        assert res["ok"] is False and res["rollback_clean"] is True
        assert all(step == 1 for step in j[3])  # every replica back on the old step


def _serve_fleet(pkg, router, sup=None, agg=None):
    server = pkg["fleet"].make_fleet_server(router, sup, "127.0.0.1", 0, aggregator=agg)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server, t


def _req(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def _keys(obj):
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(v) for v in obj]
    return type(obj).__name__


def _front_end_trace(pkg, tmp_path):
    sup, router, clients, _, _ = _fleet(pkg, [["ok"], ["quarantine"]], tmp_path)
    agg = pkg["aggregate"].TelemetryAggregator(stale_after_s=60.0)
    reg = pkg["registry"].MetricsRegistry()
    reg.counter("ddlpc_serve_requests_total", "reqs").inc(3)
    agg.add_source("r0", reg.exposition)
    agg.add_source("router", router.registry.exposition)
    router.scrape_once()
    bare = pkg["router"].FleetRouter(pkg["config"].FleetConfig(scrape_every_s=0.0,
                                                               metrics_every_s=0.0))
    out = []
    for rt, s, a in ((router, sup, agg), (bare, None, None)):
        server, t = _serve_fleet(pkg, rt, s, a)
        port = server.server_address[1]
        try:
            if a is not None:
                agg.scrape_once()
            for method, path, body, hdr in (
                ("GET", "/healthz", None, None),
                ("GET", "/fleet", None, None),
                ("GET", "/nope", None, None),
                ("POST", "/predict", b"img", {"traceparent": "00-" + "a" * 32 + "-" + "b" * 16 + "-01"}),
                ("POST", "/predict?cache=bypass", b"img", None),
                ("POST", "/reload", b"{not json", None),
                ("POST", "/reload", b"{}", None),
                ("POST", "/nope", b"", None),
                ("GET", "/metrics", None, None),
                ("GET", "/metrics", None, {"Accept": "text/plain"}),
            ):
                status, headers, payload = _req(port, method, path, body, hdr)
                ctype = headers.get("Content-Type")
                row = [method, path, status, ctype, headers.get("X-DDLPC-Model-Step")]
                if ctype == "application/json":
                    doc = json.loads(payload)
                    if path == "/metrics":
                        doc = sorted(doc)
                    elif isinstance(doc, dict) and "slo" in doc:
                        doc = _keys(doc)
                    else:
                        doc = _keys(doc) if path in ("/healthz", "/fleet") else doc
                    row.append(doc)
                elif ctype and ctype.startswith("text/plain"):
                    row.append(sorted({ln.split()[2] for ln in payload.decode().splitlines()
                                       if ln.startswith("# TYPE")}))
                else:
                    row.append(payload)
                out.append(row)
        finally:
            server.shutdown()
            server.server_close()
            t.join(5)
    return out


def test_fleet_front_end_protocol_equals_jax(tmp_path):
    j = _front_end_trace(JAX, tmp_path / "j")
    t = _front_end_trace(PORT, tmp_path / "t")
    families = next(r[-1] for r in j if r[1] == "/metrics" and r[3].startswith("text/plain"))
    assert any(f.startswith("ddlpc_fleet_") for f in families)
    assert any(f.startswith("ddlpc_router_") for f in families)
    assert [r[2] for r in j if r[1] == "/reload"][:2] == [400, 409]
    assert t == j


# ---- the training supervisor ---------------------------------------------------

CRUMBS = [None, {"phase": "running"}, {"phase": "stalled"}, {"phase": "preempted"},
          {"phase": "preempt_timeout"}, {"phase": "done"}, {}]
CODES = [0, 1, 2, 42, 43, 137, 139, -signal.SIGKILL, -signal.SIGTERM, -signal.SIGSEGV, 255]


def test_classify_exit_equals_jax():
    for rc in CODES:
        for crumb in CRUMBS:
            assert (tsupervisor.classify_exit(rc, crumb)
                    == jsupervisor.classify_exit(rc, crumb)), (rc, crumb)
    assert tsupervisor.classify_exit(-signal.SIGKILL, {"phase": "running"}) == "oom_kill"
    assert tsupervisor.classify_exit(42, None) == "stall"


@pytest.mark.parametrize("seed", range(3))
def test_restart_policy_equals_jax(seed):
    outs = []
    for S in (jsupervisor, tsupervisor):
        pol = S.RestartPolicy(max_restarts=12, crash_loop_limit=4, backoff_base_s=0.5,
                              backoff_cap_s=7.0, rng=random.Random(seed))
        rng = random.Random(seed + 100)
        trace = []
        for _ in range(20):
            d = pol.record_exit(progressed=rng.random() < 0.3)
            trace.append((d, pol.fail_streak, pol.attempts, pol.delay_s(),
                          [pol.backoff_s(k) for k in range(-1, 6)]))
        outs.append(trace)
    assert outs[0] == outs[1]


class FakeChild:
    def __init__(self, rc, on_wait):
        self.rc, self.on_wait, self.pid = rc, on_wait, 4242

    def wait(self):
        self.on_wait()
        return self.rc

    def poll(self):
        return self.rc


def _supervise(S, workdir, plan, crash_loop_limit=3):
    """A Supervisor over fake children: each attempt's exit status and
    what it leaves behind (breadcrumb phase, checkpoint step)."""
    os.makedirs(os.path.join(workdir, "checkpoints"), exist_ok=True)
    sleeps, envs = [], []

    def popen(cmd, env=None):
        n = len(envs)
        envs.append(env)
        rc, phase, step = plan[min(n, len(plan) - 1)]

        def on_wait():
            if step is not None:
                open(os.path.join(workdir, "checkpoints", f"ckpt_{step}.dwc"), "w").close()
            with open(os.path.join(workdir, "checkpoints", f"tmp{n}.tmp"), "w"):
                pass  # a torn write is no progress
            if phase is not None:
                with open(os.path.join(workdir, "breadcrumb.json"), "w") as f:
                    json.dump({"phase": phase, "pid": 4242}, f)
        return FakeChild(rc, on_wait)

    sup = S.Supervisor(["train"], workdir, crash_loop_limit=crash_loop_limit,
                       backoff_base_s=1.0, backoff_cap_s=8.0,
                       env_fn=lambda a: {"DDLPC_CHAOS": f"kill@{a + 1}"},
                       sleep=sleeps.append, rng=random.Random(11), popen=popen, echo=False)
    res = sup.run()
    with open(os.path.join(workdir, "resilience.jsonl")) as f:
        recs = [{k: v for k, v in json.loads(ln).items() if k != "time"} for ln in f]
    return (res.final_status, res.attempts, res.restarts_by_cause, res.gave_up, res.ok,
            res.reason, sleeps, envs, recs, sup.registry.exposition())


PLANS = {
    "kill_stall_clean": [(-signal.SIGKILL, "running", 1), (42, "stalled", 2), (0, "done", 3)],
    "crash_loop": [(1, "running", None)],
    "preempt_then_clean": [(43, "preempted", None), (43, "preempt_timeout", None),
                           (139, None, None), (0, "done", 4)],
}


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_supervisor_run_equals_jax(plan, tmp_path):
    j = _supervise(jsupervisor, str(tmp_path / "j"), PLANS[plan])
    t = _supervise(tsupervisor, str(tmp_path / "t"), PLANS[plan])
    assert t == j
    if plan == "kill_stall_clean":
        assert j[4] and j[2] == {"oom_kill": 1, "stall": 1} and j[6] == []
    if plan == "crash_loop":
        assert j[3] and len(j[6]) == 2


# ---- a peer that hangs up (the router's cancelled hedge loser) ----------------


def test_server_ends_hung_up_connections_quietly(capsys):
    """The router cancels a hedge loser by closing its connection under it.
    The port's server then finishes the work, ends that connection without
    a traceback (the JAX server prints one per connection: ROADMAP C14) and
    keeps serving: no request stays counted in flight."""
    import io
    import socket
    import struct
    import time

    import numpy as np

    from ddlpc_tpu_torch.config import ServeConfig
    from ddlpc_tpu_torch.serve import server as tserver

    class Engine:
        tile, channels, version, checkpoint_step, compiled_shapes = (32, 32), 3, 0, 1, 1

        def forward_windows(self, windows):
            time.sleep(0.2)
            return np.zeros((len(windows), 32, 32, 4), np.float32)

    frontend = tserver.ServingFrontend(Engine(), ServeConfig(metrics_every_s=0, max_batch=4))
    server = tserver.make_server(frontend, "127.0.0.1", 0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    port = server.server_address[1]
    buf = io.BytesIO()
    np.save(buf, np.zeros((32, 32, 3), np.float32))
    body = buf.getvalue()
    try:
        for _ in range(3):
            s = socket.create_connection(("127.0.0.1", port))
            s.sendall(b"POST /predict HTTP/1.1\r\nHost: x\r\nContent-Length: %d\r\n\r\n"
                      % len(body) + body)
            time.sleep(0.05)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
            s.close()  # a reset, not a polite close
        time.sleep(1.0)
        status, _, _ = _req(port, "POST", "/predict", body)
        assert status == 200
        assert server.wait_idle(timeout=10)  # the answered request's own count ends after its write
        assert frontend.metrics.snapshot(advance=False)["requests"] == 4
    finally:
        server.shutdown()
        frontend.close()
        server.server_close()
        t.join(5)
    err = capsys.readouterr().err
    assert "Traceback" not in err and "ConnectionResetError" not in err, err


# ---- readiness carries the replica's state (ROADMAP C19) ---------------------


def test_a_replica_declared_ready_reports_its_step_before_any_scrape(tmp_path):
    """The fleet CLI printed "2/2 replicas ready" and its ``/healthz`` then
    answered ``checkpoint_steps: []`` until the router's next scrape
    pass, which a loaded host delays (``tests/test_torch_fleet_procs.py``
    failed so in 5 of 10 runs beside other process-heavy test files under
    six test workers).  The ``/healthz`` answer that makes the supervisor
    declare a replica ready is now its first scrape: the fleet names the
    step as soon as it counts the replica.  No scrape runs here
    (``scrape_every_s=0``)."""
    cfg = tconfig.FleetConfig(replicas=1, workdir=str(tmp_path), scrape_every_s=0.0,
                              metrics_every_s=0.0, hedge_ms=0.0)
    router = trouter.FleetRouter(cfg, logger=Logger())
    sup = tfleet.ReplicaSupervisor(cfg, router=router, logger=Logger(), echo=False)
    rp = sup.replicas[0]
    answer = {"status": "ok", "checkpoint_step": 7, "queue_depth": 0, "quant_mode": "int8"}
    exited = threading.Event()

    def launch(r):
        r.proc, r.client = FakeChild(0, exited.wait), object()

    sup._launch, sup._wait_ready = launch, lambda r: answer
    loop = threading.Thread(target=sup._run_replica, args=(rp,), daemon=True)
    loop.start()
    try:
        assert rp.ready_evt.wait(10)
        health = router.healthz()
        assert health["ready"] == 1 and health["checkpoint_steps"] == [7], health
        status = router.replica_status()[0]
        assert status["checkpoint_step"] == 7 and status["quant_mode"] == "int8"
    finally:
        sup._stop.set()
        exited.set()
        loop.join(10)
    assert not loop.is_alive()
