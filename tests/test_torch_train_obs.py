"""The trainer's observability against the JAX trainer's, on the CPU.

One tiny config and seed run through both trainers with ``train.trace``,
``trace_sync_every_steps=1``, ``telemetry_port=0`` and ``profile_epoch=0``,
under the chaos harness's ``nan@1`` (the first epoch record's loss
poisoned), and once more through the port untraced.  Held here:

- the multiset of span names, each with its parent's name, in
  ``spans.jsonl`` equals JAX's (every span both packages have: the
  ``epoch``, its ``step_sync`` children, ``evaluate``,
  ``checkpoint_snapshot``, ``checkpoint_barrier``, and the loop's and the
  host loader's stages; neither package has a span the other lacks);
- the ``kind="lineage"`` records' keys equal JAX's, and the port's
  ``obs/merge.py`` lineage timeline reads the port's streams;
- the port's whole workdir passes ``scripts/check_metrics_schema.py``;
- the ``loss_nonfinite`` alert records (less ``time``) equal JAX's, in the
  health monitor and in the watchdog's ring;
- the traced losses equal the untraced run's bit for bit.

And the repair of the untimestamped stream: an untraced fit's
``metrics.jsonl`` passes the JAX package's lint, with its ``metrics.txt``
and the registry's gauges (all three were missing before the trainer
logged through ``MetricsLogger``).
"""

import collections
import json
import os
import struct
import sys

import pytest
import torch

import ddlpc_tpu.obs.comm as jcomm
import ddlpc_tpu.obs.merge as jmerge
import ddlpc_tpu.resilience.chaos as jchaos
from ddlpc_tpu.config import CompressionConfig as JCompressionConfig
from ddlpc_tpu.config import ExperimentConfig as JExperimentConfig
from ddlpc_tpu.obs.registry import MetricsRegistry as JMetricsRegistry
from ddlpc_tpu_torch.config import CompressionConfig, ExperimentConfig
from ddlpc_tpu_torch.obs import comm as tcomm
from ddlpc_tpu_torch.obs import merge as tmerge
from ddlpc_tpu_torch.obs.registry import MetricsRegistry
from ddlpc_tpu_torch.resilience import chaos as tchaos
from ddlpc_tpu_torch.train.trainer import Trainer

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import check_metrics_schema as lint  # noqa: E402 — the JAX package's stream lint
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

BASE = {
    "model": {"features": [8], "bottleneck_features": 8, "num_classes": 3},
    "data": {"image_size": [32, 32], "synthetic_len": 12, "test_split": 4, "num_classes": 3},
    "train": {"epochs": 2, "micro_batch_size": 1, "sync_period": 2, "dump_images_per_epoch": 0},
    "parallel": {"data_axis_size": 1},
}
TRACED = {"trace": True, "trace_sync_every_steps": 1, "telemetry_port": 0, "profile_epoch": 0}
CHAOS = "nan@1"
UNSTAMPED = ("time",)


def _config(workdir: str, traced: bool, port: bool) -> dict:
    d = json.loads(json.dumps(BASE))
    if traced:
        d["train"].update(TRACED)
    if port:
        d["parallel"] = {"data_axis_size": -1}
    return {**d, "workdir": workdir}


def _fit(trainer):
    try:
        trainer.fit()
        return {"alerts": trainer.health.alerts, "ring": trainer.watchdog.recent_alerts()}
    finally:
        trainer.close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three fits, once for the module: JAX traced, the port untraced,
    the port traced, each under a fresh ``nan@1`` schedule."""
    from ddlpc_tpu.train.trainer import Trainer as JTrainer

    root = tmp_path_factory.mktemp("obs")
    prev = os.environ.get(tchaos.ENV)
    out = {}
    try:
        os.environ[tchaos.ENV] = CHAOS
        for mod in (jchaos, tchaos):
            mod._cache_spec, mod._cache_monkey = None, None
        out["jax"] = _fit(JTrainer(JExperimentConfig.from_dict(
            _config(str(root / "jax"), traced=True, port=False)), resume=False))
        for name, traced in (("untraced", False), ("port", True)):
            tchaos._cache_spec, tchaos._cache_monkey = None, None
            out[name] = _fit(Trainer(ExperimentConfig.from_dict(
                _config(str(root / name), traced=traced, port=True)), resume=False, device="cpu"))
    finally:
        if prev is None:
            os.environ.pop(tchaos.ENV, None)
        else:
            os.environ[tchaos.ENV] = prev
        for mod in (jchaos, tchaos):
            mod._cache_spec, mod._cache_monkey = None, None
    for name in out:
        out[name]["dir"] = str(root / name)
    return out


def _records(workdir: str, name: str = "metrics.jsonl") -> list:
    with open(os.path.join(workdir, name)) as f:
        return [json.loads(line) for line in f]


def _span_tree(workdir: str) -> collections.Counter:
    spans = _records(workdir, "spans.jsonl")
    names = {s["span_id"]: s["name"] for s in spans}
    return collections.Counter((s["name"], names.get(s["parent_id"])) for s in spans)


def test_span_names_and_parents_equal_jax(runs):
    port, jax_tree = _span_tree(runs["port"]["dir"]), _span_tree(runs["jax"]["dir"])
    assert port == jax_tree
    # 2 epochs of 4 steps, a step_sync a step, an eval and a save an epoch.
    assert port[("step_sync", "epoch")] == 8 and port[("epoch", None)] == 2
    assert port[("evaluate", None)] == port[("checkpoint_snapshot", None)] == 2
    assert port[("checkpoint_barrier", None)] == 1
    assert {"data", "step", "loader_gather", "loader_upload"} <= {n for n, _ in port}
    with open(os.path.join(runs["port"]["dir"], "trace.json")) as f:
        doc = json.load(f)
    assert {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"} == {n for n, _ in port}
    # The untraced run writes no spans; the per-epoch profile is the traced
    # run's (epoch 0).
    assert not os.path.exists(os.path.join(runs["untraced"]["dir"], "spans.jsonl"))
    for name in ("ops.json", "trace.json"):
        assert os.path.isfile(os.path.join(runs["port"]["dir"], "profile", name))


def test_step_sync_lies_inside_the_step_stage(runs):
    """The sampled sync stays in the ``step`` stage, so that ``t_step_s``
    and the productive time behind goodput mean the same traced or not:
    every ``step_sync`` span lies inside a ``step`` span (to the stream's
    microsecond rounding of ``time``)."""
    spans = _records(runs["port"]["dir"], "spans.jsonl")
    steps = [(s["time"], s["time"] + s["dur_s"]) for s in spans if s["name"] == "step"]
    syncs = [(s["time"], s["time"] + s["dur_s"]) for s in spans if s["name"] == "step_sync"]
    assert len(syncs) == len(steps) == 8
    for a, b in syncs:
        assert any(t0 - 2e-6 <= a and b <= t1 + 2e-6 for t0, t1 in steps), (a, b)


def test_lineage_records_keys_equal_jax_and_merge_reads_them(runs):
    port = [r for r in _records(runs["port"]["dir"]) if r.get("kind") == "lineage"]
    jax_recs = [r for r in _records(runs["jax"]["dir"]) if r.get("kind") == "lineage"]
    assert [sorted(r) for r in port] == [sorted(r) for r in jax_recs]
    assert [(r["event"], r["epoch"], r["lineage_step"]) for r in port] == [
        (r["event"], r["epoch"], r["lineage_step"]) for r in jax_recs]
    # Each checkpoint_saved record names the checkpoint the trainer wrote.
    from ddlpc_tpu_torch.train import checkpoint as tckpt

    meta = tckpt.peek_metadata(os.path.join(runs["port"]["dir"], "checkpoints"))
    assert meta["lineage"]["lineage_id"] == port[-1]["lineage_id"]
    streams = [os.path.join(runs["port"]["dir"], n) for n in ("metrics.jsonl", "spans.jsonl")]
    jstreams = [os.path.join(runs["jax"]["dir"], n) for n in ("metrics.jsonl", "spans.jsonl")]
    records, jrecords = tmerge.read_records(streams), jmerge.read_records(jstreams)
    for rec, jrec in zip(port, jax_recs):
        line = tmerge.lineage_timeline(records, rec["lineage_id"])
        jline = jmerge.lineage_timeline(jrecords, jrec["lineage_id"])
        assert line["saved_at"] == rec["lineage_saved_at"]
        assert [(e["kind"], e["event"]) for e in line["events"]] == [
            (e["kind"], e["event"]) for e in jline["events"]] == [
            ("span", "checkpoint_snapshot"), ("lineage", "checkpoint_saved")]
        assert line["records"] == jline["records"] == 2


def test_port_workdir_passes_the_schema_lint(runs):
    assert lint.main([runs["port"]["dir"]]) == 0
    assert lint.main([runs["untraced"]["dir"]]) == 0
    kinds = collections.Counter(r.get("kind", "train") for r in _records(runs["port"]["dir"]))
    assert kinds == {"train": 2, "perf": 2, "comm": 2, "lineage": 2, "alert": 1}


def _strip(alerts: list) -> list:
    return [{k: v for k, v in a.items() if k not in UNSTAMPED} for a in alerts]


def test_nan_alert_records_equal_jax(runs):
    port, jax_run = runs["port"], runs["jax"]
    assert _strip(port["alerts"]) == _strip(jax_run["alerts"])
    (alert,) = _strip(port["alerts"])
    assert (alert["alert"], alert["severity"], alert["service"]) == ("loss_nonfinite", "critical",
                                                                     "train")
    assert _strip(port["ring"]) == _strip(jax_run["ring"]) == [alert]
    streamed = [r for r in _records(port["dir"]) if r.get("kind") == "alert"]
    jstreamed = [r for r in _records(jax_run["dir"]) if r.get("kind") == "alert"]
    drop = UNSTAMPED + ("schema",)
    assert [{k: v for k, v in r.items() if k not in drop} for r in streamed] == [
        {k: v for k, v in r.items() if k not in drop} for r in jstreamed] == [alert]


def _bits(x: float) -> bytes:
    return struct.pack("<d", x)


def test_traced_losses_equal_the_untraced_runs_bit_for_bit(runs):
    traced = [r for r in _records(runs["port"]["dir"]) if "kind" not in r]
    untraced = [r for r in _records(runs["untraced"]["dir"]) if "kind" not in r]
    assert len(traced) == len(untraced) == 2
    for a, b in zip(traced, untraced):
        for key in ("loss", "grad_norm", "pixel_acc", "val_loss", "val_miou"):
            assert _bits(a[key]) == _bits(b[key]), (key, a[key], b[key])
    # nan@1 poisoned the first record of both.
    assert traced[0]["loss"] != traced[0]["loss"]


def test_untraced_fit_stream_passes_the_jax_lint_with_txt_and_gauges(tmp_path):
    """The repair: every record the trainer writes carries ``time`` and
    ``schema``, a ``metrics.txt`` line, and its numeric scalars as gauges
    of the run's registry (so a scrape shows the loss)."""
    cfg = ExperimentConfig.from_dict(_config(str(tmp_path / "run"), traced=False, port=True))
    trainer = Trainer(cfg, resume=False, device="cpu")
    last = trainer.fit()
    trainer.close()
    assert lint.main([cfg.workdir]) == 0
    records = _records(cfg.workdir)
    assert records and all("time" in r and r["schema"] == 1 for r in records)
    with open(os.path.join(cfg.workdir, "metrics.txt")) as f:
        txt = f.read().splitlines()
    assert len(txt) == len(records)
    assert txt[0].startswith("epoch=0  loss=")
    snap = trainer.registry.snapshot()
    assert snap["ddlpc_train_loss"] == last["loss"]
    assert snap["ddlpc_train_epoch"] == 1
    assert snap['ddlpc_log_records_total{kind="train"}'] == 2
    assert snap['ddlpc_log_records_total{kind="lineage"}'] == 2


PROBE_KEYS = ("comm_s_per_step", "comm_fraction", "overlap_headroom_s", "step_time_s")
PROBE_GAUGES = ("ddlpc_comm_seconds_per_step", "ddlpc_comm_fraction", "ddlpc_comm_overlap_headroom_s")


@pytest.mark.parametrize("probe_s,step_s", [(0.02, 0.1), (0.07, 0.1), (0.3, 0.1), (0.02, None)])
def test_comm_probe_fields_and_gauges_equal_jax(probe_s, step_s):
    """``record_probe`` then ``publish``: the probe's fields and the three
    gauges, the port's accountant against JAX's on the same plan (a
    probe longer than the step caps the fraction at 1, no headroom)."""
    comp = dict(mode="int8", rounding="stochastic")
    reg, jreg = MetricsRegistry(), JMetricsRegistry()
    port = tcomm.CommAccountant(reg, tcomm.comm_plan(1000, 1000, CompressionConfig(**comp), 2,
                                                     "allreduce"), "allreduce")
    jax_acc = jcomm.CommAccountant(jreg, jcomm.comm_plan(1000, 1000, JCompressionConfig(**comp), 2,
                                                         "allreduce"), "allreduce")
    assert {k: v for k, v in port.publish(step_s).items() if k in PROBE_KEYS} == {}
    for acc in (port, jax_acc):
        acc.record_probe(probe_s)
    rec, jrec = port.publish(step_s), jax_acc.publish(step_time_s=step_s)
    assert {k: rec[k] for k in PROBE_KEYS if k in rec} == {k: jrec[k] for k in PROBE_KEYS if k in jrec}
    assert ("comm_fraction" in rec) == (step_s is not None)
    snap, jsnap = reg.snapshot(), jreg.snapshot()
    assert {g: snap.get(g) for g in PROBE_GAUGES} == {g: jsnap.get(g) for g in PROBE_GAUGES}


def test_comm_probe_times_the_sync_and_leaves_the_generators_alone():
    """One process: the probe runs the step's sync over a dummy of the
    run's buffer (each call a positive wall time, the first one warmed
    up) and draws nothing from torch's generator."""
    from ddlpc_tpu_torch.parallel.train_step import FlatParams

    comp = CompressionConfig(mode="int8", rounding="stochastic")
    flat = FlatParams(torch.nn.Sequential(torch.nn.Linear(30, 20), torch.nn.Linear(20, 7)))
    before = flat.data.clone()
    state = torch.random.get_rng_state()
    probe = tcomm.make_comm_probe(comp, flat, 1, seed=3)
    times = [probe(), probe()]
    assert all(t > 0 for t in times)
    assert torch.equal(torch.random.get_rng_state(), state)
    assert torch.equal(flat.data, before)
