"""The port's perf accounting (``obs/flops.py``, ``obs/comm.py``,
``obs/hbm.py``) and the trainer with the committed configs' settings on,
against the JAX package, on the CPU.

- The conv FLOP model: the port counts from its conv modules what the JAX
  package counts from the jaxpr of ``value_and_grad``, as integers, equal
  (the flagship's 12,234,214,342,656 a step, 89 conv equations a
  micro-batch; ``v5e8``'s 3,058,553,585,664 a replica).
- ``comm_plan``: ``bytes_pre`` and ``bytes_post`` are JAX's; ``bytes_wire``
  is the port's own operand, and the test spells out how it differs.
- ``state_hbm_bytes``: JAX's kinds, the port's bytes, the differences
  spelled out (alignment padding, the host-side Adam count).
- The accountant reconciles: productive + Σ debits ≤ wall.
- A tiny ``Trainer.fit`` with the five settings the configs enable (device
  cache, native gather, image dumps, stall watchdog, perf accounting) gives
  the losses of a run with them off (rtol 1e-5: the batches are the same
  bytes, and PyTorch's CPU convolutions may sum in another order from one
  fit to the next); writes a
  ``perf`` and a ``comm`` record an epoch; writes PNGs that decode, under
  PIL, to the pixels of the JAX package's PNGs of the same predictions.
- The epoch record's keys are the JAX trainer's, plus ``grad_norm`` (the
  port logs the synced gradient's norm, which the JAX step computes and
  its trainer does not log).
"""

import json
import os
import time

import numpy as np
import pytest
import torch
from PIL import Image

from ddlpc_tpu.config import CompressionConfig as JCompression
from ddlpc_tpu.config import ExperimentConfig as JExperimentConfig
from ddlpc_tpu.config import ModelConfig as JModelConfig
from ddlpc_tpu.models import build_model as jbuild_model
from ddlpc_tpu.obs import comm as jcomm
from ddlpc_tpu.obs import flops as jflops
from ddlpc_tpu.obs import hbm as jhbm
from ddlpc_tpu.train.observability import dump_prediction_triples as jdump
from ddlpc_tpu_torch.config import CompressionConfig, ExperimentConfig, ModelConfig
from ddlpc_tpu_torch.models import build_model
from ddlpc_tpu_torch.obs import comm, flops, hbm
from ddlpc_tpu_torch.obs.registry import MetricsRegistry
from ddlpc_tpu_torch.parallel.train_step import create_train_state
from ddlpc_tpu_torch.resilience.protocol import write_breadcrumb
from ddlpc_tpu_torch.train.__main__ import parse_args
from ddlpc_tpu_torch.train.observability import class_palette
from ddlpc_tpu_torch.train.optim import Adam
from ddlpc_tpu_torch.train.trainer import Trainer
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_MODELS = {
    "s2d_detail": dict(features=[8, 16], bottleneck_features=16, stem="s2d", stem_factor=2,
                       detail_head=True),
    "plain": dict(features=[8], bottleneck_features=8, num_classes=3),
    "s2d_no_detail": dict(features=[8, 16], bottleneck_features=8, stem="s2d", stem_factor=4,
                          width_divisor=2),
}


def _both(d: dict):
    return ExperimentConfig.from_dict(d), JExperimentConfig.from_dict(d)


@pytest.mark.parametrize("name", list(TINY_MODELS))
def test_conv_step_flops_equals_jax_on_tiny_models(name):
    classes = TINY_MODELS[name].get("num_classes", 6)
    d = {"model": TINY_MODELS[name],
         "data": {"image_size": [32, 32], "num_classes": classes},
         "train": {"micro_batch_size": 4, "sync_period": 2}}
    port, jax_cfg = _both(d)
    want = jflops.conv_step_flops(jax_cfg, 4, 2)
    assert flops.conv_step_flops(port, 4, 2) == want
    rows = flops.collect_convs(port.model, (32, 32))
    equations = len(rows) * 2 + sum(1 for r in rows if r["input_grad"])
    assert equations == sum(c["count"] for c in jflops.collect_convs(jax_cfg, 1).values())
    assert not rows[0]["input_grad"]  # the first conv sees the batch: no data gradient


@pytest.mark.parametrize("config,micro,sync,want", [
    ("vaihingen_unet_tpu_flagship.json", 128, 4, 12_234_214_342_656),
    ("vaihingen_unet_v5e8.json", 128, 1, 3_058_553_585_664),
])
def test_conv_step_flops_of_the_committed_configs(config, micro, sync, want):
    with open(os.path.join(REPO, "configs", config)) as f:
        text = f.read()
    port, jax_cfg = ExperimentConfig.from_json(text), JExperimentConfig.from_json(text)
    assert (port.train.micro_batch_size, port.train.sync_period) == (micro, sync)
    assert flops.conv_step_flops(port, micro, sync) == want
    assert jflops.conv_step_flops(jax_cfg, micro, sync) == want
    rows = flops.collect_convs(port.model, tuple(port.data.image_size))
    assert len(rows) * 2 + sum(r["input_grad"] for r in rows) == 89


def test_peak_flops_by_device_name(monkeypatch):
    assert flops.resolve_peak_flops(0.0, torch.device("cpu")) == (989e12, True)
    assert flops.resolve_peak_flops(5e14, torch.device("cpu")) == (5e14, False)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    assert flops.resolve_peak_flops(0.0, torch.device("cuda:0")) == (989e12, False)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA A100-SXM4-80GB")
    assert flops.resolve_peak_flops(0.0, torch.device("cuda:0")) == (989e12, True)


@pytest.mark.parametrize("variant", ["allreduce", "scatter"])
@pytest.mark.parametrize("codec,world", [
    ({"mode": "float16"}, 4),                         # f16 wire, 4·100 ≤ 2048
    ({"mode": "int8"}, 2),                            # s8 wire
    ({"mode": "int8"}, 16),                           # s16 in JAX, s32 in the port
    ({"mode": "int8", "quantize_local": False}, 4),   # fp32 all the way
    ({"mode": "none"}, 8),
])
def test_comm_plan_against_jax(codec, world, variant):
    n = 8_372_422  # the flagship's gradients
    padded = world * (-(-(-(-n // world)) // 32) * 32)  # flat_chunk_rows: ceil(n/N) up to 32
    port = comm.comm_plan(n, padded, CompressionConfig(**codec), world, variant)
    want = jcomm.comm_plan(n, n, JCompression(**codec), world, variant)
    assert [r["collective"] for r in port] == [r["collective"] for r in want]
    for p, j in zip(port, want):
        for key in ("codec", "bytes_pre", "bytes_post"):
            assert p[key] == j[key], key
    grad, jgrad = port[0], want[0]
    narrow = jgrad["wire_dtype"] != "f32"
    # JAX: n elements of its wire dtype and one fp32 scale.  The port: the
    # padded buffer, the int16 wire widened to int32, and a 4-byte max-abs
    # all-reduce for the fused encode's scale and, under zero2, one more
    # for the mean stage's max over the chunks.
    item = {"s8": 1, "s16": 4, "f16": 2, "f32": 4}[jgrad["wire_dtype"]]
    scales = int(narrow) + int(variant == "scatter" and codec["mode"] != "none")
    assert jgrad["bytes_wire"] == n * {"s8": 1, "s16": 2, "f16": 2, "f32": 4}[jgrad["wire_dtype"]] + 4 * narrow
    assert grad["bytes_wire"] == padded * item + 4 * scales
    assert grad["wire_dtype"] == ("s32" if jgrad["wire_dtype"] == "s16" else jgrad["wire_dtype"])
    assert ("widened_from" in grad) == (jgrad["wire_dtype"] == "s16")
    if variant == "scatter":
        assert port[1]["bytes_wire"] == padded * 4 and want[1]["bytes_wire"] == n * 4
    assert comm.comm_plan(n, n, CompressionConfig(**codec), 1, variant) == []


def test_comm_accountant_counts_steps_and_publishes():
    reg = MetricsRegistry()
    plan = comm.comm_plan(1000, 1024, CompressionConfig(mode="float16"), 4, "scatter")
    acc = comm.CommAccountant(reg, plan, "scatter")
    acc.on_step(3)
    rec = acc.publish()
    assert rec["kind"] == "comm" and rec["steps"] == 3
    assert rec["reduce_scatter_bytes_wire_per_step"] == 1024 * 2 + 8
    assert rec["reduce_scatter_bytes_post_per_step"] == 1000 * 2 + 4
    counter = reg.get("ddlpc_comm_bytes_total")
    assert counter.value(collective="all_gather", codec="none", stage="wire") == 3 * 1024 * 4


@pytest.mark.parametrize("level,world", [("off", 1), ("off", 4), ("zero2", 4)])
def test_state_hbm_bytes_against_jax(level, world):
    import jax

    from ddlpc_tpu.parallel import train_step as jts

    cfg = ModelConfig(features=(8, 16), bottleneck_features=16, num_classes=6)
    state = create_train_state(build_model(cfg), Adam(1e-3), world, level)
    got = hbm.state_hbm_bytes(state, level)
    jstate = jts.create_train_state(jbuild_model(JModelConfig(**cfg.__dict__)),
                                    __import__("optax").adam(1e-3), jax.random.key(0),
                                    (1, 32, 32, 3))
    want = jhbm.state_hbm_bytes(jstate, "off", 1)  # placed on one device: whole leaves
    n = state.params.numel
    k = state.params.shard
    assert want["params"] == want["grads"] == want["grads_accum"] == n * 4
    assert want["opt_state"] == 2 * n * 4 + 4  # mu, nu, and the int32 count
    assert got["batch_stats"] == want["batch_stats"]
    assert got["params"] == got["grads_accum"] == world * k * 4  # n, padded to N·K
    assert world * k - n == (0 if world == 1 else world * k - n) and world * k >= n
    if level == "zero2":
        jgrads = jhbm.grads_bytes_per_device(jstate.params, "zero2", world)  # Σ ceil(n_leaf/N)
        assert got["grads"] == k * 4 and jgrads < k * 4 * world
        assert got["opt_state"] == 2 * k * 4  # this replica's chunk; the count on the host
    else:
        assert got["grads"] == world * k * 4
        assert got["opt_state"] == 2 * world * k * 4
    reg = MetricsRegistry()
    assert hbm.publish_hbm_gauges(reg, state) == got
    assert reg.snapshot()['ddlpc_hbm_bytes{kind="opt_state"}'] == got["opt_state"]


def test_perf_accountant_reconciles_and_reads_the_restart_gap(tmp_path):
    write_breadcrumb(str(tmp_path), "running")
    gap = flops.restart_gap_seconds(str(tmp_path))
    assert gap >= 0.0
    with open(tmp_path / "resilience.jsonl", "w") as f:
        f.write(json.dumps({"time": 1.0}) + "\nnot json\n")
    assert flops.restart_gap_seconds(str(tmp_path), now=1e10) < 1e10 - 1.0  # the crumb is newer
    write_breadcrumb(str(tmp_path), "done")
    assert flops.restart_gap_seconds(str(tmp_path)) == 0.0
    assert flops.restart_gap_seconds(str(tmp_path / "none")) == 0.0

    reg = MetricsRegistry()
    acc = flops.PerfAccountant(reg, flops_per_step=10**12, peak_flops=1e15, restart_gap_s=0.5)
    acc.start()
    for category in ("step", "data", "step", "eval"):  # measured, disjoint intervals
        t0 = time.perf_counter()
        time.sleep(0.02)
        dt = time.perf_counter() - t0
        acc.productive(dt, steps=1) if category == "step" else acc.debit(category, dt)
    rec = acc.publish(step_time_s=0.1)
    assert rec["mfu"] == round(10**12 / (0.1 * 1e15), 6)
    debits = sum(v for k, v in rec.items() if k.startswith("debit_"))
    assert rec["debit_restart_s"] == 0.5
    assert rec["productive_s"] + debits <= rec["wall_s"] + 1e-4
    assert rec["other_s"] >= 0.0 and 0.0 < rec["goodput"] < 1.0
    snap = reg.snapshot()
    assert snap["ddlpc_flops_per_step"] == 10**12 and snap["ddlpc_peak_flops_assumed"] == 0


def _tiny(tmp_path, name: str, **over) -> ExperimentConfig:
    d = {
        "model": {"features": [8, 16], "bottleneck_features": 16, "stem": "s2d",
                  "stem_factor": 2, "detail_head": True, "compute_dtype": "float32",
                  "head_dtype": "float32"},
        "data": {"image_size": [32, 32], "synthetic_len": 20, "test_split": 4},
        "train": {"epochs": 2, "micro_batch_size": 4, "sync_period": 2,
                  "checkpoint_every_epochs": 0},
        "compression": {"mode": "float16"},
    }
    for section, values in over.items():
        d[section].update(values)
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(d))
    cfg, _, _, _ = parse_args(["--config", str(path), "--device", "cpu",
                               "--workdir", str(tmp_path / name)])
    return cfg


def _records(workdir) -> list:
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_fit_with_the_configs_settings_on_matches_off_and_accounts(tmp_path):
    on = _tiny(tmp_path, "on", data={"device_cache": True, "native_gather": True},
               train={"dump_images_per_epoch": 5, "stall_timeout_s": 60.0,
                      "stall_action": "abort", "perf_accounting": True})
    off = _tiny(tmp_path, "off", data={"device_cache": False, "native_gather": False},
                train={"dump_images_per_epoch": 0, "stall_timeout_s": 0.0,
                       "perf_accounting": False})
    ton = Trainer(on, resume=False, device="cpu")
    ton.fit()
    toff = Trainer(off, resume=False, device="cpu")
    toff.fit()
    epochs_on = [r for r in _records(on.workdir) if "kind" not in r]
    epochs_off = _records(off.workdir)
    # The batches are the same bytes (tests/test_torch_loader_cache.py);
    # PyTorch's CPU convolutions may still sum in another order from one fit
    # to the next in a process, seen up to 4e-7 relative on a first fit.
    for key in ("loss", "grad_norm", "val_loss"):
        np.testing.assert_allclose([r[key] for r in epochs_on], [r[key] for r in epochs_off],
                                   rtol=1e-5, atol=0, err_msg=key)

    want_flops = jflops.conv_step_flops(JExperimentConfig.from_dict(on.to_dict()), 4, 2)
    perf = [r for r in _records(on.workdir) if r.get("kind") == "perf"]
    comm_recs = [r for r in _records(on.workdir) if r.get("kind") == "comm"]
    assert len(perf) == len(comm_recs) == 2 and not any("kind" in r for r in epochs_off)
    for i, r in enumerate(perf):
        assert r["flops_per_step"] == want_flops and r["peak_flops_assumed"] is True
        assert r["steps"] == 2 * (i + 1) and 0 < r["goodput"] <= 1
        # Rounded to 6 places, the CPU's MFU against a card's peak reads ~0.
        assert r["mfu"] == pytest.approx(
            r["flops_per_step"] / (r["step_time_s"] * r["peak_flops_per_device"]), abs=1e-6)
        debits = sum(v for k, v in r.items() if k.startswith("debit_"))
        assert r["productive_s"] + debits <= r["wall_s"] + 1e-3
        assert {"debit_data_s", "debit_eval_s"} <= set(r)
    assert {k: v for k, v in comm_recs[-1].items() if k not in ("time", "schema")} == {
        "kind": "comm", "variant": "allreduce", "steps": 4}
    assert ton.registry.snapshot()['ddlpc_hbm_bytes{kind="params"}'] == ton.state.params.numel * 4

    # The PNGs: 4 test tiles, three files each, every epoch; the last
    # epoch's decode under PIL to the JAX package's files of the same
    # predictions, and the prediction's to the palette of its classes.
    images, labels = ton.test_ds.images[:4], ton.test_ds.labels[:4]
    preds = ton.predict(images)
    jdir = str(tmp_path / "jax_images")
    jdump(jdir, images, labels, preds, 6, 1, max_samples=5)
    for epoch in (0, 1):
        names = sorted(os.listdir(os.path.join(on.workdir, "images", f"epoch_{epoch:04d}")))
        assert names == sorted(f"{k} {i}.png" for k in ("Model", "Label", "Image") for i in range(4))
    for name in os.listdir(os.path.join(jdir, "images", "epoch_0001")):
        ours = Image.open(os.path.join(on.workdir, "images", "epoch_0001", name))
        theirs = Image.open(os.path.join(jdir, "images", "epoch_0001", name))
        assert ours.mode == theirs.mode == "RGB" and ours.size == theirs.size == (32, 32)
        np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs), err_msg=name)
    model0 = np.asarray(Image.open(os.path.join(on.workdir, "images", "epoch_0001", "Model 0.png")))
    np.testing.assert_array_equal(model0, class_palette(6)[preds[0]])


def test_epoch_record_keys_equal_jax_trainers(tmp_path):
    """One epoch of each trainer on the same tiny config over the host
    loader (native gather): the same record keys, ``grad_norm`` aside."""
    from ddlpc_tpu.train.trainer import Trainer as JTrainer

    d = {
        "model": {"features": [8], "bottleneck_features": 8, "num_classes": 3},
        "data": {"image_size": [32, 32], "synthetic_len": 12, "test_split": 4,
                 "num_classes": 3},
        "train": {"epochs": 1, "micro_batch_size": 1, "sync_period": 2,
                  "dump_images_per_epoch": 0, "checkpoint_every_epochs": 0,
                  "perf_accounting": False},
        "parallel": {"data_axis_size": 1},
    }
    jrec = JTrainer(JExperimentConfig.from_dict({**d, "workdir": str(tmp_path / "jax")}),
                    resume=False).fit()
    cfg = ExperimentConfig.from_dict({**d, "workdir": str(tmp_path / "port"),
                                      "parallel": {"data_axis_size": -1}})
    rec = Trainer(cfg, resume=False, device="cpu").fit()
    assert set(rec) - {"grad_norm"} == set(jrec)
    assert {"t_data_s", "t_step_s", "t_loader_gather_s", "t_loader_upload_s"} <= set(rec)
    assert rec["step_time_s"] == rec["epoch_time_s"] / 4  # JAX's: the epoch over its steps
