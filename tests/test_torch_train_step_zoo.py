"""U-Net++ and DeepLabV3+ train in the port as in the JAX package, on the CPU.

- One optimizer step (``sync_period`` 2, micro-batch 2, some void labels)
  of a tiny U-Net++ with deep supervision, the same with the s2d stem, the
  stem-grid detail head and the grouped train layout, and a tiny
  DeepLabV3+, against ``ddlpc_tpu.parallel.train_step.make_train_step`` on
  a 1-device mesh with ``optax.adam``, from the same seeded weights, in
  fp32 and with float64 compute (``jax.enable_x64``; params, gradients,
  statistics and moments stay float32 in both packages).  Tolerances,
  each with its reason:

  - float64 compute: the loss at rtol 1e-6, and every leaf of the
    BatchNorm statistics and Adam's moments within 1e-6 of its largest
    value (measured ≤ 3e-7: float32 storage); params at rtol 1e-4 /
    atol 1e-6, every element;
  - fp32: the loss at rtol 1e-5; statistics within 1e-4 of each leaf's
    largest value, moments within 1e-2 (measured 1.5e-5 and 2e-3).  The
    convolutions sum in another order (``tests/test_torch_train_step.py``)
    and the train forward's batch statistics magnify it
    (``tests/test_torch_models_zoo.py``); a gradient through a
    normalized layer is a difference of nearly equal sums, whose error
    is a larger share of it.  Params at rtol 1e-4 / atol 1e-6 but for at
    most 0.5 % of the elements (measured 0.12 %), which stay within
    ``2·lr``: Adam's first step is ``lr·sign(g)`` wherever ``|g| ≫ ε``,
    so a gradient that nearly cancels may flip its step.
- A DWC2 checkpoint of each model written by one package restores in the
  other, bit for bit.
- The three committed configs enable nothing the port lacks, and a tiny
  U-Net++ and DeepLabV3+ train through the CLI with their settings (eval,
  PNG dumps, checkpoints, the FLOP count).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from ddlpc_tpu.config import CompressionConfig as JCompression
from ddlpc_tpu.config import ModelConfig as JModelConfig
from ddlpc_tpu.data import datasets as jdatasets
from ddlpc_tpu.models import build_model as jbuild_model
from ddlpc_tpu.parallel import train_step as jts
from ddlpc_tpu.train import checkpoint as jckpt
from ddlpc_tpu.utils import wire as jwire
from ddlpc_tpu_torch.config import CompressionConfig, ExperimentConfig, ModelConfig, TrainConfig
from ddlpc_tpu_torch.convert import flax_from_torch, load_state_tree, torch_state_from_flax
from ddlpc_tpu_torch.models import build_model
from ddlpc_tpu_torch.parallel.grad_sync import check_supported
from ddlpc_tpu_torch.parallel.train_step import create_train_state, make_train_step
from ddlpc_tpu_torch.train import checkpoint as tckpt
from ddlpc_tpu_torch.train.__main__ import main as cli_main
from ddlpc_tpu_torch.train.optim import Adam, build_optimizer
from ddlpc_tpu_torch.train.trainer import check_exclusive
from ddlpc_tpu_torch.utils import wire as twire
from test_torch_model import flax_like_variables
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 2e-3
F32 = dict(compute_dtype="float32", head_dtype="float32")
MODELS = {  # name: (model config, tile size)
    "unetpp": (dict(name="unetpp", features=(8, 16, 32), deep_supervision=True, **F32), 32),
    "unetpp_s2d_grouped": (dict(name="unetpp", features=(8, 16, 32), deep_supervision=True,
                                stem="s2d", stem_factor=2, detail_head=True,
                                detail_head_kind="s2d", train_head_layout="grouped", **F32), 32),
    "deeplabv3p": (dict(name="deeplabv3p", features=(64, 128, 256, 512), width_divisor=8, **F32),
                   64),
}
# precision: (loss rtol, statistics and moments: share of each leaf's
# largest value, params: share of elements off rtol 1e-4 / atol 1e-6)
TOLERANCES = {"float64": (1e-6, 1e-6, 1e-6, 0.0), "float32": (1e-5, 1e-4, 1e-2, 5e-3)}


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _batch(size: int):
    ds = jdatasets.SyntheticTiles(num_tiles=4, image_size=(size, size), seed=0)
    labels = ds.labels.copy()
    labels[:, :3, :5] = -1  # void pixels
    return ds.images.reshape(2, 2, size, size, 3), labels.reshape(2, 2, size, size)


def _one_step(name: str, dtype: str):
    kw, size = MODELS[name]
    kw = dict(kw, compute_dtype=dtype, head_dtype=dtype)
    images, labels = _batch(size)
    jmodel = jbuild_model(JModelConfig(**kw))
    variables = flax_like_variables(jmodel)
    params0, stats0 = variables["params"], variables["batch_stats"]
    # flax's scan carries the statistics in the compute dtype.
    jstats0 = jax.tree.map(lambda a: np.asarray(a, dtype), stats0)
    tx = optax.adam(LR)
    jstate = jts.TrainState(
        step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.asarray, params0),
        batch_stats=jax.tree.map(jnp.asarray, jstats0),
        opt_state=tx.init(jax.tree.map(jnp.asarray, params0)),
    )
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jstep = jts.make_train_step(jmodel, tx, mesh, JCompression(mode="none"), donate_state=False)
    jstate, m = jstep(jstate, jnp.asarray(images), jnp.asarray(labels))
    adam = jstate.opt_state[0]
    jout = {"params": _flat(jstate.params), "batch_stats": _flat(jstate.batch_stats),
            "mu": _flat(adam.mu), "nu": _flat(adam.nu), "loss": float(m["loss"])}

    model = build_model(ModelConfig(**kw))
    model.load_state_dict(torch_state_from_flax(params0, stats0)[0], strict=True)
    ttx = build_optimizer(TrainConfig(learning_rate=LR))
    state = create_train_state(model, ttx)
    tm = make_train_step(ttx, CompressionConfig(mode="none"))(
        state, torch.from_numpy(images), torch.from_numpy(labels.astype(np.int64)))
    opt = state.opt_state
    p, s, o = flax_from_torch(model.state_dict(), {
        "count": opt.count, "mu": state.params.named_views(opt.mu),
        "nu": state.params.named_views(opt.nu)})
    tout = {"params": _flat(p), "batch_stats": _flat(s), "mu": _flat(o["mu"]),
            "nu": _flat(o["nu"]), "loss": float(tm["loss"])}
    return jout, tout


@pytest.mark.parametrize("dtype", list(TOLERANCES))
@pytest.mark.parametrize("name", list(MODELS))
def test_one_step_matches_jax(name, dtype):
    loss_rtol, stats_tol, moments_tol, params_share = TOLERANCES[dtype]
    with jax.enable_x64(dtype == "float64"):
        jout, tout = _one_step(name, dtype)
    np.testing.assert_allclose(tout["loss"], jout["loss"], rtol=loss_rtol)
    for part, tol in (("batch_stats", stats_tol), ("mu", moments_tol), ("nu", moments_tol)):
        assert jout[part].keys() == tout[part].keys()
        for k, want in jout[part].items():
            err = np.abs(tout[part][k] - want).max()
            assert err <= tol * np.abs(want).max(), (part, k, err, np.abs(want).max())
    total = off = 0
    for k, want in jout["params"].items():
        diff = np.abs(tout["params"][k] - want)
        off += int((diff > 1e-4 * np.abs(want) + 1e-6).sum())
        total += want.size
        assert diff.max() <= 2 * LR, (k, diff.max())
    assert off <= params_share * total, (off, total)
    assert max(np.abs(v).max() for v in jout["mu"].values()) > 0


def _jax_state(name: str):
    kw, _ = MODELS[name]
    variables = flax_like_variables(jbuild_model(JModelConfig(**kw)), seed=3)
    params = variables["params"]
    rng = np.random.default_rng(5)
    mu = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 1e-3).astype(np.float32), params)
    nu = jax.tree.map(lambda a: np.abs(rng.normal(size=a.shape) * 1e-6).astype(np.float32),
                      params)
    return jts.TrainState(
        step=jnp.int32(3), params=params, batch_stats=variables["batch_stats"],
        opt_state=(optax.ScaleByAdamState(count=jnp.int32(3), mu=mu, nu=nu),
                   optax.EmptyState()),
    )


@pytest.mark.parametrize("name", ["unetpp", "deeplabv3p"])
def test_checkpoint_crosses_packages_both_ways(tmp_path, monkeypatch, name):
    monkeypatch.setattr(jwire, "_native", False)
    monkeypatch.setattr(twire, "_native", False)
    js = _jax_state(name)
    jckpt.save_checkpoint(str(tmp_path / "jax"), js, step=3, chunk_bytes=4096)
    tree, meta = tckpt.restore_checkpoint(str(tmp_path / "jax"))
    state = create_train_state(build_model(ModelConfig(**MODELS[name][0])), Adam(LR))
    load_state_tree(state, tree)
    assert meta["step"] == state.step == 3 and state.opt_state.count == 3
    tckpt.save_checkpoint(str(tmp_path / "port"), state, metadata={"epoch": 1}, chunk_bytes=4096)
    target = jax.tree.map(np.zeros_like, js)
    restored, meta = jckpt.restore_checkpoint(str(tmp_path / "port"), target)
    assert meta["epoch"] == 1
    want, got = jckpt.snapshot_state(js), jckpt.snapshot_state(restored)
    assert list(want) == list(got)
    for k in want:
        if isinstance(want[k], dict):  # optax's EmptyState
            assert want[k] == got[k] == {}, k
            continue
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("config", ["vaihingen_unetpp.json", "vaihingen_unetpp_s2d.json",
                                    "potsdam_deeplabv3p.json"])
def test_committed_configs_enable_nothing_unported(config):
    with open(os.path.join(REPO, "configs", config)) as f:
        cfg = ExperimentConfig.from_json(f.read())
    check_exclusive(cfg)
    check_supported(cfg.compression)
    build_model(cfg.model)  # at full width; no refusal


@pytest.mark.parametrize("model", [
    {"name": "unetpp", "features": [8, 16, 32], "deep_supervision": True, "stem": "s2d",
     "stem_factor": 2, "head_dtype": "bfloat16"},
    {"name": "deeplabv3p", "features": [64, 128, 256, 512], "width_divisor": 8},
])
def test_cli_trains_tiny_zoo_models_on_cpu(tmp_path, model):
    """Two epochs through the CLI with the committed configs' settings:
    eval, PNG dumps, checkpoints, the stall watchdog, perf accounting."""
    cfg = {"model": model,
           "data": {"image_size": [64, 64], "synthetic_len": 14, "test_split": 4},
           "train": {"epochs": 2, "micro_batch_size": 2, "sync_period": 2,
                     "dump_images_per_epoch": 2, "stall_timeout_s": 300.0},
           "compression": {"mode": "none"}}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    workdir = tmp_path / "run"
    assert cli_main(["--config", str(path), "--device", "cpu", "--workdir", str(workdir)]) == 0
    lines = [json.loads(x) for x in (workdir / "metrics.jsonl").read_text().splitlines()]
    records = [r for r in lines if "kind" not in r]
    assert [r["epoch"] for r in records] == [0, 1]
    for r in records:
        assert np.isfinite(r["loss"]) and 0.0 <= r["pixel_acc"] <= 1.0
        assert 0.0 <= r["val_miou"] <= 1.0
    perf = [r for r in lines if r.get("kind") == "perf"]
    assert len(perf) == 2 and perf[0]["flops_per_step"] > 0
    assert sorted(os.listdir(workdir / "images" / "epoch_0001")) == sorted(
        f"{k} {i}.png" for k in ("Model", "Label", "Image") for i in range(2))
    assert len([f for f in os.listdir(workdir / "checkpoints") if f.endswith(".dwc")]) == 2
