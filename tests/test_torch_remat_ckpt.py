"""``train.remat`` in one process, and checkpoints of the new optimizers
and ZeRO levels across the two packages.

Remat: the tiny U-Net (BatchNorm) and a tiny U-Net++ (deep supervision)
take three optimizer steps of two micro-batches with and without
``remat``; the losses, each step's mean gradient, the params and the
BatchNorm running statistics are the same bit for bit (the backward's
recompute of the forward does not advance the statistics again).  The JAX
package's remat step runs too and agrees with its step without remat.

Checkpoints: for Adam with weight decay, AdamW under a cosine schedule
with warmup and clipping, and SGD (at a constant rate and under warmup),
a JAX train state two updates in — its optax state a chain of the
optimizer's stages — is written by the JAX package and restored by the
port, whose snapshot is the JAX state leaf for leaf and bit for bit; the
port's blob restores in the JAX package to the same state.  A zero3 run of
two gloo processes with gradient buckets checkpoints, and one process at
``shard_update='off'`` restores it bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddlpc_tpu.config import TrainConfig as JTrainConfig
from ddlpc_tpu.train import checkpoint as jckpt
from ddlpc_tpu.train.optim import build_optimizer as jbuild_optimizer
from ddlpc_tpu_torch.config import CompressionConfig, ModelConfig, TrainConfig
from ddlpc_tpu_torch.convert import gather_canonical, load_state_tree
from ddlpc_tpu_torch.models import build_model
from ddlpc_tpu_torch.parallel.train_step import create_train_state, make_train_step
from ddlpc_tpu_torch.train import checkpoint as tckpt
from ddlpc_tpu_torch.train.__main__ import parse_args
from ddlpc_tpu_torch.train.optim import build_optimizer
from ddlpc_tpu_torch.train.trainer import Trainer
from test_torch_checkpoint import TINY, _leaves, _rebuild, assert_flat_equal, jax_state
from test_torch_dist_worker import run_world
from test_torch_train_step import _OFF, _tiny_cli_config
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

REMAT_MODELS = {
    "unet": dict(TINY),
    "unetpp": dict(name="unetpp", features=(8, 16, 32), deep_supervision=True, num_classes=6,
                   compute_dtype="float32", head_dtype="float32"),
}


def _data(seed: int = 3):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(3, 2, 2, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(-1, 6, size=(3, 2, 2, 32, 32)).astype(np.int64)
    return torch.from_numpy(images), torch.from_numpy(labels)


def _train(name: str, remat: bool) -> dict:
    torch.manual_seed(0)
    model = build_model(ModelConfig(**REMAT_MODELS[name]))
    tx = build_optimizer(TrainConfig(learning_rate=2e-3))
    state = create_train_state(model, tx)
    step = make_train_step(tx, CompressionConfig(mode="float16"), remat=remat)
    out = {"losses": [], "grads": []}
    for x, y in zip(*_data()):
        out["losses"].append(float(step(state, x, y)["loss"]))
        out["grads"].append(state.params.grad.clone())
    out["params"] = state.params.data.clone()
    out["stats"] = {k: v.clone() for k, v in model.named_buffers()}
    return out


@pytest.mark.parametrize("name", sorted(REMAT_MODELS))
def test_remat_step_is_the_step_bit_for_bit(name):
    plain, remat = _train(name, False), _train(name, True)
    assert remat["losses"] == plain["losses"]
    for a, b in zip(remat["grads"], plain["grads"]):
        assert torch.equal(a, b)
    assert torch.equal(remat["params"], plain["params"])
    assert plain["stats"] and all(torch.equal(remat["stats"][k], v) for k, v in plain["stats"].items())


def test_jax_remat_step_matches_its_plain_step():
    """The reference of the option: the JAX package's ``remat=True`` step
    (``jax.checkpoint`` around each micro-batch's loss) trains as its step
    without it, on the same tiny U-Net."""
    from jax.sharding import Mesh

    from ddlpc_tpu.config import CompressionConfig as JCompression
    from ddlpc_tpu.config import ModelConfig as JModelConfig
    from ddlpc_tpu.models import build_model as jbuild_model
    from ddlpc_tpu.parallel import train_step as jts
    from test_torch_model import flax_like_variables

    jmodel = jbuild_model(JModelConfig(**TINY))
    variables = flax_like_variables(jmodel)
    tx = optax.adam(2e-3)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    images, labels = (t.numpy() for t in _data())
    outs = []
    for remat in (False, True):
        state = jts.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                               batch_stats=variables["batch_stats"],
                               opt_state=tx.init(variables["params"]))
        step = jts.make_train_step(jmodel, tx, mesh, JCompression(mode="float16"),
                                   donate_state=False, remat=remat)
        for x, y in zip(images, labels.astype(np.int32)):
            state, m = step(state, jnp.asarray(x), jnp.asarray(y))
        outs.append((float(m["loss"]), state))
    assert outs[0][0] == pytest.approx(outs[1][0], rel=1e-6)
    for a, b in zip(jax.tree.leaves(outs[0][1].batch_stats), jax.tree.leaves(outs[1][1].batch_stats)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-7)


# --- checkpoints of the new optimizers -------------------------------------------

OPTIMIZERS = {
    "adam_l2": dict(weight_decay=1e-3),
    "adamw_cosine_clip": dict(optimizer="adamw", weight_decay=1e-4, lr_schedule="cosine",
                              warmup_steps=1, grad_clip_norm=1.0),
    "sgd": dict(optimizer="sgd"),
    "sgd_warmup_clip": dict(optimizer="sgd", warmup_steps=3, grad_clip_norm=1.0),
}
TOTAL = 10


def _jax_state(kw: dict):
    """The tiny U-Net's JAX state with this optimizer's optax state two
    seeded updates in, and a zero target of the same structure."""
    base = jax_state()
    tx = jbuild_optimizer(JTrainConfig(learning_rate=2e-3, **kw), total_steps=TOTAL)
    opt = tx.init(base.params)
    params = base.params
    rng = np.random.default_rng(5)
    for _ in range(2):
        g = _rebuild(params, {k: (rng.normal(size=np.shape(v)) * 1e-2).astype(np.float32)
                              for k, v in _leaves(params)})
        u, opt = tx.update(g, opt, params)
        params = optax.apply_updates(params, u)
    params = jax.tree.map(np.asarray, params)
    state = base.replace(step=jnp.int32(2), params=params, opt_state=opt)
    zero = jax.tree.map(lambda v: np.zeros_like(v), state)
    return state, zero


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_new_optimizer_checkpoints_cross_both_ways(name, tmp_path, monkeypatch):
    from ddlpc_tpu.utils import wire as jwire
    from ddlpc_tpu_torch.utils import wire as twire

    monkeypatch.setattr(jwire, "_native", False)
    monkeypatch.setattr(twire, "_native", False)
    kw = OPTIMIZERS[name]
    js, target = _jax_state(kw)
    jckpt.save_checkpoint(str(tmp_path / "jax"), js, step=2)
    tree, meta = tckpt.restore_checkpoint(str(tmp_path / "jax"))
    state = create_train_state(build_model(ModelConfig(**TINY)),
                               build_optimizer(TrainConfig(learning_rate=2e-3, **kw), TOTAL))
    load_state_tree(state, tree)
    assert state.step == 2 and state.opt_state.count == 2
    assert_flat_equal(tckpt.flatten_tree(tckpt.snapshot_state(state).tree()), jckpt.snapshot_state(js))
    tckpt.save_checkpoint(str(tmp_path / "port"), state, metadata={"epoch": 0})
    restored, _ = jckpt.restore_checkpoint(str(tmp_path / "port"), target)
    assert_flat_equal(jckpt.snapshot_state(restored), jckpt.snapshot_state(js))


def _sets(*pairs) -> list:
    return [a for p in pairs for a in ("--set", p)]


def test_zero3_bucketed_checkpoint_restores_into_off(tmp_path):
    """Two replicas at zero3 (the params' chunks gathered for the blob),
    then one at off on the same workdir: the state the run ended on."""
    options = _sets("compression.bucket_mb=0.005", "train.optimizer=adamw",
                    "train.weight_decay=1e-4", "train.lr_schedule=cosine", "train.remat=true",
                    "train.checkpoint_every_epochs=1",
                    *[o for o in _OFF[1::2] if not o.startswith("train.checkpoint_every")])
    base = ["--config", _tiny_cli_config(tmp_path), "--device", "cpu",
            "--workdir", str(tmp_path / "run"), *options]
    argv = base + ["--no-resume"] + _sets("parallel.data_axis_size=2", "train.micro_batch_size=2",
                                          "parallel.shard_update=zero3")
    (out,) = run_world("ckpt", 2, str(tmp_path / "world"), {"argv": argv}, {})[:1]
    assert str(out["level"]) == "zero3"
    # The global micro-batch stays 4, so the loader's steps and the
    # schedule's horizon are the run's.
    c, _, device, _ = parse_args(base + _sets("parallel.shard_update=off", "train.micro_batch_size=4"))
    again = Trainer(c, resume=True, device=device)
    assert again.shard_update == "off" and again.start_epoch == 2
    sd, opt = gather_canonical(again.state)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), out[f"saved/sd/{k}"], err_msg=k)
    for key in ("mu", "nu"):
        for k, v in opt[key].items():
            np.testing.assert_array_equal(v.numpy(), out[f"saved/{key}/{k}"], err_msg=k)
    assert opt["count"] == int(out["saved/count"]) == again.state.step
    assert opt["layout"] == ("adam", "empty", "count")  # AdamW's chain under a schedule
