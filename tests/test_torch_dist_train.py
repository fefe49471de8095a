"""The port's data-parallel train step against the JAX package's.

The tiny U-Net (features [8, 16], fp32, s2d ×2, DetailHead) trains two
optimizer steps of the flagship's fp16 codec with sync-BN, at ZeRO-2, in
worlds of W = 2 and W = 4 gloo processes (``tests/test_torch_dist_worker.py``),
every rank starting from the same seeded weights in the flax layout
(``convert.load_canonical``) and taking its own columns of the same numpy
batches.  The JAX side is ``make_train_step(shard_update='zero2')`` on a
W-device slice of the 8-device CPU mesh, the model built with
``norm_axis_name='data'``.  Tolerances, with the reasons of
``tests/test_torch_train_step.py``:

- each replica's gradient BEFORE the sync (step 1), which holds sync-BN's
  backward (the cotangents summed over the replicas, as JAX's ``pmean``
  transposes inside ``shard_map``), at rtol 1e-4 / atol 1e-6;
- BatchNorm running statistics after two steps at rtol 1e-4 / atol 1e-6,
  the losses at rtol 1e-4;
- params at rtol 1e-4 / atol 1e-6 but for at most 2 % of them (the fp16
  codec's lattice flips), each within ``2·lr`` a step — the allowance of
  ``chip_smoke.reference_phase``.

Every rank must end with the same params, bit for bit.  The CLI is driven
once as a two-process world on the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from ddlpc_tpu.config import CompressionConfig as JCompression
from ddlpc_tpu.config import ModelConfig as JModelConfig
from ddlpc_tpu.data import datasets as jdatasets
from ddlpc_tpu.models import build_model as jbuild_model
from ddlpc_tpu.parallel import shard_update as jzero
from ddlpc_tpu.parallel import train_step as jts
from ddlpc_tpu.utils.compat import shard_map
from ddlpc_tpu_torch.config import ModelConfig
from ddlpc_tpu_torch.convert import flax_from_torch, torch_state_from_flax
from ddlpc_tpu_torch.models import build_model
from ddlpc_tpu_torch.parallel.train_step import FlatParams
from ddlpc_tpu_torch.train.__main__ import parse_args
from ddlpc_tpu_torch.train.trainer import Trainer
from test_torch_model import flax_like_variables
from test_torch_train_step import _OFF, LR, TINY, _flat, _tiny_cli_config
from test_torch_dist_worker import run_world
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

A, BL, STEPS = 2, 2, 2  # micro-batches a step, per-replica micro-batch, steps


def _batches(world: int):
    bg = BL * world
    ds = jdatasets.SyntheticTiles(num_tiles=STEPS * A * bg, image_size=(32, 32), seed=4)
    labels = ds.labels.copy()
    labels[:, :3, :5] = -1  # void pixels
    return (ds.images.reshape(STEPS, A, bg, 32, 32, 3),
            labels.reshape(STEPS, A, bg, 32, 32))


def _named_flax(flat_grad: np.ndarray) -> dict:
    """A flat port gradient as the flax-path dict of ``_flat``."""
    layout = FlatParams(build_model(ModelConfig(**TINY)))
    named = layout.named_views(torch.from_numpy(flat_grad))
    params, _, _ = flax_from_torch(named)
    return _flat(params)


def _run_jax(world: int, params0, stats0, images, labels) -> dict:
    jmodel = jbuild_model(JModelConfig(**TINY), norm_axis_name="data")
    tx = optax.adam(LR)
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    state = jts.TrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree.map(jnp.asarray, params0),
        batch_stats=jax.tree.map(jnp.asarray, stats0),
        opt_state=tx.init(jax.tree.map(jnp.asarray, params0)),
    )

    def grads_of(st, x, y):
        g = jts._accumulate_grads(jmodel, st, x, y)[0]
        return jax.tree.map(lambda v: v[None], g)

    per_replica = jax.jit(shard_map(
        grads_of, mesh=mesh, in_specs=(P(), P(None, "data"), P(None, "data")),
        out_specs=P("data"), check=False,
    ))(state, jnp.asarray(images[0]), jnp.asarray(labels[0]))
    layout = jzero.StateLayout("zero2", tx, state, mesh, "data")
    pstate = layout.place(state)
    step = jts.make_train_step(jmodel, tx, mesh, JCompression(mode="float16"),
                               donate_state=False, shard_update="zero2")
    losses = []
    for x, y in zip(images, labels):
        pstate, m = step(pstate, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(m["loss"]))
    canon = layout.canonical(pstate)
    return {
        "grads": [{k: v[r] for k, v in _flat(per_replica).items()} for r in range(world)],
        "params": _flat(canon.params),
        "batch_stats": _flat(canon.batch_stats),
        "losses": losses,
    }


_RUNS: dict = {}


def _both(world: int, tmp_path_factory):
    if world not in _RUNS:
        images, labels = _batches(world)
        variables = flax_like_variables(jbuild_model(JModelConfig(**TINY)))
        params0, stats0 = variables["params"], variables["batch_stats"]
        sd, _ = torch_state_from_flax(params0, stats0)
        inputs = {f"sd/{k}": v.numpy() for k, v in sd.items()}
        inputs.update(images=images, labels=labels)
        task = {"model": {k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()},
                "lr": LR, "compression": {"mode": "float16"}, "level": "zero2",
                "local_batch": BL}
        work = str(tmp_path_factory.mktemp(f"step_w{world}"))
        outs = run_world("step", world, work, task, inputs)
        _RUNS[world] = (_run_jax(world, params0, stats0, images, labels), outs)
    return _RUNS[world]


def _port_part(out: dict, prefix: str) -> dict:
    sd = {k[len("sd/"):]: torch.from_numpy(v) for k, v in out.items() if k.startswith("sd/")}
    params, stats, _ = flax_from_torch(sd)
    return _flat(params if prefix == "params" else stats)


@pytest.mark.parametrize("world", [2, 4])
def test_per_replica_gradients_before_the_sync_match_jax(world, tmp_path_factory):
    jout, outs = _both(world, tmp_path_factory)
    for r, out in enumerate(outs):
        got = _named_flax(out["grad0"])
        for k, want in jout["grads"][r].items():
            np.testing.assert_allclose(got[k], want, rtol=1e-4, atol=1e-6, err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("world", [2, 4])
def test_batch_stats_and_losses_after_two_steps_match_jax(world, tmp_path_factory):
    jout, outs = _both(world, tmp_path_factory)
    for r, out in enumerate(outs):
        got = _port_part(out, "batch_stats")
        for k, want in jout["batch_stats"].items():
            np.testing.assert_allclose(got[k], want, rtol=1e-4, atol=1e-6, err_msg=k)
        losses = [float(out[f"loss{s}"]) for s in range(STEPS)]
        np.testing.assert_allclose(losses, jout["losses"], rtol=1e-4)
        assert all(np.isfinite(float(out[f"grad_norm{s}"])) for s in range(STEPS))


@pytest.mark.parametrize("world", [2, 4])
def test_params_match_jax_and_every_rank_holds_the_same(world, tmp_path_factory):
    jout, outs = _both(world, tmp_path_factory)
    got = _port_part(outs[0], "params")
    total = off = 0
    for k, want in jout["params"].items():
        diff = np.abs(got[k] - want)
        off += int((diff > 1e-4 * np.abs(want) + 1e-6).sum())
        total += want.size
        assert diff.max() <= STEPS * 2 * LR, (k, diff.max())
    assert off <= 2e-2 * total, (off, total)
    for out in outs[1:]:
        np.testing.assert_array_equal(out["flat"], outs[0]["flat"])
        for k in outs[0]:
            if k.startswith(("sd/", "mu/", "nu/")):
                np.testing.assert_array_equal(out[k], outs[0][k], err_msg=k)


def test_cli_world_of_two_on_the_cpu(tmp_path):
    """``main`` in two gloo processes: zero2 on the f16 wire, one record an
    epoch written by rank 0 alone, finite metrics."""
    cfg = _tiny_cli_config(tmp_path)
    workdir = tmp_path / "run"
    argv = ["--config", cfg, "--device", "cpu", "--no-resume", "--workdir", str(workdir),
            "--set", "parallel.data_axis_size=2", "--set", "train.micro_batch_size=2", *_OFF]
    run_world("cli", 2, str(tmp_path / "world"), {"argv": argv}, {})
    records = [json.loads(line) for line in (workdir / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0, 1]
    for r in records:
        assert np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
        assert 0.0 <= r["val_miou"] <= 1.0


def test_trainer_refuses_a_data_axis_that_is_not_the_world(tmp_path):
    cfg, _, device, backend = parse_args([
        "--config", _tiny_cli_config(tmp_path), "--device", "cpu",
        "--set", "parallel.data_axis_size=2", *_OFF,
    ])
    assert (device, backend) == ("cpu", None)
    with pytest.raises(ValueError, match="data_axis_size=2"):
        Trainer(cfg, resume=False, device=device)
