"""ZeRO-1 and ZeRO-3, gradient buckets in the train step, the ring under
zero1, the new optimizers across replicas, and ``train.remat``: the port
against itself and against the JAX package.

A gloo world of W = 2 (``tests/test_torch_dist_worker.py``, task ``step``)
trains the tiny U-Net (fp32, sync-BN) three optimizer steps from the same
seeded weights and batches in each of the runs of ``RUNS``.  Held bit for
bit, on every rank:

- ``zero1``, ``zero2`` and ``zero3`` against ``off`` (fp16 codec): params,
  BatchNorm statistics, Adam's moments and count — the claim the JAX
  package makes in ``docs/SHARDING.md`` for zero2/zero3, and which the
  port's unfused update keeps for zero1 too;
- the same with gradient buckets (``bucket_mb`` small enough for many),
  zero3 against zero2 and off;
- zero1 on the int8 ring against off on the int8 ring;
- zero1 with AdamW, a cosine schedule and warmup against off with them;
- ``remat``: each step's gradient before the sync, the losses and the
  running statistics against the run without it (the recompute's sync-BN
  all-reduce runs again; its running-statistics update does not).

Under zero3 the param buffer is freed after each step (it is not
resident when the run ends).  Against the JAX package:
``make_train_step(shard_update='zero1'|'zero3')`` on a W-device slice of
the 8-device CPU mesh with the fp16 codec, over two steps.  The two
packages' convolutions sum in other orders, and Adam's first steps move
a param by ±lr wherever a gradient near zero changes sign, so their
trajectories part by more than a fixed tolerance tells apart from a
fault.  The control is the port's ``off`` against JAX's ``off`` on the
same data: every leaf of the port's zero1/zero3 params and statistics
lies as close to JAX's zero1/zero3 as that (and within 2·lr a step), and
the losses agree at rtol 1e-4.
Also here, without processes: the comm plan's bytes for zero1, zero3, the
ring and bucketed syncs against JAX's ``comm_plan``, the state bytes under
each level, and the refusals.
"""

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
from ddlpc_tpu.obs import comm as jcomm
from ddlpc_tpu.parallel import shard_update as jzero
from ddlpc_tpu.parallel import train_step as jts
from ddlpc_tpu_torch.config import CompressionConfig, ModelConfig, TrainConfig
from ddlpc_tpu_torch.convert import flax_from_torch, torch_state_from_flax
from ddlpc_tpu_torch.models import build_model
from ddlpc_tpu_torch.obs import comm, hbm
from ddlpc_tpu_torch.parallel.train_step import create_train_state, make_train_step
from ddlpc_tpu_torch.train.optim import build_optimizer
from test_torch_model import flax_like_variables
from test_torch_train_step import LR, TINY, _flat
from test_torch_dist_worker import run_world
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

W, A, BL, STEPS = 2, 2, 2, 3
JAX_STEPS = 2  # against JAX, the horizon of tests/test_torch_dist_train.py
FP16 = {"mode": "float16"}
BUCKETS = {"mode": "float16", "bucket_mb": 0.005}  # 17 buckets of the tiny U-Net
RING = {"mode": "int8", "transport": "ring"}
NONE = {"mode": "none"}
ADAMW = {"optimizer": "adamw", "weight_decay": 1e-2, "lr_schedule": "cosine", "warmup_steps": 1}
RUNS = {
    "off": dict(level="off", compression=FP16),
    "zero1": dict(level="zero1", compression=FP16),
    "zero2": dict(level="zero2", compression=FP16),
    "zero3": dict(level="zero3", compression=FP16),
    "off_buckets": dict(level="off", compression=BUCKETS),
    "zero2_buckets": dict(level="zero2", compression=BUCKETS),
    "zero3_buckets": dict(level="zero3", compression=BUCKETS),
    "off_ring": dict(level="off", compression=RING),
    "zero1_ring": dict(level="zero1", compression=RING),
    "off_adamw": dict(level="off", compression=FP16, train=ADAMW),
    "zero1_adamw": dict(level="zero1", compression=FP16, train=ADAMW),
    "off_remat": dict(level="off", compression=FP16, remat=True),
    "off_none": dict(level="off", compression=NONE),
    "zero3_none": dict(level="zero3", compression=NONE),
    "off_2": dict(level="off", compression=FP16, steps=JAX_STEPS),
    "zero1_2": dict(level="zero1", compression=FP16, steps=JAX_STEPS),
    "zero3_2": dict(level="zero3", compression=FP16, steps=JAX_STEPS),
}
SAME = [  # (run, the run it equals bit for bit)
    ("zero1", "off"), ("zero2", "off"), ("zero3", "off"),
    ("zero2_buckets", "off_buckets"), ("zero3_buckets", "off_buckets"),
    ("zero1_ring", "off_ring"), ("zero1_adamw", "off_adamw"), ("off_remat", "off"),
    ("zero3_none", "off_none"),
]
_WORLD: dict = {}


def _batches():
    bg = BL * W
    ds = jdatasets.SyntheticTiles(num_tiles=STEPS * A * bg, image_size=(32, 32), seed=6)
    labels = ds.labels.copy()
    labels[:, :3, :5] = -1
    return (ds.images.reshape(STEPS, A, bg, 32, 32, 3), labels.reshape(STEPS, A, bg, 32, 32))


def _initial():
    variables = flax_like_variables(jbuild_model(JModelConfig(**TINY)))
    return variables["params"], variables["batch_stats"]


def _world(tmp_path_factory) -> list:
    if not _WORLD:
        images, labels = _batches()
        params0, stats0 = _initial()
        sd, _ = torch_state_from_flax(params0, stats0)
        inputs = {f"sd/{k}": v.numpy() for k, v in sd.items()}
        inputs.update(images=images, labels=labels)
        task = {"model": {k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()},
                "lr": LR, "local_batch": BL, "runs": list(RUNS.values())}
        work = str(tmp_path_factory.mktemp("zero_levels"))
        _WORLD["outs"] = run_world("step", W, work, task, inputs, deadline_s=240.0)
    return _WORLD["outs"]


def _run(out: dict, name: str) -> dict:
    i = list(RUNS).index(name)
    return {k[len(f"{i}:"):]: v for k, v in out.items() if k.startswith(f"{i}:")}


@pytest.mark.parametrize("run,base", SAME)
def test_levels_and_options_equal_their_base_bit_for_bit(run, base, tmp_path_factory):
    outs = _world(tmp_path_factory)
    for r, out in enumerate(outs):
        got, want = _run(out, run), _run(out, base)
        names = [k for k in want if k.startswith(("sd/", "mu/", "nu/"))]
        assert names and sorted(names) == sorted(k for k in got if k.startswith(("sd/", "mu/", "nu/")))
        for k in names:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"rank {r} {run} {k}")
        assert int(got["count"]) == int(want["count"]) == STEPS
        for s in range(STEPS):
            assert got[f"loss{s}"] == want[f"loss{s}"]
            np.testing.assert_array_equal(got[f"grad{s}"], want[f"grad{s}"], err_msg=f"{run} grad{s}")
        # Every rank holds the same model.
        for k in names:
            np.testing.assert_array_equal(got[k], _run(outs[0], run)[k])
        assert bool(got["resident"]) == (RUNS[run]["level"] != "zero3")


def _run_jax(level: str) -> dict:
    images, labels = _batches()
    params0, stats0 = _initial()
    jmodel = jbuild_model(JModelConfig(**TINY), norm_axis_name="data")
    tx = optax.adam(LR)
    mesh = Mesh(np.array(jax.devices()[:W]), ("data",))
    state = jts.TrainState(
        step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.asarray, params0),
        batch_stats=jax.tree.map(jnp.asarray, stats0),
        opt_state=tx.init(jax.tree.map(jnp.asarray, params0)),
    )
    layout = jzero.StateLayout("replicated" if level == "off" else level, tx, state, mesh, "data")
    pstate = layout.place(state)
    step = jts.make_train_step(jmodel, tx, mesh, JCompression(**FP16), donate_state=False,
                               shard_update=level, param_avals=layout.param_avals)
    losses = []
    for x, y in zip(images[:JAX_STEPS], labels[:JAX_STEPS]):
        pstate, m = step(pstate, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(m["loss"]))
    canon = layout.canonical(pstate)
    return {"params": _flat(canon.params), "batch_stats": _flat(canon.batch_stats), "losses": losses}


_JAX: dict = {}


def _port_tree(out: dict) -> dict:
    sd = {k[len("sd/"):]: torch.from_numpy(v) for k, v in out.items() if k.startswith("sd/")}
    params, stats, _ = flax_from_torch(sd)
    return {"params": _flat(params), "batch_stats": _flat(stats)}


@pytest.mark.parametrize("level", ["zero1", "zero3"])
def test_levels_match_jax(level, tmp_path_factory):
    """The port's level against JAX's, held to the port's ``off`` against
    JAX's ``off`` on the same data: as close, leaf for leaf."""
    outs = _world(tmp_path_factory)
    for lv in ("off", level):
        if lv not in _JAX:
            _JAX[lv] = _run_jax(lv)
    got = _run(outs[0], f"{level}_{JAX_STEPS}")
    base = _run(outs[0], f"off_{JAX_STEPS}")
    np.testing.assert_allclose([float(got[f"loss{s}"]) for s in range(JAX_STEPS)],
                               _JAX[level]["losses"], rtol=1e-4)
    mine, control = _port_tree(got), _port_tree(base)
    for part in ("params", "batch_stats"):
        for k, want in _JAX[level][part].items():
            diff = np.abs(mine[part][k] - want).max()
            ref = np.abs(control[part][k] - _JAX["off"][part][k]).max()
            assert diff <= ref * (1 + 1e-3) + 1e-6, (part, k, diff, ref)
            assert diff <= JAX_STEPS * 2 * LR, (part, k, diff)


# --- without processes ----------------------------------------------------------


@pytest.mark.parametrize("variant,level,codec,world,buckets", [
    ("zero1", "zero1", {"mode": "float16"}, 4, 1),
    ("zero1", "zero1", {"mode": "int8"}, 2, 3),
    ("zero3", "zero3", {"mode": "float16"}, 4, 1),
    ("zero3", "zero3", {"mode": "float16"}, 8, 5),
    ("zero3", "zero3", {"mode": "int8"}, 16, 2),
    ("scatter", "zero2", {"mode": "int8"}, 4, 7),
    ("allreduce", "off", {"mode": "float16"}, 4, 9),
    ("ring", "off", {"mode": "int8", "transport": "ring"}, 4, 1),
    ("ring", "zero1", {"mode": "int8", "transport": "ring"}, 4, 1),
    ("ring", "off", {"mode": "float16", "transport": "ring"}, 3, 1),
])
def test_comm_plan_of_the_new_variants_against_jax(variant, level, codec, world, buckets):
    n = 8_372_422
    padded = world * (-(-(-(-n // world)) // 32) * 32) + 128 * (buckets - 1)
    assert comm.step_variant(CompressionConfig(**codec), level) == variant
    assert jcomm.comm_plan(n, n, JCompression(**codec), world, variant, n_buckets=buckets)
    port = comm.comm_plan(n, padded, CompressionConfig(**codec), world, variant,
                          n_buckets=buckets, level=level)
    want = jcomm.comm_plan(n, n, JCompression(**codec), world, variant, n_buckets=buckets)
    for p, j in zip(port, want):
        for key in ("collective", "codec", "bytes_pre", "bytes_post"):
            assert p[key] == j[key], key
    if variant == "ring":
        assert port[0]["bytes_wire"] == want[0]["bytes_wire"]
        assert port[0]["wire_dtype"] == want[0]["wire_dtype"]
        # zero1 publishes the params after the ring; JAX's plan leaves it out.
        assert len(port) == len(want) + (level == "zero1")
        return
    assert len(port) == len(want)
    narrow = port[0]["wire_dtype"] != "f32"
    scales = int(narrow) + int(variant in ("scatter", "zero3") and codec["mode"] != "none")
    item = {"s8": 1, "s32": 4, "f16": 2, "f32": 4}[port[0]["wire_dtype"]]
    assert port[0]["bytes_wire"] == padded * item + 4 * scales * buckets
    if len(port) > 1:
        assert port[1]["bytes_wire"] == padded * 4


@pytest.mark.parametrize("level", ["off", "zero1", "zero2", "zero3"])
def test_state_bytes_by_level(level):
    world = 4
    cfg = ModelConfig(**TINY)
    tx = build_optimizer(TrainConfig(learning_rate=LR))
    state = create_train_state(build_model(cfg), tx, world, level, bucket_mb=0.005)
    flat = state.params
    got = hbm.state_hbm_bytes(state, level)
    full = flat.data.numel() * 4
    assert len(flat.regions) > 1 and flat.shard * world == flat.data.numel()
    assert got["params"] == (flat.shard * 4 if level == "zero3" else full)
    assert got["grads"] == (flat.shard * 4 if level in ("zero2", "zero3") else full)
    assert got["grads_accum"] == full
    assert got["opt_state"] == 2 * (full if level == "off" else flat.shard * 4)
    if level == "zero3":
        state.release_params()
        assert flat.data.untyped_storage().nbytes() == 0
        flat.materialize()
        assert flat.data.untyped_storage().nbytes() == full


def test_refusals_match_jax():
    """A clip by global norm composes with no chunked level, in the port's
    step as in the JAX package's resolution (whose words it takes); every
    level is known; a scatter level refuses the ring."""
    clip = build_optimizer(TrainConfig(learning_rate=LR, grad_clip_norm=1.0))
    for level in ("zero1", "zero2", "zero3"):
        with pytest.raises(ValueError, match="grad_clip_norm > 0"):
            make_train_step(clip, CompressionConfig(**FP16), 2, level=level)
        with pytest.raises(ValueError, match="grad_clip_norm > 0"):
            jzero.resolve_shard_update(level, JCompression(**FP16), 2, False, 1.0)
    for level in ("zero2", "zero3"):
        with pytest.raises(ValueError, match="transport='ring' owns its own"):
            make_train_step(build_optimizer(TrainConfig()), CompressionConfig(**RING), 2, level=level)
    make_train_step(build_optimizer(TrainConfig()), CompressionConfig(**RING), 2, level="zero1")
    with pytest.raises(ValueError, match="unknown shard_update level"):
        make_train_step(build_optimizer(TrainConfig()), CompressionConfig(**FP16), 2, level="zero4")
