"""The port's GPipe pipeline driver (``ddlpc_tpu_torch/parallel/pipeline.py``)
against the JAX package's ``PipelineTrainStep`` (``tests/test_pipeline.py``).

JAX runs its driver on a (pipe 2 × data 2) slice of the 8-device CPU mesh;
the port runs a (pipe 2 × data 2) grid of four gloo processes
(``tests/test_torch_grid_worker.py``), each rank holding one stage for one
replica, both from the same flax weights (the tiny U-Net of
``tests/test_pipeline.py``: features [4, 8], fp32, local BatchNorm), over
the same four micro-batches a step, three steps.  Tolerances:

- the losses at atol 1e-5, the canonical params and BatchNorm statistics
  at max |Δ| < 3e-5 (``tests/test_pipeline.py``'s bounds for the staged
  driver against the monolithic step);
- bit for bit where JAX pins bits: zero2 within the stages equals off
  (params and moments), ``pipeline_stages = 1`` is the unstaged step, and
  a ``canonical()`` snapshot written as a checkpoint and restored into a
  fresh driver continues as the uninterrupted run;
- ``last_schedule`` equal to JAX's dict;
- with a codec in the stage update (the flagship's fp16 with
  ``quantize_local``, and int8 with stochastic rounding, whose noise is
  JAX's own fields handed to each stage as ``test_torch_train_step_stochastic.py``
  hands them to the unstaged step): the codec-off bounds above, losses
  at atol 1e-5 and params and statistics at max |Δ| < 3e-5 (no lattice
  point flips on these inputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddlpc_tpu.config import CompressionConfig as JCompression
from ddlpc_tpu.config import ParallelConfig as JParallel
from ddlpc_tpu.models.unet import UNet as JUNet
from ddlpc_tpu.obs import hbm as jhbm
from ddlpc_tpu.parallel.mesh import make_mesh
from ddlpc_tpu.parallel.pipeline import make_pipeline_train_step as jmake_pipeline
from ddlpc_tpu.parallel.train_step import create_train_state as jcreate_train_state
from ddlpc_tpu_torch.config import CompressionConfig, TrainConfig
from ddlpc_tpu_torch.convert import (
    gather_canonical,
    torch_state_from_flax,
    torch_stage_states_from_flax,
)
from ddlpc_tpu_torch.models.unet import UNet
from ddlpc_tpu_torch.obs import hbm
from ddlpc_tpu_torch.parallel import mesh
from ddlpc_tpu_torch.parallel import train_step as ts
from ddlpc_tpu_torch.parallel.pipeline import make_pipeline_train_step
from ddlpc_tpu_torch.train.optim import build_optimizer
from test_torch_grid_worker import start_grid
from test_torch_train_step import _flat
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

M, B, H, W, C, NC = 4, 8, 16, 16, 3, 4
LR = 1e-3
STEPS = 3
MODEL = dict(num_classes=NC, features=[4, 8], bottleneck_features=8)
# The stage update's codecs held against JAX's, by the index of their run
# in the grid's task (runs 0 and 1 are the codec off at off and zero2).
CODECS = {"float16_local": (2, dict(mode="float16", quantize_local=True)),
          "int8_stochastic": (3, dict(mode="int8", rounding="stochastic"))}


def _jmodel():
    return JUNet(num_classes=NC, features=(4, 8), bottleneck_features=8, norm="batch",
                 norm_axis_name=None, dtype=jnp.float32)


def _data():
    kx, ky = jax.random.split(jax.random.key(1))
    images = np.asarray(jax.random.normal(kx, (M, B, H, W, C), jnp.float32))
    labels = np.asarray(jax.random.randint(ky, (M, B, H, W), 0, NC))
    return images, labels


_RUNS: dict = {}


def _jax_run(full, images, labels, jcomp) -> dict:
    """JAX's ``PipelineTrainStep`` at pipe 2 × data 2, ``STEPS`` steps."""
    jmodel, tx = _jmodel(), optax.adam(LR)
    jmesh = make_mesh(JParallel(pipeline_stages=2, data_axis_size=2), jax.devices()[:4])
    drv = jmake_pipeline(jmodel, tx, jmesh, jcomp, n_microbatches=M)
    pstate = drv.init_state(full)
    losses = []
    for _ in range(STEPS):
        pstate, pm = drv.step(pstate, images, labels)
        losses.append(pm["loss"])
    can = drv.canonical(pstate)
    return {"losses": losses, "params": _flat(can.params), "batch_stats": _flat(can.batch_stats),
            "schedule": dict(drv.last_schedule), "drv": drv}


def _jax_noise(plan, params, jcomp) -> dict:
    """The U[0,1) fields JAX's stage update draws for stochastic rounding,
    as the grid worker's ``noise<stage>/<k0>_<k1>/<param>`` inputs: for each
    stage and step, ``_sync_tree``'s local key with each replica folded in
    and its shared mean key, split one key a leaf of the stage's tree,
    each filed under the Philox key the port's stage update asks for."""
    from ddlpc_tpu.parallel.train_step import _rounding_rng
    from ddlpc_tpu_torch.ops import philox

    out = {}
    for s, tree in enumerate(plan.split(params)):
        leaves, treedef = jax.tree_util.tree_flatten(tree)
        for t in range(STEPS):
            local, mean = jax.random.split(_rounding_rng(jcomp, 0, jnp.int32(t)))
            draws = [(philox.rounding_key(0, t, "local", r), jax.random.fold_in(local, r))
                     for r in range(2)]
            draws.append((philox.rounding_key(0, t, "mean"), mean))
            for (k0, k1), key in draws:
                keys = jax.random.split(key, len(leaves))
                fields = jax.tree_util.tree_unflatten(treedef, [
                    np.asarray(jax.random.uniform(k, leaf.shape)) for k, leaf in zip(keys, leaves)])
                usd, _ = torch_state_from_flax(fields, {})
                out.update({f"noise{s}/{k0}_{k1}/{n}": v.numpy() for n, v in usd.items()})
    return out


def _both(tmp_path_factory):
    if "runs" in _RUNS:
        return _RUNS["runs"]
    jmodel, tx = _jmodel(), optax.adam(LR)
    full = jax.device_get(jcreate_train_state(jmodel, tx, jax.random.key(0), (1, H, W, C)))
    images, labels = _data()
    jout = _jax_run(full, images, labels, JCompression())
    drv = jout.pop("drv")
    sd, _ = torch_state_from_flax(full.params, full.batch_stats)
    inputs = {f"sd/{k}": v.numpy() for k, v in sd.items()}
    inputs.update(images=images, labels=labels)
    inputs.update(_jax_noise(drv.plan, full.params,
                             JCompression(**CODECS["int8_stochastic"][1])))
    runs = [{"level": "off"}, {"level": "zero2"}]
    for name, (i, comp) in CODECS.items():
        assert len(runs) == i, name
        runs.append({"level": "off", "compression": comp})
    task = {"model": MODEL, "lr": LR, "m": M, "steps": STEPS, "roundtrip": True, "runs": runs}
    # The world runs while JAX's codec arms are computed.
    world = start_grid("pipeline", (2, 2, 1), str(tmp_path_factory.mktemp("pipe2")), task, inputs)
    stash = jhbm.pipeline_carry_stash_bytes(drv.carry_avals((B, H, W, C))[0], M, 2)
    jout.update(stash=stash, full=full, plan=drv.plan, codecs={})
    for name, (_, comp) in CODECS.items():
        jout["codecs"][name] = _jax_run(full, images, labels, JCompression(**comp))
    _RUNS["runs"] = (jout, world.result(), inputs)
    return _RUNS["runs"]


def _port(out: dict, prefix: str, part: str) -> dict:
    from ddlpc_tpu_torch.convert import flax_from_torch

    sd = {k[len(prefix) + 3:]: torch.from_numpy(v) for k, v in out.items()
          if k.startswith(prefix + "sd/")}
    params, stats, _ = flax_from_torch(sd)
    return _flat(params if part == "params" else stats)


def test_pipe2_matches_jax_pipeline_train_step(tmp_path_factory):
    jout, outs, _ = _both(tmp_path_factory)
    for r, out in enumerate(outs):
        got = [float(out[f"0:loss{t}"]) for t in range(STEPS)]
        np.testing.assert_allclose(got, jout["losses"], atol=1e-5, err_msg=f"rank {r}")
        for part in ("params", "batch_stats"):
            mine = _port(out, "0:", part)
            assert mine.keys() == jout[part].keys()
            worst = max(float(np.abs(mine[k] - v).max()) for k, v in jout[part].items())
            assert worst < 3e-5, (part, worst)


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_pipe2_codec_matches_jax_pipeline_train_step(codec, tmp_path_factory):
    """The stage update's codec (each stage's absmax, buckets and rounding
    keys over its own data group) against JAX's, up to lattice flips."""
    jout, outs, _ = _both(tmp_path_factory)
    want = jout["codecs"][codec]
    i = CODECS[codec][0]
    for r, out in enumerate(outs):
        got = [float(out[f"{i}:loss{t}"]) for t in range(STEPS)]
        np.testing.assert_allclose(got, want["losses"], atol=1e-5, err_msg=f"rank {r}")
        for part in ("params", "batch_stats"):
            mine = _port(out, f"{i}:", part)
            assert mine.keys() == want[part].keys()
            worst = max(float(np.abs(mine[k] - v).max()) for k, v in want[part].items())
            assert worst < 3e-5, (part, worst)
        # Stochastic rounding drew JAX's fields on every rank: two stage
        # keys (local, mean) a step; nearest rounding draws none.
        assert int(out[f"{i}:noise_keys"]) == (2 * STEPS if codec == "int8_stochastic" else 0)
        # The codec ran: the params are not the codec-off run's.
        assert any(not np.array_equal(out[k], out["0:" + k[len(f"{i}:"):]])
                   for k in out if k.startswith(f"{i}:sd/"))


def test_last_schedule_equals_jax(tmp_path_factory):
    jout, outs, _ = _both(tmp_path_factory)
    for out in outs:
        got = {k: out[f"0:sched/{k}"].item() for k in jout["schedule"]}
        assert got == pytest.approx(jout["schedule"])
    assert jout["schedule"] == {"executed_slots": 12, "idle_slots": 2, "measured_bubble": 0.1429}


def test_zero2_within_stages_is_byte_equal_to_off(tmp_path_factory):
    _, outs, _ = _both(tmp_path_factory)
    for out in outs:
        for k in out:
            if k.startswith("0:") and ("sd/" in k or "mu/" in k or "nu/" in k):
                np.testing.assert_array_equal(out["1:" + k[2:]], out[k], err_msg=k)


def test_canonical_checkpoint_round_trip(tmp_path_factory):
    """canonical(init_state(x)) is x, and a snapshot written through the
    port's checkpoint and restored into a fresh driver continues bit for
    bit as the uninterrupted run."""
    _, outs, inputs = _both(tmp_path_factory)
    for out in outs:
        for k, v in inputs.items():
            if k.startswith("sd/"):
                np.testing.assert_array_equal(out["rt0:" + k], v, err_msg=k)
        for k in out:
            if k.startswith("rt_cont:"):
                np.testing.assert_array_equal(out["rt_res:" + k[8:]], out[k], err_msg=k)


def test_carry_stash_equals_jax_pricing(tmp_path_factory):
    jout, _, _ = _both(tmp_path_factory)
    drv = _driver_on_fake_grid()
    shapes = drv.carry_shapes((B, H, W, C))
    assert len(shapes) == 1
    assert hbm.pipeline_carry_stash_bytes(shapes[0], M, 2) == jout["stash"]
    # What the last stage's ranks held: M carries of their B/2 columns.
    _, outs, _ = _both(tmp_path_factory)
    assert [int(out["0:stash"]) for out in outs] == [0, 0, jout["stash"], jout["stash"]]


def test_jax_stage_trees_map_into_the_port_stages(tmp_path_factory):
    """``StagePlan.split`` and ``split_opt_state`` of the JAX package, mapped
    by ``convert.torch_stage_states_from_flax``, are the port's stages'
    leaves by name and value."""
    from flax import serialization

    from ddlpc_tpu.parallel.pipeline import split_opt_state as jsplit_opt_state

    jout, _, _ = _both(tmp_path_factory)
    full, plan = jout["full"], jout["plan"]
    p_split, s_split = plan.split(full.params), plan.split(full.batch_stats)
    o_split = [serialization.to_state_dict(o)
               for o in jsplit_opt_state(optax.adam(LR), full.opt_state, p_split)]
    tx = build_optimizer(TrainConfig(learning_rate=LR))
    stages = torch_stage_states_from_flax(p_split, s_split, o_split, tx.layout())
    drv = _driver_on_fake_grid()
    sd, _ = torch_state_from_flax(full.params, full.batch_stats)
    for s, (ssd, sopt) in enumerate(stages):
        assert set(ssd) == {k for k in sd if drv.plan.stage_of(k) == s}
        for k, v in ssd.items():
            np.testing.assert_array_equal(v.numpy(), sd[k].numpy())
        assert set(sopt["mu"]) == {k for k in ssd if "running" not in k}


def _driver_on_fake_grid(pipe=2, space=1, **kw):
    prev = mesh._GRID
    mesh._GRID = mesh.Grid(pipe, 1, space, 0)
    try:
        return make_pipeline_train_step(UNet(**MODEL, dtype=torch.float32),
                                        build_optimizer(TrainConfig(learning_rate=LR)),
                                        kw.pop("compression", CompressionConfig()), M, **kw)
    finally:
        mesh._GRID = prev


def test_refusals_in_the_jax_words():
    jmodel = _jmodel()
    cases = [
        (dict(space=2), JParallel(pipeline_stages=2, space_axis_size=2, data_axis_size=2), {}),
        (dict(shard_update="zero3"), JParallel(pipeline_stages=2), {"shard_update": "zero3"}),
        (dict(shard_update="zero2", compression=CompressionConfig(
            mode="int8", codec_backend="pallas")),
         JParallel(pipeline_stages=2), {"shard_update": "zero2"}),
    ]
    for kw, jpar, jkw in cases:
        jcomp = JCompression(**kw["compression"].__dict__) if "compression" in kw else JCompression()
        with pytest.raises(ValueError) as want:
            jmake_pipeline(jmodel, optax.adam(LR), make_mesh(jpar), jcomp, n_microbatches=M, **jkw)
        with pytest.raises(ValueError) as got:
            _driver_on_fake_grid(**kw)
        assert str(got.value) == str(want.value)


def test_step_validates_microbatch_count():
    drv = _driver_on_fake_grid()
    images, labels = _data()
    with pytest.raises(ValueError, match="n_microbatches"):
        drv.step(None, images[: M - 1], labels[: M - 1])


def test_pipe1_delegates_bit_identically():
    """One stage: the driver is ``make_train_step`` — the same params,
    statistics and moments bit for bit, and a schedule with no bubble."""
    images, labels = _data()
    tx = build_optimizer(TrainConfig(learning_rate=LR))
    comp = CompressionConfig()
    states = []
    for _ in range(2):
        model = UNet(**MODEL, dtype=torch.float32, seed=3)
        states.append(ts.create_train_state(model, tx, 1, "off"))
    drv = make_pipeline_train_step(UNet(**MODEL, dtype=torch.float32), tx, comp, M)
    assert drv.n_stages == 1
    p = drv.init_state(states[0])
    mono = ts.make_train_step(tx, comp, 1)
    for _ in range(2):
        p, pm = drv.step(p, images, labels)
        rm = mono(states[1], torch.from_numpy(images), torch.from_numpy(labels).long())
        assert pm["loss"] == float(rm["loss"])
    assert drv.last_schedule == {"executed_slots": M, "idle_slots": 0, "measured_bubble": 0.0}
    a, b = gather_canonical(drv.canonical(p)), gather_canonical(states[1])
    for k in a[0]:
        np.testing.assert_array_equal(a[0][k].numpy(), b[0][k].numpy(), err_msg=k)
    for key in ("mu", "nu"):
        for k in a[1][key]:
            np.testing.assert_array_equal(a[1][key][k].numpy(), b[1][key][k].numpy())


def test_stage_hbm_bytes_scale_with_the_stage():
    """Each stage's resident state, priced as ``obs/hbm.py`` prices it, is
    its share of the unstaged state's."""
    drv = _driver_on_fake_grid()
    model = UNet(**MODEL, dtype=torch.float32)
    tx = build_optimizer(TrainConfig(learning_rate=LR))
    full = ts.create_train_state(model, tx, 1, "off")
    whole = hbm.state_hbm_bytes(full)
    per = []
    for s in range(2):
        drv.stage = s
        drv.blocks = drv.plan.stage_blocks(s)
        modules = drv._template.pipeline_block_modules()
        drv._stage_paths = [m for b in drv.blocks for m in modules[b]]
        per.append(hbm.pipeline_stage_hbm_bytes([drv.init_state(full).stages[0]])[0])
    for kind in ("params", "opt_state", "batch_stats"):
        assert sum(p[kind] for p in per) == whole[kind], kind
