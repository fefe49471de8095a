"""The port's space axis against the JAX package's GSPMD path
(``make_train_step_gspmd``, ``make_eval_step_gspmd``, the loaders'
``space_axis``).

The tiny U-Net of ``tests/test_torch_train_step.py`` (features [8, 16],
fp32, s2d ×2, DetailHead) trains two optimizer steps of the fp16 codec on
the mean (``quantize_local=False``, as the spatial step requires) on a
(data 2 × space 2) grid of four gloo processes
(``tests/test_torch_grid_worker.py``), every rank starting from the same
seeded weights in the flax layout and taking its own columns and rows of
the same numpy batches, whose void labels lie in the top shard only (so
each shard's valid-pixel count differs).  JAX runs
``make_train_step_gspmd`` on a (2, 2) slice of the 8-device CPU mesh.
Tolerances, those of ``tests/test_torch_dist_train.py``:

- the losses at rtol 1e-4, the BatchNorm statistics at rtol 1e-4 /
  atol 1e-6;
- params at rtol 1e-4 / atol 1e-6 but for at most 2 % of them (the fp16
  codec's lattice flips), each within ``2·lr`` a step.

The same world trains the same model at two heights its shards split
unevenly (``UNEVEN``): 24 rows, 12 a shard, 1.5 of the model's row unit
of 8 (s2d ×2, two pools), so that the 6-row level is resharded to even
boundaries before its pool (3 and 3 become 2 and 4); and 8 rows, 4 a
shard, half a unit, so that the bottleneck's one row lies on one rank
and the other holds none.  Same tolerances, against JAX's GSPMD step at
the same heights on the same (2, 2) grid, except at 8 rows: there JAX's
(2, 2) program is the one of its programs that differs from the others.
Its first loss is 1.9e-6 from the one that its (1, 1), (1, 2), (2, 1)
and (1, 4) programs agree on (computing in float32 or float64 alike),
and the fp16 codec's lattice turns that into 1,716 of 22,358 params
outside the tolerance after the first step, a second loss 7.0e-4 off
and 52 % of the params outside after the second (without the codec the
second losses agree), while its (2, 1) and (1, 2) programs agree on
every param bit for bit.  So at 8 rows the first loss is held against
the (2, 2) program, and the losses, statistics and params of both steps
against the (2, 1) slice's, the same global batch over the same data
axis.

The ZeRO layouts (JAX's ``gspmd``, ``gspmd_zero2``, ``gspmd_zero3``) equal
the replicated spatial step bit for bit, as ``tests/test_shard_update.py``
pins for JAX, and every rank holds the same state bit for bit.  Without
norm or codec the spatial step equals the port's 4-way data-parallel step
at atol 1e-5 (``tests/test_halo.py``'s bound for the same comparison).
The loaders' rows are JAX's shards byte for byte.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ddlpc_tpu.config import CompressionConfig as JCompression
from ddlpc_tpu.config import ModelConfig as JModelConfig
from ddlpc_tpu.config import ParallelConfig as JParallel
from ddlpc_tpu.data import datasets as jdatasets
from ddlpc_tpu.data.loader import DeviceCachedLoader as JDeviceCachedLoader
from ddlpc_tpu.data.loader import ShardedLoader as JShardedLoader
from ddlpc_tpu.data.loader import eval_batches as jeval_batches
from ddlpc_tpu.models import build_model as jbuild_model
from ddlpc_tpu.parallel import train_step as jts
from ddlpc_tpu.parallel.mesh import make_mesh
from ddlpc_tpu_torch.config import CompressionConfig, ModelConfig, TrainConfig
from ddlpc_tpu_torch.convert import flax_from_torch, torch_state_from_flax
from ddlpc_tpu_torch.data.datasets import TileDataset
from ddlpc_tpu_torch.data.loader import DeviceCachedLoader, ShardedLoader, eval_batches
from ddlpc_tpu_torch.models import build_model, check_space_rows, shard_space
from ddlpc_tpu_torch.parallel.train_step import make_train_step_spatial
from ddlpc_tpu_torch.train.__main__ import parse_args
from ddlpc_tpu_torch.train.optim import build_optimizer
from ddlpc_tpu_torch.train.trainer import Trainer
from test_torch_dist_worker import run_world
from test_torch_grid_worker import run_grid, start_grid
from test_torch_model import flax_like_variables
from test_torch_train_step import _OFF, LR, TINY, _flat, _tiny_cli_config
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

A, B, STEPS, H = 2, 4, 2, 32  # micro-batches a step, global micro-batch, steps, rows
CODEC = {"mode": "float16", "quantize_local": False}
LEVELS = ("off", "zero1", "zero2", "zero3")
UNEVEN = {"h24": 24, "h8": 8}  # runs at heights the space axis splits unevenly
# The JAX grid each uneven run's steps past the first are held against.
UNEVEN_GRID = {"h24": (2, 2), "h8": (2, 1)}


def _batches(h=H, classes=6):
    ds = jdatasets.SyntheticTiles(num_tiles=STEPS * A * B, image_size=(h, h), seed=4,
                                  num_classes=classes)
    labels = ds.labels.copy()
    labels[:, :5, :7] = -1  # void pixels, all in the top space shard
    return (ds.images.reshape(STEPS, A, B, h, h, 3), labels.reshape(STEPS, A, B, h, h))


def _jax_gspmd(params0, stats0, images, labels, model_kw, codec, grid=(2, 2)):
    """JAX's ``make_train_step_gspmd`` on a ``grid`` = (data, space) slice
    of the CPU mesh: the losses, the final params and statistics, and the
    params after each step (``step_params``)."""
    jmodel = jbuild_model(JModelConfig(**model_kw))
    tx = optax.adam(LR)
    mesh = make_mesh(JParallel(data_axis_size=grid[0], space_axis_size=grid[1]),
                     jax.devices()[: grid[0] * grid[1]])
    params = jax.tree.map(jnp.asarray, params0)
    state = jts.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree.map(jnp.asarray, stats0),
                           opt_state=tx.init(params))
    state = jax.device_put(state, NamedSharding(mesh, P()))
    step = jts.make_train_step_gspmd(jmodel, tx, mesh, JCompression(**codec), donate_state=False)
    sh = NamedSharding(mesh, P(None, "data", "space"))
    losses, step_params = [], []
    for x, y in zip(images, labels):
        state, m = step(state, jax.device_put(x, sh), jax.device_put(y, sh))
        losses.append(float(m["loss"]))
        step_params.append(_flat(jax.device_get(state.params)))
    state = jax.device_get(state)
    return {"params": _flat(state.params), "batch_stats": _flat(state.batch_stats),
            "losses": losses, "step_params": step_params}


_RUNS: dict = {}


def _tiny(tmp_path_factory):
    if "tiny" not in _RUNS:
        images, labels = _batches()
        variables = flax_like_variables(jbuild_model(JModelConfig(**TINY)))
        params0, stats0 = variables["params"], variables["batch_stats"]
        sd, _ = torch_state_from_flax(params0, stats0)
        inputs = {f"sd/{k}": v.numpy() for k, v in sd.items()}
        inputs.update(images=images, labels=labels)
        runs = [{"level": lv} for lv in LEVELS]
        uneven = {name: _batches(h) for name, h in UNEVEN.items()}
        for name, (x, y) in uneven.items():
            inputs.update({f"{name}/sd/{k}": v.numpy() for k, v in sd.items()})
            inputs.update({f"{name}/images": x, f"{name}/labels": y})
            runs.append({"level": "off", "prefix": f"{name}/"})
        task = {"model": {k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()},
                "lr": LR, "compression": CODEC, "runs": runs, "every_step": True}
        # The world runs while JAX's steps are computed.
        world = start_grid("spatial", (1, 2, 2), str(tmp_path_factory.mktemp("spatial")), task,
                           inputs)
        # JAX's steps on threads of their own: JAX traces under the GIL,
        # and compiles and runs outside it.
        with ThreadPoolExecutor(4) as pool:
            steps = {(name, g): pool.submit(_jax_gspmd, params0, stats0, x, y, TINY, CODEC,
                                            grid=g)
                     for name, (x, y) in uneven.items()
                     for g in {(2, 2), UNEVEN_GRID[name]}}
            want = _jax_gspmd(params0, stats0, images, labels, TINY, CODEC)
            for (name, g), step in steps.items():
                _RUNS.setdefault(name, {})[g] = step.result()
        _RUNS["tiny"] = (want, world.result(), labels)
    return _RUNS["tiny"]


def _port_part(out: dict, prefix: str, run: int = 0) -> dict:
    sd = {k[len(f"{run}:sd/"):]: torch.from_numpy(v) for k, v in out.items()
          if k.startswith(f"{run}:sd/")}
    params, stats, _ = flax_from_torch(sd)
    return _flat(params if prefix == "params" else stats)


def test_void_labels_split_unevenly_across_the_space_shards():
    _, labels = _batches()
    top, bottom = (int((labels[..., s * 16 : (s + 1) * 16, :] >= 0).sum()) for s in range(2))
    assert top < bottom


def test_spatial_step_losses_and_batch_stats_match_jax_gspmd(tmp_path_factory):
    jout, outs, _ = _tiny(tmp_path_factory)
    for r, out in enumerate(outs):
        np.testing.assert_allclose([float(out[f"0:loss{s}"]) for s in range(STEPS)],
                                   jout["losses"], rtol=1e-4, err_msg=f"rank {r}")
        got = _port_part(out, "batch_stats")
        for k, want in jout["batch_stats"].items():
            np.testing.assert_allclose(got[k], want, rtol=1e-4, atol=1e-6, err_msg=k)


def _params_near(got: dict, want: dict) -> None:
    """rtol 1e-4 / atol 1e-6 but for at most 2 % of the params, each within
    ``2·lr`` a step."""
    assert got.keys() == want.keys()
    total = off = 0
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        off += int((diff > 1e-4 * np.abs(w) + 1e-6).sum())
        total += w.size
        assert diff.max() <= STEPS * 2 * LR, (k, diff.max())
    assert off <= 2e-2 * total, (off, total)


def test_spatial_step_params_match_jax_gspmd_and_every_rank_agrees(tmp_path_factory):
    jout, outs, _ = _tiny(tmp_path_factory)
    _params_near(_port_part(outs[0], "params"), jout["params"])
    for out in outs[1:]:
        for k in outs[0]:
            np.testing.assert_array_equal(out[k], outs[0][k], err_msg=k)


def _uneven(name: str, tmp_path_factory):
    """JAX's outputs on the (2, 2) grid, on the grid its later steps are
    held against, and the world's run index, of an ``UNEVEN`` height."""
    _, outs, _ = _tiny(tmp_path_factory)
    run = len(LEVELS) + list(UNEVEN).index(name)
    return _RUNS[name][2, 2], _RUNS[name][UNEVEN_GRID[name]], run, outs


@pytest.mark.parametrize("name", list(UNEVEN))
def test_uneven_shards_losses_and_batch_stats_match_jax_gspmd(name, tmp_path_factory):
    first, jout, run, outs = _uneven(name, tmp_path_factory)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(float(out[f"{run}:loss0"]), first["losses"][0], rtol=1e-4,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose([float(out[f"{run}:loss{s}"]) for s in range(STEPS)],
                                   jout["losses"], rtol=1e-4, err_msg=f"rank {r}")
        got = _port_part(out, "batch_stats", run)
        assert got.keys() == jout["batch_stats"].keys()
        for k, want in jout["batch_stats"].items():
            np.testing.assert_allclose(got[k], want, rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", list(UNEVEN))
def test_uneven_shards_params_match_jax_gspmd_and_every_rank_agrees(name, tmp_path_factory):
    _, jout, run, outs = _uneven(name, tmp_path_factory)
    _params_near(_port_part(outs[0], "params", f"{run}:after0"), jout["step_params"][0])
    _params_near(_port_part(outs[0], "params", run), jout["params"])
    for out in outs[1:]:
        for k in outs[0]:
            if k.startswith(f"{run}:"):
                np.testing.assert_array_equal(out[k], outs[0][k], err_msg=k)


@pytest.mark.parametrize("run", [1, 2, 3], ids=[f"gspmd_{lv}" for lv in LEVELS[1:]])
def test_zero_layouts_are_bit_identical_to_replicated(run, tmp_path_factory):
    _, outs, _ = _tiny(tmp_path_factory)
    for out in outs:
        keys = [k[2:] for k in out if k.startswith("0:") and k != "0:flat"]
        for k in keys:
            np.testing.assert_array_equal(out[f"{run}:{k}"], out[f"0:{k}"], err_msg=k)


def test_spatial_step_equals_the_data_parallel_step(tmp_path_factory):
    """``tests/test_halo.py::test_gspmd_matches_dataparallel_step`` on the
    port: a (2, 2) spatial step and the 4-way data-parallel step, same data
    and weights, norm 'none', no codec."""
    model = dict(features=[8], bottleneck_features=8, num_classes=3, norm="none",
                 compute_dtype="float32")
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (1, 2, 8, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 3, (1, 2, 8, 16, 16)).astype(np.int32)
    variables = flax_like_variables(jbuild_model(JModelConfig(**model)))
    sd, _ = torch_state_from_flax(variables["params"], variables.get("batch_stats", {}))
    inputs = {f"sd/{k}": v.numpy() for k, v in sd.items()}
    inputs.update(images=x, labels=y)
    sp = run_grid("spatial", (1, 2, 2), str(tmp_path_factory.mktemp("sp_dp")),
                  {"model": model, "lr": LR, "compression": {"mode": "none"},
                   "runs": [{"level": "off"}]}, inputs)[0]
    dp = run_world("step", 4, str(tmp_path_factory.mktemp("dp")),
                   {"model": model, "lr": LR, "compression": {"mode": "none"}, "level": "off",
                    "local_batch": 2}, inputs)[0]
    assert abs(float(sp["0:loss0"]) - float(dp["loss0"])) < 1e-5
    for k in dp:
        if k.startswith("sd/"):
            np.testing.assert_allclose(sp[f"0:{k}"], dp[k], atol=1e-5, err_msg=k)


def test_refusals_in_the_jax_words():
    tx = build_optimizer(TrainConfig())
    jmodel = jbuild_model(JModelConfig(**TINY))
    mesh = make_mesh(JParallel(data_axis_size=2, space_axis_size=2), jax.devices()[:4])
    for kw in ({"mode": "float16"}, {"mode": "int8", "transport": "ring", "quantize_local": False},
               {"mode": "float16", "quantize_mean": False}):
        with pytest.raises(ValueError) as want:
            jts.make_train_step_gspmd(jmodel, optax.adam(LR), mesh, JCompression(**kw))
        with pytest.raises(ValueError) as got:
            make_train_step_spatial(tx, CompressionConfig(**kw), 2, 2)
        assert str(got.value) == str(want.value)
    # U-Net++, bilinear up-sampling and DeepLabV3+ shard since they were
    # ported, and every height JAX's GSPMD step takes shards, evenly or not
    # (24 rows over 2: 12 a shard, 1.5 of TINY's row unit of 8; the world
    # of ``test_uneven_shards_match_jax_gspmd`` trains it).  A height the
    # space axis does not divide is refused in the words of JAX's
    # ``device_put`` of the batch.
    for kw in (dict(name="unetpp", features=(8, 16)),
               dict(name="unetpp", features=(8, 16), up_sample_mode="bilinear"),
               dict(features=(8, 16), up_sample_mode="bilinear"),
               dict(name="deeplabv3p", features=(64, 128, 256, 512), width_divisor=16)):
        model = shard_space(build_model(ModelConfig(**kw)), 1, 2)
        assert model.space == 2
    check_space_rows(24, 2, TINY["stem_factor"], len(TINY["features"]))
    shape = (A, B, 25, H, 3)
    with pytest.raises(ValueError) as want:
        jax.device_put(np.zeros(shape, np.float32), NamedSharding(mesh, P(None, "data", "space")))
    with pytest.raises(ValueError) as got:
        check_space_rows(25, 2, TINY["stem_factor"], len(TINY["features"]), shape=shape)
    words = str(want.value)
    assert "which implies that" in words
    assert words[words.index("which implies that"):] in str(got.value)


def _cli_argv(tmp_path, workdir, epochs, space):
    return ["--config", _tiny_cli_config(tmp_path), "--device", "cpu", "--workdir", str(workdir),
            "--set", f"train.epochs={epochs}", "--set", f"parallel.space_axis_size={space}",
            "--set", "compression.quantize_local=False",
            "--set", "train.dump_images_per_epoch=0", "--set", "train.perf_accounting=False",
            "--set", "data.native_gather=False"]


def test_trainer_selects_the_spatial_path_trains_and_restores_both_ways(tmp_path):
    """``tests/test_halo.py::test_trainer_selects_gspmd_and_trains`` on the
    port, through the CLI in a world of (data 1 × space 2): two epochs with
    a checkpoint each; an unsharded trainer resumes the spatial run's
    checkpoint for a third, and a spatial world resumes that for a fourth."""
    workdir = tmp_path / "run"
    run_grid("cli", (1, 1, 2), str(tmp_path / "w1"),
             {"argv": _cli_argv(tmp_path, workdir, 2, 2)}, {})
    records = [json.loads(line) for line in (workdir / "metrics.jsonl").read_text().splitlines()
               if '"epoch"' in line and '"kind"' not in line]
    assert [r["epoch"] for r in records] == [0, 1]
    for r in records:
        assert np.isfinite(r["loss"]) and 0.0 <= r["val_miou"] <= 1.0
    cfg, _, device, _ = parse_args(_cli_argv(tmp_path, workdir, 3, 1))
    plain = Trainer(cfg, resume=True, device=device)
    assert not plain.spatial and plain.start_epoch == 2
    rec = plain.fit()
    assert rec["epoch"] == 2 and np.isfinite(rec["loss"])
    plain.close()
    del plain
    run_grid("cli", (1, 1, 2), str(tmp_path / "w2"),
             {"argv": _cli_argv(tmp_path, workdir, 4, 2)}, {})
    records = [json.loads(line) for line in (workdir / "metrics.jsonl").read_text().splitlines()
               if '"epoch"' in line and '"kind"' not in line]
    assert [r["epoch"] for r in records] == [0, 1, 2, 3]


def test_trainer_refuses_pipeline_stages_in_the_jax_words(tmp_path):
    from ddlpc_tpu.train import trainer as jtrainer
    import inspect

    cfg, _, device, _ = parse_args(["--config", _tiny_cli_config(tmp_path), "--device", "cpu",
                                    "--set", "parallel.pipeline_stages=2", *_OFF])
    with pytest.raises(ValueError) as e:
        Trainer(cfg, resume=False, device=device)
    src = inspect.getsource(jtrainer.Trainer._build_train_step)
    for piece in ("pipeline_stages > 1 is not wired into the epoch Trainer",
                  "parallel/pipeline.make_pipeline_train_step", "ROADMAP follow-on"):
        assert piece in src and piece in str(e.value)


# ---- the loaders --------------------------------------------------------------


def _shards_by_position(arr, mesh):
    """{(d, s): numpy} of a global array sharded (…, data, space)."""
    pos = {dev: (i, j) for (i, j), dev in np.ndenumerate(mesh.devices)}
    return {pos[sh.device]: np.asarray(sh.data) for sh in arr.addressable_shards}


@pytest.mark.parametrize("kind", ["sharded", "cache"])
def test_loader_rows_are_jax_shards_byte_for_byte(kind):
    tiles = jdatasets.SyntheticTiles(num_tiles=21, image_size=(8, 8), seed=9)
    tiles.labels[0, 0, 0] = -1
    mesh = make_mesh(JParallel(data_axis_size=2, space_axis_size=2), jax.devices()[:4])
    jcls, tcls = ((JShardedLoader, ShardedLoader) if kind == "sharded"
                  else (JDeviceCachedLoader, DeviceCachedLoader))
    jl = jcls(tiles, mesh, global_micro_batch=4, sync_period=2, seed=4, space_axis="space")
    for e in range(2):
        jl.set_epoch(e)
        jbatches = [(_shards_by_position(i, mesh), _shards_by_position(l, mesh)) for i, l in jl]
        for d in range(2):
            for s in range(2):
                tl = tcls(TileDataset(tiles.images, tiles.labels), micro_batch=2, sync_period=2,
                          device=torch.device("cpu"), seed=4, replica=d, world=2, space=(s, 2))
                tl.set_epoch(e)
                got = list(tl)
                assert len(got) == len(jbatches)
                for (gi, gl), (ji, jl_) in zip(got, jbatches):
                    assert gi.shape == (2, 2, 4, 8, 3)
                    assert gi.numpy().tobytes() == np.ascontiguousarray(ji[(d, s)]).tobytes()
                    np.testing.assert_array_equal(gl.numpy(), jl_[(d, s)])


def test_eval_batches_rows_are_jax_shards():
    tiles = jdatasets.SyntheticTiles(num_tiles=7, image_size=(8, 8), seed=2)
    mesh = make_mesh(JParallel(data_axis_size=2, space_axis_size=2), jax.devices()[:4])
    jb = [(_shards_by_position(i, mesh), _shards_by_position(l, mesh))
          for i, l in jeval_batches(tiles, mesh, 4, space_axis="space")]
    ds = TileDataset(tiles.images, tiles.labels)
    for d in range(2):
        for s in range(2):
            got = list(eval_batches(ds, 2, torch.device("cpu"), d, 2, (s, 2)))
            assert len(got) == len(jb)
            for (gi, gl), (ji, jl) in zip(got, jb):
                np.testing.assert_array_equal(gi.numpy(), ji[(d, s)])
                np.testing.assert_array_equal(gl.numpy(), jl[(d, s)])
