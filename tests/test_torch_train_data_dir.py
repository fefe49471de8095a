"""The port's trainer from a ``data_dir`` on the CPU, and the compact
wire through a train step.

- The CLI's trainer, two epochs, on a tile directory read lazily and on a
  scene directory in crop mode with mmap, augmentation, the compact wire
  and three loader workers: finite losses, the ``t_loader_*`` stages, the
  perf and comm records, the PNG dumps and checkpoints, and the confusion
  matrix of the eval split, computed by the port's eval step
  on the trained parameters, equal to JAX's model applied to the same
  parameters on JAX's eval split (fp32 compute; exact, as integers).
- A tiny bf16 U-Net (the zoo's compute dtype, a bf16 head and the detail
  head): a train step on the compact batch (bf16 images, int8 labels)
  equals the step on the fp32 batch bit for bit, losses and parameters,
  because the model's first operation casts its input to bf16.
- The port's compact step against JAX's compact step (bf16 images and
  int8 labels into ``make_train_step``), fp32 compute, two steps: the
  tolerances of ``tests/test_torch_train_step.py``, for the reasons stated
  there (losses rtol 1e-5; BatchNorm statistics and Adam's moments rtol
  1e-4, atol 1e-6, 1e-7 for ``nu``; params the same, but for at most 0.1 %
  of the elements within ``2·lr`` a step).
- The stall watchdog over a lazy read that hangs: exit 42, ``stall.log``
  naming the phase ``data`` (the read runs on a loader worker, so the
  training thread waits in the data fetch).
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from ddlpc_tpu.config import CompressionConfig as JCompression
from ddlpc_tpu.config import DataConfig as JDataConfig
from ddlpc_tpu.config import ModelConfig as JModelConfig
from ddlpc_tpu.data import datasets as jd
from ddlpc_tpu.models import build_model as jbuild_model
from ddlpc_tpu.ops import metrics as jmetrics
from ddlpc_tpu.parallel import train_step as jts
from ddlpc_tpu_torch.config import CompressionConfig, ModelConfig, TrainConfig
from ddlpc_tpu_torch.convert import flax_from_torch, torch_state_from_flax
from ddlpc_tpu_torch.data import datasets as td
from ddlpc_tpu_torch.data.loader import DeviceLoader, eval_batches
from ddlpc_tpu_torch.models import build_model
from ddlpc_tpu_torch.parallel.train_step import create_train_state, make_train_step
from ddlpc_tpu_torch.resilience.protocol import EXIT_STALL, read_breadcrumb
from ddlpc_tpu_torch.train.__main__ import parse_args
from ddlpc_tpu_torch.train.optim import build_optimizer
from ddlpc_tpu_torch.train.trainer import Trainer
from test_torch_datasets_dir import write_scenes, write_tiles
from test_torch_model import flax_like_variables
from test_torch_train_step import LR, TINY, _close, _flat, _params_agree
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = {"features": [8, 16], "bottleneck_features": 16, "stem": "s2d", "stem_factor": 2,
         "detail_head": True, "compute_dtype": "float32", "head_dtype": "float32"}
MODES = {
    "lazy": dict(data_dir="tiles", lazy_tiles=True, test_split=5),
    "crop_mmap_augment_compact_workers": dict(data_dir="scenes", crops_per_epoch=24, mmap_scenes=True,
                                              augment=True, compact_upload=True, loader_workers=3,
                                              test_split=4),
}


def _config(tmp_path, data: dict, **train) -> str:
    cfg = {
        "model": MODEL,
        "data": {"dataset": "synthetic", "image_size": [16, 16], "seed": 2, **data},
        "train": {"epochs": 2, "micro_batch_size": 4, "sync_period": 2, "checkpoint_every_epochs": 1,
                  "dump_images_per_epoch": 2, **train},
        "compression": {"mode": "float16"},
    }
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("mode", list(MODES))
def test_trainer_from_a_data_dir_and_its_eval_equal_jax(tmp_path, mode):
    dirs = {"tiles": write_tiles(tmp_path / "tiles", n=21, fmt="npy", seed=9),
            "scenes": write_scenes(tmp_path / "scenes", fmt="npy", seed=4)}
    data = dict(MODES[mode], data_dir=dirs[MODES[mode]["data_dir"]])
    cfg, resume, device, backend = parse_args(
        ["--config", _config(tmp_path, data), "--device", "cpu", "--no-resume",
         "--workdir", str(tmp_path / "run")])
    trainer = Trainer(cfg, resume=resume, device=device, dist_backend=backend)
    assert type(trainer.loader).__name__ == "ShardedLoader"
    assert trainer.loader.compact == bool(data.get("compact_upload"))
    last = trainer.fit()
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        lines = list(map(json.loads, f))
    records = [r for r in lines if "kind" not in r]
    # The stream stamps each record with its time and schema.
    unstamped = {k: v for k, v in records[-1].items() if k not in ("time", "schema")}
    assert [r["epoch"] for r in records] == [0, 1] and last == unstamped
    # The perf accounting, the PNG dumps of the eval split and the
    # checkpoints (each with its lineage record) ran on the data read from
    # disk.
    assert [r["kind"] for r in lines if "kind" in r] == ["lineage", "perf", "comm"] * 2
    assert len(os.listdir(tmp_path / "run" / "images" / "epoch_0001")) == 6
    assert len(os.listdir(tmp_path / "run" / "checkpoints")) > 0
    for r in records:
        assert np.isfinite(r["loss"]) and np.isfinite(r["val_loss"]) and np.isfinite(r["grad_norm"])
        assert r["t_loader_gather_s"] > 0 and r["t_loader_upload_s"] > 0
        assert ("t_loader_cast_s" in r) == bool(data.get("compact_upload"))
    # The port's eval of the trained parameters, and JAX's of the same.
    cm = torch.zeros(6, 6, dtype=torch.float64)
    for images, labels in eval_batches(trainer.test_ds, 4, trainer.device):
        cm += trainer.eval_step(trainer.state, images, labels)["confusion"].double()
    _, jtest = jd.build_dataset(JDataConfig(**{**cfg.data.__dict__, "image_size": (16, 16)}))
    np.testing.assert_array_equal(jtest.images, trainer.test_ds.images)
    np.testing.assert_array_equal(jtest.labels, trainer.test_ds.labels)
    params, stats, _ = flax_from_torch(trainer.state.model.state_dict())
    jmodel = jbuild_model(JModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                                          for k, v in MODEL.items()}))
    logits = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(jtest.images),
                          train=False)
    jcm = jmetrics.confusion_from_logits(logits, jnp.asarray(jtest.labels), 6)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm, np.float64))
    assert cm.sum() == (jtest.labels >= 0).sum() > 0


def _bf16_model(seed: int = 0):
    torch.manual_seed(seed)
    return build_model(ModelConfig(features=(8, 16), bottleneck_features=16, stem="s2d", stem_factor=2,
                                   detail_head=True, compute_dtype="bfloat16", head_dtype="bfloat16"))


def test_compact_step_equals_fp32_step_bit_for_bit(tmp_path):
    tiles = td.load_tile_dir(write_tiles(tmp_path / "t", n=16, fmt="npy", seed=1))
    runs = {}
    for compact in (False, True):
        model = _bf16_model()
        tx = build_optimizer(TrainConfig(learning_rate=LR))
        state = create_train_state(model, tx)
        step = make_train_step(tx, CompressionConfig(mode="none"))
        loader = DeviceLoader(tiles, micro_batch=4, sync_period=2, device=torch.device("cpu"),
                              seed=3, compact=compact)
        losses = []
        for images, labels in loader:
            assert images.dtype == (torch.bfloat16 if compact else torch.float32)
            losses.append(step(state, images, labels)["loss"].item())
        runs[compact] = (losses, {k: v.clone() for k, v in model.state_dict().items()})
    assert len(runs[True][0]) == 2 and runs[True][0] == runs[False][0]
    for k, v in runs[False][1].items():
        assert torch.equal(runs[True][1][k], v), k


def test_compact_step_matches_jax_compact_step():
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (2, 2, 4, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(-1, 6, (2, 2, 4, 32, 32)).astype(np.int32)
    bf16 = images.astype(ml_dtypes.bfloat16)
    jmodel = jbuild_model(JModelConfig(**TINY))
    tx = optax.adam(LR)
    variables = flax_like_variables(jmodel)
    params0, stats0 = variables["params"], variables["batch_stats"]
    jstate = jts.TrainState(
        step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.asarray, params0),
        batch_stats=jax.tree.map(jnp.asarray, stats0), opt_state=tx.init(jax.tree.map(jnp.asarray, params0)))
    jstep = jts.make_train_step(jmodel, tx, Mesh(np.array(jax.devices()[:1]), ("data",)),
                                JCompression(mode="none"), donate_state=False)
    jlosses = []
    for x, y in zip(bf16, labels):
        jstate, m = jstep(jstate, jnp.asarray(x), jnp.asarray(y.astype(np.int8)))
        jlosses.append(float(m["loss"]))
    adam = jstate.opt_state[0]
    jout = {"params": _flat(jstate.params), "batch_stats": _flat(jstate.batch_stats),
            "mu": _flat(adam.mu), "nu": _flat(adam.nu)}

    tmodel = build_model(ModelConfig(**TINY))
    sd, _ = torch_state_from_flax(params0, stats0)
    tmodel.load_state_dict(sd, strict=True)
    ttx = build_optimizer(TrainConfig(learning_rate=LR))
    state = create_train_state(tmodel, ttx)
    tstep = make_train_step(ttx, CompressionConfig(mode="none"))
    tlosses = []
    for x, y in zip(bf16, labels):
        t = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
        tlosses.append(float(tstep(state, t, torch.from_numpy(y.astype(np.int8)).long())["loss"]))
    p, s, o = flax_from_torch(tmodel.state_dict(), {
        "count": state.opt_state.count, "mu": state.params.named_views(state.opt_state.mu),
        "nu": state.params.named_views(state.opt_state.nu)})
    tout = {"params": _flat(p), "batch_stats": _flat(s), "mu": _flat(o["mu"]), "nu": _flat(o["nu"])}
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    _params_agree(jout, tout, max_share=1e-3)
    _close(jout["batch_stats"], tout["batch_stats"], 1e-4, 1e-6)
    _close(jout["mu"], tout["mu"], 1e-4, 1e-6)
    _close(jout["nu"], tout["nu"], 1e-4, 1e-7)


_HANGING_READ = textwrap.dedent("""
    import sys, threading, time
    from ddlpc_tpu_torch.data import datasets
    from ddlpc_tpu_torch.train.__main__ import parse_args
    from ddlpc_tpu_torch.train.trainer import Trainer

    read = datasets._read_tile
    calls = [0]
    lock = threading.Lock()

    def hanging(*args, **kwargs):
        with lock:
            calls[0] += 1
            n = calls[0]
        if n == 30:  # a tile of the first epoch's later batches
            time.sleep(8.0)
        return read(*args, **kwargs)

    datasets._read_tile = hanging
    cfg, _, device, _ = parse_args(sys.argv[1:])
    Trainer(cfg, resume=False, device=device).fit()
    print("FIT RETURNED", flush=True)
""")


def test_stalled_lazy_read_exits_42_naming_the_data_phase(tmp_path):
    tiles = write_tiles(tmp_path / "tiles", n=40, fmt="npy", seed=2)
    config = _config(tmp_path, dict(data_dir=tiles, lazy_tiles=True, test_split=4),
                     stall_timeout_s=1.5, stall_action="abort", epochs=1, checkpoint_every_epochs=0,
                     dump_images_per_epoch=0)
    workdir = str(tmp_path / "run")
    r = subprocess.run(
        [sys.executable, "-c", _HANGING_READ, "--config", config, "--device", "cpu",
         "--workdir", workdir],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == EXIT_STALL, (r.stdout, r.stderr)
    assert "FIT RETURNED" not in r.stdout
    crumb = read_breadcrumb(workdir)
    assert crumb["phase"] == "stalled" and crumb["stall_tag"] == "data"
    with open(os.path.join(workdir, "stall.log")) as f:
        assert "last phase: 'data'" in f.read()
