"""One rank of a gloo world for the port's data-parallel tests (it holds
no test of its own: ``tests/test_torch_dist_sync.py`` and
``tests/test_torch_dist_train.py`` start it through :func:`run_world`).

Run as ``python tests/test_torch_dist_worker.py <task> <dir>`` with ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK`` set (``mesh.spawn_world`` sets them):
the rank joins the world through ``file://<dir>/rendezvous``, reads
``<dir>/task.json`` and ``<dir>/in.npz``, and writes
``<dir>/out_<rank>.npz``.  It imports only the port (and numpy), never JAX.

Tasks:

- ``sync``: each case of ``task.json`` syncs this rank's gradient
  ``g<rank>`` (zero-padded to the flat layout) with ``sync_gradients``
  (``shard_update='off'``) or ``sync_gradients_scatter`` (``zero2``, the
  chunks then all-gathered), optionally with given noise fields, and
  stores the synced buffer's first n elements;
- ``step``: the tiny U-Net from the canonical weights in ``in.npz``
  trains ``steps`` optimizer steps on this rank's columns of the global
  batches, recording the flat gradient before each sync, the metrics,
  and at the end the params, the BatchNorm statistics and the gathered
  Adam moments;
- ``cli``: the CLI's ``main`` with the arguments in ``task.json``;
- ``ckpt``: a Trainer from the CLI's arguments trains and checkpoints,
  then a fresh Trainer on the same workdir resumes; stores the canonical
  state each held (``saved/...``, ``restored/...``) and where the second
  one starts.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from ddlpc_tpu_torch.config import CompressionConfig, ModelConfig, TrainConfig
from ddlpc_tpu_torch.convert import gather_canonical, load_canonical
from ddlpc_tpu_torch.models import build_model
from ddlpc_tpu_torch.parallel import grad_sync, mesh
from ddlpc_tpu_torch.parallel import train_step as ts
from ddlpc_tpu_torch.parallel.shard_update import flat_chunk_rows
from ddlpc_tpu_torch.train.optim import build_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sync(task: dict, inputs, rank: int, world: int) -> dict:
    out = {}
    for i, case in enumerate(task["cases"]):
        cfg = CompressionConfig(**case["cfg"])
        g = inputs[f"{case['tree']}/g{rank}"]
        n = g.size
        k = flat_chunk_rows(n, world)

        def padded(a: np.ndarray) -> torch.Tensor:
            t = torch.zeros(world * k, dtype=torch.float32)
            t[:n] = torch.from_numpy(a)
            return t

        flat = padded(g)
        noise = None
        if case["noise"]:
            noise = (padded(inputs[f"{case['tree']}/local{rank}"]), padded(inputs[f"{case['tree']}/mean"]))
        if case["scatter"]:
            shard = grad_sync.sync_gradients_scatter(flat, cfg, world, noise=noise)
            out[f"{i}/shard"] = shard.numpy().copy()
            mesh.all_gather_(flat)
        else:
            grad_sync.sync_gradients(flat, cfg, axis_size=world, noise=noise)
        out[f"{i}/mean"] = flat[:n].numpy().copy()
        out[f"{i}/tail"] = flat[n:].numpy().copy()
    return out


def _step(task: dict, inputs, rank: int, world: int) -> dict:
    model = build_model(ModelConfig(**task["model"]), norm_axis_size=world)
    tx = build_optimizer(TrainConfig(learning_rate=task["lr"]))
    state = ts.create_train_state(model, tx, world, task["level"])
    load_canonical(state, {k[3:]: torch.from_numpy(inputs[k]) for k in inputs.files if k.startswith("sd/")})
    compression = CompressionConfig(**task["compression"])
    pre_sync = []
    real_scatter, real_sync = ts.sync_gradients_scatter, ts.sync_gradients

    def record(real):
        def wrapped(flat, *a, **kw):
            pre_sync.append(flat[: state.params.numel].clone().numpy())
            return real(flat, *a, **kw)
        return wrapped

    ts.sync_gradients_scatter, ts.sync_gradients = record(real_scatter), record(real_sync)
    step = ts.make_train_step(tx, compression, world, level=task["level"])
    bl = task["local_batch"]
    out = {}
    for s, (x, y) in enumerate(zip(inputs["images"], inputs["labels"])):
        cols = slice(rank * bl, (rank + 1) * bl)
        m = step(state, torch.from_numpy(x[:, cols].copy()), torch.from_numpy(y[:, cols].astype(np.int64)))
        for key, v in m.items():
            out[f"{key}{s}"] = np.float32(v)
        out[f"grad{s}"] = pre_sync[-1]
    sd, adam = gather_canonical(state)
    for name, v in sd.items():
        out[f"sd/{name}"] = v.numpy()
    for key in ("mu", "nu"):
        for name, v in adam[key].items():
            out[f"{key}/{name}"] = v.numpy()
    out["flat"] = state.params.data.numpy().copy()
    return out


def _cli(task: dict, inputs, rank: int, world: int) -> dict:
    from ddlpc_tpu_torch.train.__main__ import main

    assert main(task["argv"]) == 0
    return {}


def _canonical(trainer, prefix: str) -> dict:
    sd, adam = gather_canonical(trainer.state)
    out = {f"{prefix}/sd/{k}": v.numpy().copy() for k, v in sd.items()}
    for key in ("mu", "nu"):
        out.update({f"{prefix}/{key}/{k}": v.numpy().copy() for k, v in adam[key].items()})
    out[f"{prefix}/count"] = np.array(adam["count"])
    out[f"{prefix}/step"] = np.array(trainer.state.step)
    return out


def _ckpt(task: dict, inputs, rank: int, world: int) -> dict:
    from ddlpc_tpu_torch.train.__main__ import parse_args
    from ddlpc_tpu_torch.train.trainer import Trainer

    cfg, _, device, backend = parse_args(task["argv"])
    first = Trainer(cfg, resume=False, device=device, dist_backend=backend)
    first.fit()
    out = _canonical(first, "saved")
    out["level"] = np.array(first.shard_update)
    del first
    again = Trainer(cfg, resume=True, device=device, dist_backend=backend)
    out.update(_canonical(again, "restored"))
    out["start_epoch"] = np.array(again.start_epoch)
    return out


def run_world(name: str, world: int, work: str, task: dict, inputs: dict,
              deadline_s: float = 120.0) -> list:
    """Parent side: write the task, run ``world`` ranks of ``name`` under
    a deadline that kills the world, return each rank's outputs."""
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(work, "task.json"), "w") as f:
        json.dump(task, f)
    if inputs:
        np.savez(os.path.join(work, "in.npz"), **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    mesh.spawn_world([sys.executable, os.path.abspath(__file__), name, work], world,
                     deadline_s, env=env, cwd=REPO)
    return [dict(np.load(os.path.join(work, f"out_{r}.npz"))) for r in range(world)]


def main() -> int:
    name, work = sys.argv[1], sys.argv[2]
    rank, world, _ = mesh.world_from_env()
    torch.manual_seed(0)
    mesh.initialize_distributed("gloo", f"file://{os.path.join(work, 'rendezvous')}")
    with open(os.path.join(work, "task.json")) as f:
        task = json.load(f)
    path = os.path.join(work, "in.npz")
    inputs = np.load(path) if os.path.exists(path) else None
    try:
        out = {"sync": _sync, "step": _step, "cli": _cli, "ckpt": _ckpt}[name](task, inputs, rank, world)
    finally:
        mesh.destroy_distributed()
    np.savez(os.path.join(work, f"out_{rank}.npz"), **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
