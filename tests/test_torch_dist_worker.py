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
  ``g<rank>`` (laid out flat: one leaf, or the leaves of ``sizes`` in the
  regions of the case's ``bucket_mb``, zero-padded) with
  ``sync_gradients`` (``shard_update='off'``, or the ring) or
  ``sync_gradients_scatter`` (the chunks then all-gathered), optionally
  with given noise fields or, once each, with the stochastic keys of
  ``keys``, and stores the synced leaves and, apart, the padding;
- ``step``: the tiny U-Net from the canonical weights in ``in.npz``
  trains one optimizer step a batch of ``images`` (the first ``steps``)
  on this rank's columns,
  at the task's ZeRO level, codec, optimizer settings (``train``) and
  ``remat``, recording the flat gradient before each sync, the metrics,
  and at the end the params, the BatchNorm statistics and the gathered
  optimizer moments;
- ``cli``: the CLI's ``main`` with the arguments in ``task.json``; the
  ranks of ``probe_fails_on`` cannot make the comm probe's gradient;
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
from ddlpc_tpu_torch.parallel.shard_update import flat_layout
from ddlpc_tpu_torch.train.optim import build_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sync(task: dict, inputs, rank: int, world: int) -> dict:
    out = {}
    for i, case in enumerate(task["cases"]):
        cfg = CompressionConfig(**case["cfg"])
        g = inputs[f"{case['tree']}/g{rank}"]
        n = g.size
        sizes = case.get("sizes", [n])
        offsets, regions, total = flat_layout(sizes, world, cfg.bucket_mb)
        covered = torch.zeros(total, dtype=torch.bool)
        for o, size in zip(offsets, sizes):
            covered[o : o + size] = True

        def padded(a: np.ndarray) -> torch.Tensor:
            t = torch.zeros(total, dtype=torch.float32)
            t[covered] = torch.from_numpy(a)
            return t

        buckets = [(start, world * rows) for start, _, rows in regions]
        for d, step in enumerate(case.get("keys", [None])):
            flat = padded(g)
            noise = None
            if case["noise"]:
                noise = (padded(inputs[f"{case['tree']}/local{rank}"]),
                         padded(inputs[f"{case['tree']}/mean"]))
            tag = f"{i}" if step is None else f"{i}/{d}"
            if case["scatter"]:
                shards = grad_sync.sync_gradients_scatter(flat, cfg, world, noise=noise,
                                                          buckets=buckets)
                out[f"{tag}/shard"] = torch.cat(shards).numpy().copy()
                for start, size in buckets:
                    mesh.all_gather_(flat[start : start + size])
            else:
                grad_sync.sync_gradients(flat, cfg, axis_size=world, noise=noise, key=step,
                                         buckets=buckets, n_elements=n)
            out[f"{tag}/mean"] = flat[covered].numpy().copy()
            out[f"{tag}/tail"] = flat[~covered].numpy().copy()
    return out


def _step(task: dict, inputs, rank: int, world: int) -> dict:
    """One run, or each of ``task["runs"]`` (overrides of the task) in turn,
    its outputs under ``"<i>:"``."""
    if "runs" not in task:
        return _step_run(task, inputs, rank, world)
    out = {}
    for i, run in enumerate(task["runs"]):
        got = _step_run({**task, **run}, inputs, rank, world)
        out.update({f"{i}:{k}": v for k, v in got.items()})
    return out


def _step_run(task: dict, inputs, rank: int, world: int) -> dict:
    model = build_model(ModelConfig(**task["model"]), norm_axis_size=world)
    tx = build_optimizer(TrainConfig(learning_rate=task["lr"], **task.get("train", {})),
                         total_steps=len(inputs["images"]))
    compression = CompressionConfig(**task["compression"])
    state = ts.create_train_state(model, tx, world, task["level"], bucket_mb=compression.bucket_mb)
    load_canonical(state, {k[3:]: torch.from_numpy(inputs[k]) for k in inputs.files if k.startswith("sd/")})
    pre_sync = []
    real_sync = ts.sync_for_level

    def recorded(flat, *a, **kw):
        pre_sync.append(torch.cat([v.reshape(-1) for v in state.params.views(flat)]).numpy())
        return real_sync(flat, *a, **kw)

    ts.sync_for_level = recorded
    try:
        step = ts.make_train_step(tx, compression, world, level=task["level"],
                                  remat=task.get("remat", False))
        bl = task["local_batch"]
        out = {}
        batches = list(zip(inputs["images"], inputs["labels"]))[: task.get("steps")]
        for s, (x, y) in enumerate(batches):
            cols = slice(rank * bl, (rank + 1) * bl)
            m = step(state, torch.from_numpy(x[:, cols].copy()), torch.from_numpy(y[:, cols].astype(np.int64)))
            for key, v in m.items():
                out[f"{key}{s}"] = np.float32(v)
            out[f"grad{s}"] = pre_sync[-1]
    finally:
        ts.sync_for_level = real_sync
    out["resident"] = np.array(state.params.resident)
    sd, opt = gather_canonical(state)
    for name, v in sd.items():
        out[f"sd/{name}"] = v.numpy()
    for key in state.opt_state.buffers():
        for name, v in opt[key].items():
            out[f"{key}/{name}"] = v.numpy()
    out["count"] = np.array(opt["count"])
    out["flat"] = state.params.data.numpy().copy()
    return out


def _cli(task: dict, inputs, rank: int, world: int) -> dict:
    from ddlpc_tpu_torch.train.__main__ import main

    if rank in task.get("probe_fails_on", ()):
        # This replica alone cannot make the comm probe's gradient.
        from ddlpc_tpu_torch.obs import comm

        def refuse(*a, **kw):
            raise RuntimeError("out of memory (made to fail on this replica)")

        comm._dummy_gradient = refuse
    assert main(task["argv"]) == 0
    return {}


def _canonical(trainer, prefix: str) -> dict:
    sd, opt = gather_canonical(trainer.state)
    out = {f"{prefix}/sd/{k}": v.numpy().copy() for k, v in sd.items()}
    for key in trainer.state.opt_state.buffers():
        out.update({f"{prefix}/{key}/{k}": v.numpy().copy() for k, v in opt[key].items()})
    out[f"{prefix}/count"] = np.array(opt["count"])
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
