"""One rank of a gloo world laid out as a ``pipe × data × space`` grid, for
the port's space-axis and pipeline tests (it holds no test of its own:
``tests/test_torch_halo.py``, ``tests/test_torch_spatial.py`` and
``tests/test_torch_pipeline.py`` start it through :func:`run_grid`, or
:func:`start_grid` to compute their references while the world runs).

Run as ``python tests/test_torch_grid_worker.py <task> <dir>`` with ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK`` set (``mesh.spawn_world`` sets them): the
rank joins the world through ``file://<dir>/rendezvous``, lays it out as
``task["grid"]`` (``[pipe, data, space]``), reads ``<dir>/task.json`` and
``<dir>/in.npz``, and writes ``<dir>/out_<rank>.npz``.  It imports only
the port (and numpy), never JAX.

Tasks:

- ``halo``: this rank's rows of ``x`` (NHWC) through ``halo_exchange``;
  with ``conv``, ``sharded_same_conv`` of them and its gradients against
  the cotangent ``w``; with ``carry``, stage 0 exchanges, sends its rows
  to stage 1, which exchanges again;
- ``halo`` with ``upsample``: ``layers.upsample_2x`` (or, with ``factor``,
  ``layers.upsample`` at that factor) of this rank's rows of ``x`` in
  ``dtype`` (its clamped halo) and its gradient against the cotangent
  ``w``;
- ``halo`` with ``rows = [top, bottom]``: ``halo_exchange(..., edge,
  multi_hop=True)`` of this rank's rows of ``x`` and its gradient against
  this rank's block of the cotangent ``w``;
- ``halo`` with ``pool``: ``layers.max_pool_same`` (3×3/2) of this rank's
  rows of ``x`` and its gradient against the cotangent ``w``;
- ``halo`` with ``layout`` (the boundaries of ``x``'s rows over the space
  group, uneven): with ``dst``, ``halo.reshard`` of this rank's rows to
  that layout; with ``rows = [top, bottom]``, ``halo_exchange(...,
  layout=)``; with ``up``, ``layers.upsample`` by that factor in
  ``dtype`` given the global rows; with ``norm`` (``batch``, ``group`` or
  ``aspp``, NCHW float64), ``layers.batch_norm`` over the space group,
  ``group_norm`` or a sharded ``ASPP`` given the global rows; each with
  its gradient against this rank's block of ``w`` (the blocks in rank
  order) and, for the norms, the parameters' gradients summed over the
  group;
- ``spatial``: the model of ``task["model"]`` from the canonical weights
  in ``in.npz`` trains ``images`` with the spatial step on this rank's
  columns and rows, at each of ``runs``' ZeRO levels, recording the
  metrics and at the end the canonical state; a run with a ``model`` of
  its own takes that model and its ``in.npz`` arrays under its ``prefix``;
  with ``every_step``, the canonical state after each earlier step too
  (``<run>:after<t>:``); ``cases``, if the task has them, run first as
  the ``halo`` task's;
- ``cli``: the CLI's ``main`` with the arguments in ``task.json``;
- ``trainer``: a ``Trainer`` of the CLI's arguments in ``task.json``
  fits, and records its canonical state, epochs and spatial layout;
- ``pipeline``: ``PipelineTrainStep`` from the canonical weights, each of
  ``runs`` (its level, and its ``compression`` if it has one, else the
  task's) ``steps`` steps of ``images``; records the metrics,
  ``last_schedule``, the canonical state; with ``roundtrip``, the
  canonical snapshot's checkpoint written, restored into a fresh driver,
  and one more step of each.  Where ``in.npz`` holds fields
  ``noise<stage>/<k0>_<k1>/<param>``, a stage's stochastic rounding
  draws them for the Philox key ``(k0, k1)`` instead of its own stream
  (the JAX package's noise, laid out in the stage's flat order).
"""

from __future__ import annotations

import json
import os
import sys
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from ddlpc_tpu_torch.config import CompressionConfig, ModelConfig, TrainConfig
from ddlpc_tpu_torch.convert import gather_canonical, load_canonical
from ddlpc_tpu_torch.models import build_model, shard_space
from ddlpc_tpu_torch.parallel import mesh
from ddlpc_tpu_torch.parallel import train_step as ts
from ddlpc_tpu_torch.train.optim import build_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rows(a: np.ndarray, axis: int) -> np.ndarray:
    s, n = mesh.space_index(), mesh.space_size()
    h = a.shape[axis] // n
    return np.take(a, np.arange(s * h, (s + 1) * h), axis=axis)


def _halo(task: dict, inputs, rank: int) -> dict:
    """Each case of ``task["cases"]``, its outputs under ``"<name>/"``."""
    out = {}
    for case in task["cases"]:
        got = _halo_case(case, {k[len(case["name"]) + 1:]: inputs[k] for k in inputs.files
                                if k.startswith(case["name"] + "/")})
        out.update({f"{case['name']}/{k}": v for k, v in got.items()})
    return out


def _halo_case(case: dict, inputs: dict) -> dict:
    from ddlpc_tpu_torch.parallel.halo import halo_exchange, sharded_same_conv

    if "layout" in case:
        return _layout_case(case, inputs)
    x = torch.from_numpy(_rows(inputs["x"], 1).copy())
    out = {"x": x.numpy().copy()}
    if case.get("upsample") or case.get("pool"):
        from ddlpc_tpu_torch.models.layers import max_pool_same, upsample, upsample_2x

        xl = x.permute(0, 3, 1, 2).to(getattr(torch, case["dtype"])).requires_grad_(True)
        if case.get("pool"):
            y = max_pool_same(xl, 3, 2, mesh.space_size())
        elif "factor" in case:
            y = upsample(xl, case["factor"], mesh.space_size())
        else:
            y = upsample_2x(xl, mesh.space_size())
        w = torch.from_numpy(_rows(inputs["w"], 1).copy()).permute(0, 3, 1, 2).to(y.dtype)
        y.backward(w)
        out["y"] = y.detach().permute(0, 2, 3, 1).float().numpy()
        out["gx"] = xl.grad.permute(0, 2, 3, 1).float().numpy()
        return out
    if "rows" in case:
        xl = x.clone().requires_grad_(True)
        y = halo_exchange(xl, tuple(case["rows"]), spatial_axis=1, edge=case["edge"],
                          multi_hop=True)
        y.backward(torch.from_numpy(_rows(inputs["w"], 1).copy()))
        out["y"] = y.detach().numpy()
        out["gx"] = xl.grad.numpy()
        return out
    if case.get("dtype"):
        y = halo_exchange(x.to(getattr(torch, case["dtype"])), case["halo"], spatial_axis=1)
        out["y"] = y.float().numpy()
        return out
    if case.get("carry"):
        g = mesh.grid()
        p, d, s = g.coords
        if p == 0:
            out["y"] = halo_exchange(x, 1, spatial_axis=1).numpy()
            mesh.exchange([(x, g.global_rank(1, d, s))], [])
        else:
            got = torch.empty_like(x)
            mesh.exchange([], [(got, g.global_rank(0, d, s))])
            out["y"] = halo_exchange(got, 1, spatial_axis=1).numpy()
        return out
    out["y"] = halo_exchange(x, case["halo"], spatial_axis=1).numpy()
    if case.get("conv"):
        k = torch.from_numpy(inputs["k"]).permute(3, 2, 0, 1).contiguous().requires_grad_(True)
        xl = x.permute(0, 3, 1, 2).contiguous().requires_grad_(True)
        y = sharded_same_conv(xl, k)
        w = torch.from_numpy(_rows(inputs["w"], 1).copy()).permute(0, 3, 1, 2)
        (y * w).sum().backward()
        gk = mesh.all_reduce_(k.grad.clone(), "sum", "space")
        out["conv"] = y.permute(0, 2, 3, 1).detach().numpy()
        out["gx"] = xl.grad.permute(0, 2, 3, 1).numpy()
        out["gk"] = gk.permute(2, 3, 1, 0).numpy()
    return out


def _layout_case(case: dict, inputs: dict) -> dict:
    from ddlpc_tpu_torch.models import layers
    from ddlpc_tpu_torch.models.deeplabv3p import ASPP
    from ddlpc_tpu_torch.models.layers import space_halo
    from ddlpc_tpu_torch.parallel.halo import halo_exchange, reshard, row_layout

    lay, s, space = tuple(case["layout"]), mesh.space_index(), mesh.space_size()
    axis = 2 if "norm" in case else 1
    x = torch.from_numpy(np.take(inputs["x"], np.arange(lay[s], lay[s + 1]), axis=axis).copy())
    leaf = x.requires_grad_(True)
    params, out_lay = [], lay
    if "dst" in case:
        out_lay = tuple(case["dst"])
        y = reshard(x, lay, out_lay, axis=1)
    elif "rows" in case:
        top, bottom = case["rows"]
        y = halo_exchange(x, (top, bottom), spatial_axis=1, edge=case["edge"], multi_hop=True,
                          layout=lay)
        out_lay = None
        sizes = [b - a + top + bottom if b > a else 0 for a, b in zip(lay, lay[1:])]
    elif "up" in case:
        leaf = x.detach().permute(0, 3, 1, 2).to(getattr(torch, case["dtype"]))
        leaf.requires_grad_(True)
        y = layers.upsample(leaf, case["up"], space, rows=lay[-1]).permute(0, 2, 3, 1)
        out_lay = row_layout(case["up"] * lay[-1], space)
    elif case["norm"] == "aspp":
        mod = ASPP(x.shape[1], 4, tuple(case["rates"]), torch.float64, norm_groups=2,
                   generator=torch.Generator().manual_seed(3))
        for m in mod.modules():
            if isinstance(m, layers.Conv) and m.kernel > 1:
                m.halo = space_halo(m.kernel, m.stride, m.dilation)
            elif isinstance(m, layers.BatchNorm):
                m.axis_size, m.axis = space, "stage"
        mod.space = space
        y = mod(x, rows=lay[-1])
        params = list(mod.parameters())
    else:
        c = x.shape[1]
        w_ = torch.linspace(0.5, 1.5, c, dtype=torch.float64).requires_grad_(True)
        b_ = torch.linspace(-0.2, 0.3, c, dtype=torch.float64).requires_grad_(True)
        params = [w_, b_]
        if case["norm"] == "batch":
            rm, rv = torch.zeros(c, dtype=torch.float64), torch.ones(c, dtype=torch.float64)
            y = layers.batch_norm(x, w_, b_, rm, rv, True, space, "stage", rows=lay[-1])
        else:
            y = layers.group_norm(x, case["groups"], w_, b_, space, rows=lay[-1])
    if out_lay is not None:
        sizes = [b - a for a, b in zip(out_lay, out_lay[1:])]
    start = sum(sizes[:s])
    w = torch.from_numpy(np.take(inputs["w"], np.arange(start, start + sizes[s]),
                                 axis=axis).copy())
    y.backward(w.to(y.dtype))
    out = {"y": y.detach().float().numpy() if "up" in case else y.detach().numpy()}
    gx = leaf.grad.permute(0, 2, 3, 1).float() if "up" in case else leaf.grad
    out["gx"] = gx.numpy()
    for i, p in enumerate(params):
        out[f"gp{i}"] = mesh.all_reduce_(p.grad.clone(), "sum", "space").numpy()
    if case.get("norm") == "batch":
        out.update(mean=rm.numpy(), var=rv.numpy())
    return out


def _canonical(state, prefix: str) -> dict:
    sd, opt = gather_canonical(state)
    out = {f"{prefix}sd/{k}": v.numpy().copy() for k, v in sd.items()}
    for key in state.opt_state.buffers():
        out.update({f"{prefix}{key}/{k}": v.numpy().copy() for k, v in opt[key].items()})
    out[f"{prefix}count"] = np.array(opt["count"])
    return out


def _weights(inputs, prefix: str = "") -> dict:
    sd = f"{prefix}sd/"
    return {k[len(sd):]: torch.from_numpy(inputs[k]) for k in inputs.files if k.startswith(sd)}


def _spatial(task: dict, inputs, rank: int) -> dict:
    g = mesh.grid()
    _, d, _ = g.coords
    out = _halo(task, inputs, rank) if task.get("cases") else {}
    for i, run in enumerate(task["runs"]):
        level, prefix = run["level"], run.get("prefix", "")
        images, labels = inputs[f"{prefix}images"], inputs[f"{prefix}labels"]
        model = build_model(ModelConfig(**run.get("model", task.get("model"))))
        shard_space(model, g.data, g.space)
        tx = build_optimizer(TrainConfig(learning_rate=task["lr"]), total_steps=len(images))
        comp = CompressionConfig(**task["compression"])
        state = ts.create_train_state(model, tx, g.data, level)
        load_canonical(state, _weights(inputs, prefix))
        step = ts.make_train_step_spatial(tx, comp, g.data, g.space, level=level)
        b = images.shape[2] // g.data
        for t, (x, y) in enumerate(zip(images, labels)):
            xs = _rows(x[:, d * b : (d + 1) * b], 2)
            ys = _rows(y[:, d * b : (d + 1) * b], 2)
            m = step(state, torch.from_numpy(xs.copy()), torch.from_numpy(ys.astype(np.int64)))
            for key, v in m.items():
                out[f"{i}:{key}{t}"] = np.float32(v)
            if task.get("every_step") and t + 1 < len(images):
                out.update(_canonical(state, f"{i}:after{t}:"))
        out.update(_canonical(state, f"{i}:"))
        out[f"{i}:flat"] = state.params.data.to("cpu", copy=True).numpy() if state.params.resident \
            else np.zeros(0, np.float32)
    return out


def _cli(task: dict, inputs, rank: int) -> dict:
    from ddlpc_tpu_torch.train.__main__ import main

    assert main(task["argv"]) == 0
    return {}


def _trainer(task: dict, inputs, rank: int) -> dict:
    from ddlpc_tpu_torch.train.__main__ import parse_args
    from ddlpc_tpu_torch.train.trainer import Trainer

    cfg, resume, device, backend = parse_args(task["argv"])
    trainer = Trainer(cfg, resume=resume, device=device, dist_backend=backend)
    try:
        record = trainer.fit()
        out = _canonical(trainer.state, "")
        out.update(epoch=np.int64(record["epoch"]), spatial=np.bool_(trainer.spatial),
                   space=np.array(trainer.space))
    finally:
        trainer.close()
    return out


def _pipeline(task: dict, inputs, rank: int) -> dict:
    from ddlpc_tpu_torch.models.unet import UNet
    from ddlpc_tpu_torch.parallel.pipeline import make_pipeline_train_step
    from ddlpc_tpu_torch.train import checkpoint as ckpt
    from ddlpc_tpu_torch.convert import load_state_tree

    from ddlpc_tpu_torch.ops import philox

    out = {}
    comp = CompressionConfig(**task.get("compression", {}))
    images, labels = inputs["images"], inputs["labels"]

    def fresh():
        model = UNet(**task["model"], dtype=torch.float32)
        tx = build_optimizer(TrainConfig(learning_rate=task["lr"]))
        full = ts.create_train_state(model, tx, 1, "off")
        load_canonical(full, _weights(inputs))
        return model, tx, full

    own_uniform = philox.uniform
    for i, run in enumerate(task["runs"]):
        model, tx, full = fresh()
        rcomp = CompressionConfig(**run["compression"]) if "compression" in run else comp
        drv = make_pipeline_train_step(model, tx, rcomp, task["m"], shard_update=run["level"])
        if drv.n_stages == 1:
            full = ts.create_train_state(model, tx, mesh.data_size(), drv._level)
            load_canonical(full, _weights(inputs))
        p = drv.init_state(full)
        fields = _stage_noise(inputs, drv.stage, p.stages[0].params)
        asked = set()
        if fields and rcomp.rounding == "stochastic":
            def given(key, offset, n, device=None):
                asked.add(key)
                return fields[key][offset : offset + n]

            philox.uniform = given
        try:
            for t in range(task["steps"]):
                p, m = drv.step(p, images, labels)
                for key, v in m.items():
                    out[f"{i}:{key}{t}"] = np.float64(v)
        finally:
            philox.uniform = own_uniform
        out[f"{i}:noise_keys"] = np.int64(len(asked))
        out.update({f"{i}:sched/{k}": np.float64(v) for k, v in drv.last_schedule.items()})
        out[f"{i}:stash"] = np.int64(drv.stash_bytes)
        out.update(_canonical(drv.canonical(p), f"{i}:"))
    if task.get("roundtrip"):
        model, tx, full = fresh()
        drv = make_pipeline_train_step(model, tx, comp, task["m"], shard_update="zero2")
        out.update(_canonical(drv.canonical(drv.init_state(full)), "rt0:"))
        p = drv.init_state(full)
        p, _ = drv.step(p, images, labels)
        snap = drv.canonical(p)
        ckdir = os.path.join(task["dir"], "ckpt")
        ckpt.save_checkpoint(ckdir, snap, metadata={"epoch": 0})
        torch.distributed.barrier()
        p, _ = drv.step(p, images, labels)
        out.update(_canonical(drv.canonical(p), "rt_cont:"))
        model2, tx2, full2 = fresh()
        tree = ckpt.restore_checkpoint(ckdir)[0] if mesh.world_rank() == 0 else None
        load_state_tree(full2, tree)
        drv2 = make_pipeline_train_step(model2, tx2, comp, task["m"], shard_update="zero2")
        p2, _ = drv2.step(drv2.init_state(full2), images, labels)
        out.update(_canonical(drv2.canonical(p2), "rt_res:"))
    return out


def _stage_noise(inputs, stage: int, flat) -> dict:
    """``{(k0, k1): field}`` of ``in.npz``'s ``noise<stage>/<k0>_<k1>/<param>``
    arrays: each key's fields of this stage's params laid out as ``flat``
    lays out the params, zero in its padding."""
    prefix = f"noise{stage}/"
    keys = sorted({k[len(prefix):].split("/")[0] for k in inputs.files if k.startswith(prefix)})
    out = {}
    for key in keys:
        field = np.zeros(flat.data.numel(), np.float32)
        for name, (o, n) in zip(flat.names, flat.segments()):
            field[o : o + n] = inputs[f"{prefix}{key}/{name}"].reshape(-1)
        out[tuple(int(k) for k in key.split("_"))] = torch.from_numpy(field)
    return out


def run_grid(name: str, grid, work: str, task: dict, inputs: dict,
             deadline_s: float = 180.0) -> list:
    """Parent side: write the task, run the ``pipe × data × space`` ranks
    of ``grid`` under a deadline that kills the world, return each rank's
    outputs."""
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(work, "task.json"), "w") as f:
        json.dump({**task, "grid": list(grid), "dir": work}, f)
    if inputs:
        np.savez(os.path.join(work, "in.npz"), **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    world = int(np.prod(grid))
    mesh.spawn_world([sys.executable, os.path.abspath(__file__), name, work], world,
                     deadline_s, env=env, cwd=REPO)
    return [dict(np.load(os.path.join(work, f"out_{r}.npz"))) for r in range(world)]


def start_grid(name: str, grid, work: str, task: dict, inputs: dict,
               deadline_s: float = 180.0) -> Future:
    """:func:`run_grid` on a thread of its own, so that the world's ranks
    run while the caller computes its references; the future's
    ``result()`` is the ranks' outputs, or raises the world's failure.
    ``inputs`` must not change once the world has started."""
    pool = ThreadPoolExecutor(1, thread_name_prefix=f"grid-{name}")
    try:
        return pool.submit(run_grid, name, grid, work, task, inputs, deadline_s)
    finally:
        pool.shutdown(wait=False)


def main() -> int:
    name, work = sys.argv[1], sys.argv[2]
    rank, _, _ = mesh.world_from_env()
    torch.manual_seed(0)
    mesh.initialize_distributed("gloo", f"file://{os.path.join(work, 'rendezvous')}")
    with open(os.path.join(work, "task.json")) as f:
        task = json.load(f)
    path = os.path.join(work, "in.npz")
    inputs = np.load(path) if os.path.exists(path) else None
    try:
        if name not in ("cli", "trainer"):
            mesh.init_grid(*task["grid"])
        out = {"halo": _halo, "spatial": _spatial, "cli": _cli, "trainer": _trainer,
               "pipeline": _pipeline}[name](task, inputs, rank)
    finally:
        mesh.destroy_distributed()
    np.savez(os.path.join(work, f"out_{rank}.npz"), **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
