"""Weights across the two packages: flax variables ⇄ the port's state.

The flax side is nested dicts of numpy arrays keyed by the flax module
path (``params``, ``batch_stats``, and optionally optax's Adam ``mu``/``nu``
trees, which share the params' layout); the torch side is a ``state_dict``
of the port's modules, whose names follow the same path
(``DownBlock_0/DoubleConv_0/ConvNormAct_0/Conv_0/kernel`` ⇄
``DownBlock_0.DoubleConv_0.ConvNormAct_0.Conv_0.weight``).

Leaf rules:

- a conv ``kernel`` is HWIO in flax and OIHW in torch;
- a ``ConvTranspose_0`` kernel is ``(kh, kw, in, out)`` with flax's
  ``transpose_kernel=False``, which equals torch's transposed conv with the
  kernel flipped in space: flip, then permute to ``(in, out, kh, kw)``;
- BatchNorm and GroupNorm ``scale/bias`` are ``weight/bias``; BatchNorm's
  ``mean/var`` are ``running_mean/running_var``; every ``bias`` stays as
  it is (a model without BatchNorm has an empty ``batch_stats``).

Every rule is a permutation (and flip) of the same values, so the round
trip ``flax_from_torch(torch_state_from_flax(p))`` is exact.

The whole train state — what a checkpoint holds — is :func:`flax_tree`:
flax's ``to_state_dict(TrainState)`` layout with ``step`` and optax's
state tree (the chain's stages as ``"0"``, ``"1"``, ...: Adam's or SGD's
per-param trees and counts, a schedule's count, the empty states of
clipping and weight decay; :func:`optax_tree`) beside the params and
statistics; :func:`load_state_tree` places it in the train states of a
world of any size and ZeRO level.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

_PARAM_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _unflatten(flat: Mapping[Tuple[str, ...], np.ndarray]) -> dict:
    out: dict = {}
    for path, v in flat.items():
        cur = out
        for k in path[:-1]:
            cur = cur.setdefault(k, {})
        cur[path[-1]] = v
    return out


def _is_transpose(path: Tuple[str, ...]) -> bool:
    return len(path) >= 2 and path[-2].startswith("ConvTranspose")


def _kernel_to_torch(path: Tuple[str, ...], k: np.ndarray) -> np.ndarray:
    if k.ndim != 4:
        raise ValueError(f"{'/'.join(path)}: expected a 4-D kernel, got {k.shape}")
    if _is_transpose(path):
        return np.transpose(k[::-1, ::-1], (2, 3, 0, 1))
    return np.transpose(k, (3, 2, 0, 1))


def _kernel_to_flax(path: Tuple[str, ...], w: np.ndarray) -> np.ndarray:
    if _is_transpose(path):
        return np.transpose(w, (2, 3, 0, 1))[::-1, ::-1]
    return np.transpose(w, (2, 3, 1, 0))


def _to_tensor(v: np.ndarray) -> torch.Tensor:
    """An fp32 CPU tensor owning a C-contiguous copy of ``v``."""
    return torch.from_numpy(np.array(v, dtype=np.float32, order="C"))


def _params_to_torch(params: Mapping) -> Dict[str, np.ndarray]:
    out = {}
    for path, v in _flatten(params).items():
        name = _PARAM_NAMES.get(path[-1])
        if name is None:
            raise KeyError(f"unknown flax param leaf {'/'.join(path)}")
        if path[-1] == "kernel":
            v = _kernel_to_torch(path, v)
        out[".".join(path[:-1] + (name,))] = v
    return out


MOMENTS = ("mu", "nu", "trace")  # optax's per-param state leaves: Adam's, SGD's


def torch_state_from_flax(
    params: Mapping,
    batch_stats: Mapping,
    opt_state: Optional[Mapping] = None,
) -> Tuple[Dict[str, torch.Tensor], Optional[dict]]:
    """``(state_dict, opt)``: the model's ``state_dict`` (params and
    BatchNorm running statistics, fp32 CPU tensors) and, when ``opt_state``
    is given (optax's per-param trees and its count: ``{"count", "mu",
    "nu"}`` for Adam, ``{"trace"}`` for SGD, as :func:`optax_core` reads
    them), ``{"count": int or None, "mu": {name: tensor}, ...}`` in the
    same names and layouts."""
    sd = {k: _to_tensor(v) for k, v in _params_to_torch(params).items()}
    for path, v in _flatten(batch_stats).items():
        name = _STAT_NAMES.get(path[-1])
        if name is None:
            raise KeyError(f"unknown flax batch_stats leaf {'/'.join(path)}")
        sd[".".join(path[:-1] + (name,))] = _to_tensor(v)
    opt = None
    if opt_state is not None:
        count = opt_state.get("count")
        opt = {"count": None if count is None else int(np.asarray(count))}
        for key in MOMENTS:
            if key in opt_state:
                opt[key] = {k: _to_tensor(v) for k, v in _params_to_torch(opt_state[key]).items()}
    return sd, opt


def torch_stage_states_from_flax(
    stage_params: Sequence[Mapping],
    stage_stats: Sequence[Mapping],
    stage_opts: Optional[Sequence[Mapping]] = None,
    layout=None,
) -> List[Tuple[Dict[str, torch.Tensor], Optional[dict]]]:
    """The JAX package's per-stage trees (``StagePlan.split`` of the
    params and the BatchNorm statistics, ``split_opt_state`` of the optax
    state, whose nesting is ``layout``) as each stage's ``(state_dict,
    opt)`` of the port: :func:`torch_state_from_flax` on each stage, so a
    JAX ``PipelineState`` and the port's stages start from the same
    numbers (``load_canonical`` places each into its stage)."""
    out = []
    for s, (params, stats) in enumerate(zip(stage_params, stage_stats)):
        core = None if stage_opts is None else optax_core(layout, stage_opts[s])
        out.append(torch_state_from_flax(params, stats, core))
    return out


def optax_core(layout, tree: Mapping) -> dict:
    """The per-param trees and the count of an optax state tree (flax's
    ``to_state_dict`` of it, a chain's stages under ``"0"``, ``"1"``, ...)
    whose nesting is ``layout`` (``train/optim.Optimizer.layout``)."""
    out: dict = {}

    def walk(node, sub) -> None:
        if isinstance(node, tuple):
            for i, child in enumerate(node):
                walk(child, sub[str(i)])
        elif node == "adam":
            out.update(count=sub["count"], mu=sub["mu"], nu=sub["nu"])
        elif node == "trace":
            out["trace"] = sub["trace"]
        elif node == "count":
            out.setdefault("count", sub["count"])
        elif node != "empty" or (isinstance(sub, Mapping) and sub):
            raise KeyError(f"optax state node {node!r} does not match {sub!r}")

    walk(layout, tree)
    return out


def optax_tree(layout, count: int, core: Mapping) -> dict:
    """Inverse of :func:`optax_core`: the optax state tree of ``layout``
    from the per-param trees in ``core``, each count a 0-d int32."""

    def build(node):
        if isinstance(node, tuple):
            return {str(i): build(child) for i, child in enumerate(node)}
        if node == "adam":
            return {"count": np.array(count, np.int32), "mu": core["mu"], "nu": core["nu"]}
        if node == "trace":
            return {"trace": core["trace"]}
        if node == "count":
            return {"count": np.array(count, np.int32)}
        return {}

    return build(layout)


def flax_param_path(name: str, ndim: int) -> Tuple[str, ...]:
    """The flax param path of the port's parameter ``name`` (``ndim`` its
    rank): a 4-D ``weight`` is a ``kernel``, any other ``weight`` a
    norm's ``scale``, a ``bias`` a ``bias``.  Sorting the params by this
    path gives ``jax.tree_util.tree_flatten``'s leaf order."""
    *mod, leaf = name.split(".")
    if leaf == "weight":
        return tuple(mod) + ("kernel" if ndim == 4 else "scale",)
    if leaf == "bias":
        return tuple(mod) + ("bias",)
    raise KeyError(f"unknown torch parameter {name}")


def flax_param_shape(path: Tuple[str, ...], shape) -> Tuple[int, ...]:
    """The flax shape of a parameter of torch ``shape`` at flax ``path``
    (a kernel in flax's HWIO layout), with no data moved."""
    if path[-1] != "kernel":
        return tuple(int(d) for d in shape)
    return _kernel_to_flax(path, np.broadcast_to(np.float32(0), tuple(shape))).shape


def _params_to_flax(named: Mapping[str, torch.Tensor]) -> dict:
    flat = {}
    for name, t in named.items():
        v = t.detach().cpu().numpy()
        path = flax_param_path(name, v.ndim)
        flat[path] = np.ascontiguousarray(_kernel_to_flax(path, v)) if path[-1] == "kernel" else v
    return _unflatten(flat)


def flax_from_torch(
    state_dict: Mapping[str, torch.Tensor], opt: Optional[Mapping] = None
) -> Tuple[dict, dict, Optional[dict]]:
    """Inverse of :func:`torch_state_from_flax`: ``(params, batch_stats,
    opt_state)`` as nested dicts of numpy arrays, ``opt_state`` the count
    (int32, where there is one) and the per-param trees (None without
    ``opt``)."""
    params, stats = {}, {}
    for name, t in state_dict.items():
        *mod, leaf = name.split(".")
        if leaf in ("running_mean", "running_var"):
            stats[tuple(mod) + (leaf[len("running_"):],)] = t.detach().cpu().numpy()
        elif leaf == "num_batches_tracked":
            continue
        else:
            params[name] = t
    core = None
    if opt is not None:
        core = {k: _params_to_flax(opt[k]) for k in MOMENTS if k in opt}
        if opt.get("count") is not None:
            core["count"] = np.int32(opt["count"])
    return _params_to_flax(params), _unflatten(stats), core


def _full_buffer(flat, named: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """A buffer of ``flat``'s padded layout holding ``named`` (zero tail)."""
    buf = torch.zeros_like(flat.grad)
    for view, name in zip(flat.views(buf), flat.names):
        view.copy_(named[name])
    return buf


def load_canonical(state, state_dict: Mapping[str, torch.Tensor], opt: Optional[Mapping] = None) -> None:
    """Carry a canonical (full, unsharded) state — as
    :func:`torch_state_from_flax` gives it — into a train state
    (``parallel.train_step.TrainState``) in place, as its placement has
    it: the model's params and BatchNorm statistics whole (and, where the
    params persist chunked, this replica's chunks of them), and the
    optimizer's moments whole or as this replica's chunks."""
    from ddlpc_tpu_torch.parallel.mesh import replica_index

    flat = state.params
    if state.owned is not None:
        flat.materialize()
        flat.data.zero_()
    state.model.load_state_dict(state_dict, strict=True)
    index = replica_index()
    if state.owned is not None:
        state.owned.copy_(flat.gather_owned(flat.data, index))
    if opt is None:
        return
    if opt.get("count") is not None:
        state.opt_state.count = int(opt["count"])
    for key, mine in state.opt_state.buffers().items():
        full = _full_buffer(flat, opt[key])
        mine.copy_(flat.gather_owned(full, index) if state.placement.chunked["opt_state"] else full)


def _host_copy(t: torch.Tensor, host: Optional[dict], key: str) -> torch.Tensor:
    """A host copy of ``t``: into ``host[key]`` (allocated on first use,
    pinned when ``t`` is on a card, and reused after), else a new tensor.
    A card's copy into pinned memory is asynchronous: the caller
    synchronizes before reading it."""
    if host is None:
        return t.detach().to("cpu", copy=True)
    buf = host.get(key)
    if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
        host[key] = buf
    return buf.copy_(t.detach(), non_blocking=t.is_cuda)


def gather_canonical(
    state, host: Optional[dict] = None, to_host: bool = True
) -> Tuple[Optional[Dict[str, torch.Tensor]], Optional[dict]]:
    """The canonical state of a train state: ``(state_dict, opt)`` on the
    CPU, the moments (and the params) all-gathered from the replicas'
    chunks where the state's placement chunks them (every replica must
    call it).  ``opt`` holds the count, each moment by parameter name and the
    optax ``layout``.  Each flat buffer (params and each moment) is copied
    to the host once, and the leaves are views of that copy; ``host``
    holds reusable buffers for the copies (see :func:`_host_copy`).
    ``to_host=False`` joins the gathers only and returns ``(None, None)``."""
    from ddlpc_tpu_torch.parallel.mesh import replica_index

    flat, opt = state.params, state.opt_state
    state.gather_params()
    full = {"data": flat.data}
    for key, mine in opt.buffers().items():
        if state.placement.chunked["opt_state"]:
            buf = torch.zeros_like(flat.grad)
            flat.put_owned(mine, buf, replica_index())
            mine = flat.all_gather_(buf)
        full[key] = mine
    if not to_host:
        return None, None
    copies = {k: _host_copy(v, host, k) for k, v in full.items()}
    params = flat.named_views(copies["data"])
    sd = {
        name: params[name] if name in params else _host_copy(v, host, name)
        for name, v in state.model.state_dict().items()
    }
    if flat.data.is_cuda:
        torch.cuda.synchronize(flat.data.device)
    out = {"count": opt.count, "layout": state.layout}
    out.update({k: flat.named_views(copies[k]) for k in opt.buffers()})
    return sd, out


def flax_tree(state_dict: Mapping[str, torch.Tensor], opt: Mapping, step: int) -> dict:
    """The state dict flax's ``to_state_dict(TrainState)`` gives the JAX
    package for the same state: ``step`` as a 0-d int32 array, ``params``
    and ``batch_stats`` in the flax layout, and ``opt_state`` the optax
    state tree of ``opt["layout"]`` (Adam's ``(ScaleByAdamState,
    EmptyState)`` by default): its counts 0-d int32, its per-param trees
    in the flax layout, an ``EmptyState`` an empty dict."""
    params, batch_stats, core = flax_from_torch(state_dict, opt)
    return {
        "step": np.array(step, np.int32),
        "params": params,
        "batch_stats": batch_stats,
        "opt_state": optax_tree(opt.get("layout", ("adam", "empty")), opt["count"], core),
    }


def load_state_tree(state, tree: Optional[Mapping], src: int = 0) -> None:
    """Place global rank ``src``'s state tree (:func:`flax_tree`'s layout, as a
    checkpoint restores it) into every replica's train state, in place and
    in that replica's layout (:func:`load_canonical`), step included.
    ``src`` lays the canonical state out in full flat buffers on its
    device, and one broadcast a buffer carries them to the others, whose
    ``tree`` is None (every replica must call it); in a world of one the
    broadcasts do nothing.  An optimizer whose optax state has no count
    (SGD at a constant rate) takes the step."""
    from ddlpc_tpu_torch.parallel.mesh import broadcast_, world_rank

    flat = state.params
    device = flat.grad.device
    stat_names = [k for k in state.model.state_dict() if k not in set(flat.names)]
    stats_like = [state.model.get_buffer(k) for k in stat_names]
    moments = list(state.opt_state.buffers())
    if world_rank() == src:
        core = optax_core(state.layout, tree["opt_state"])
        sd, opt = torch_state_from_flax(tree["params"], tree["batch_stats"], core)
        step = int(np.asarray(tree["step"]))
        data = _full_buffer(flat, sd)
        bufs = [_full_buffer(flat, opt[k]) for k in moments]
        stats = torch.cat([sd[k].reshape(-1) for k in stat_names] + [torch.zeros(0)]).to(device)
        count = step if opt["count"] is None else opt["count"]
        ints = torch.tensor([count, step], device=device)
    else:
        data, *bufs = (torch.empty_like(flat.grad) for _ in range(1 + len(moments)))
        stats = torch.empty(sum(b.numel() for b in stats_like), device=device)
        ints = torch.zeros(2, dtype=torch.int64, device=device)
    for t in (data, *bufs, stats, ints):
        broadcast_(t, src)
    sd = flat.named_views(data)
    for name, v, like in zip(stat_names, stats.split([b.numel() for b in stats_like]), stats_like):
        sd[name] = v.view_as(like)
    count, step = (int(v) for v in ints.tolist())
    load_canonical(state, sd, {"count": count, **{k: flat.named_views(b) for k, b in zip(moments, bufs)}})
    state.step = step
