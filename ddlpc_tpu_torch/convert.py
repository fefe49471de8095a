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
flax's ``to_state_dict(TrainState)`` layout with ``step``, the Adam
``count`` and optax's empty state beside the params, statistics and
moments; :func:`load_state_tree` places it in the train states of a
world of any size and layout.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

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


def torch_state_from_flax(
    params: Mapping,
    batch_stats: Mapping,
    opt_state: Optional[Mapping] = None,
) -> Tuple[Dict[str, torch.Tensor], Optional[dict]]:
    """``(state_dict, adam)``: the model's ``state_dict`` (params and
    BatchNorm running statistics, fp32 CPU tensors) and, when ``opt_state``
    = ``{"count", "mu", "nu"}`` is given, ``{"count": int, "mu": {name:
    tensor}, "nu": {name: tensor}}`` in the same names and layouts."""
    sd = {k: _to_tensor(v) for k, v in _params_to_torch(params).items()}
    for path, v in _flatten(batch_stats).items():
        name = _STAT_NAMES.get(path[-1])
        if name is None:
            raise KeyError(f"unknown flax batch_stats leaf {'/'.join(path)}")
        sd[".".join(path[:-1] + (name,))] = _to_tensor(v)
    adam = None
    if opt_state is not None:
        adam = {"count": int(np.asarray(opt_state["count"]))}
        for key in ("mu", "nu"):
            adam[key] = {k: _to_tensor(v) for k, v in _params_to_torch(opt_state[key]).items()}
    return sd, adam


def _params_to_flax(named: Mapping[str, torch.Tensor]) -> dict:
    flat = {}
    for name, t in named.items():
        *mod, leaf = name.split(".")
        path = tuple(mod)
        v = t.detach().cpu().numpy()
        if leaf == "weight" and v.ndim == 4:
            flat[path + ("kernel",)] = np.ascontiguousarray(_kernel_to_flax(path + ("kernel",), v))
        elif leaf == "weight":
            flat[path + ("scale",)] = v
        elif leaf == "bias":
            flat[path + ("bias",)] = v
        else:
            raise KeyError(f"unknown torch parameter {name}")
    return _unflatten(flat)


def flax_from_torch(
    state_dict: Mapping[str, torch.Tensor], adam: Optional[Mapping] = None
) -> Tuple[dict, dict, Optional[dict]]:
    """Inverse of :func:`torch_state_from_flax`: ``(params, batch_stats,
    opt_state)`` as nested dicts of numpy arrays (``opt_state`` None
    without ``adam``)."""
    params, stats = {}, {}
    for name, t in state_dict.items():
        *mod, leaf = name.split(".")
        if leaf in ("running_mean", "running_var"):
            stats[tuple(mod) + (leaf[len("running_"):],)] = t.detach().cpu().numpy()
        elif leaf == "num_batches_tracked":
            continue
        else:
            params[name] = t
    opt = None
    if adam is not None:
        opt = {
            "count": np.int32(adam["count"]),
            "mu": _params_to_flax(adam["mu"]),
            "nu": _params_to_flax(adam["nu"]),
        }
    return _params_to_flax(params), _unflatten(stats), opt


def _full_buffer(flat, named: Mapping[str, torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    """A buffer of ``flat``'s padded layout holding ``named`` (zero tail)."""
    buf = torch.zeros_like(like)
    for view, name in zip(flat.views(buf), flat.names):
        view.copy_(named[name])
    return buf


def load_canonical(state, state_dict: Mapping[str, torch.Tensor], adam: Optional[Mapping] = None) -> None:
    """Carry a canonical (full, unsharded) state — as
    :func:`torch_state_from_flax` gives it — into a train state
    (``parallel.train_step.TrainState``) in place: the model's params and
    BatchNorm statistics whole, and the Adam moments whole under
    ``shard_update='off'`` or as this replica's chunk under ``zero2``."""
    state.model.load_state_dict(state_dict, strict=True)
    if adam is None:
        return
    flat, opt = state.params, state.opt_state
    opt.count = int(adam["count"])
    for key in ("mu", "nu"):
        full = _full_buffer(flat, adam[key], flat.data)
        mine = getattr(opt, key)
        if mine.numel() != full.numel():  # zero2: this replica's chunk
            from ddlpc_tpu_torch.parallel.mesh import replica_index

            full = flat.local(full, replica_index())
        mine.copy_(full)


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
    """The canonical state of a train state: ``(state_dict, adam)`` on the
    CPU, the Adam moments all-gathered from the replicas' chunks under
    ``zero2`` (every replica must call it).  Each flat buffer (params,
    ``mu``, ``nu``) is copied to the host once, and the leaves are views of
    that copy; ``host`` holds reusable buffers for the copies (see
    :func:`_host_copy`).  ``to_host=False`` joins the gather only and
    returns ``(None, None)``."""
    from ddlpc_tpu_torch.parallel.mesh import all_gather_, replica_index

    flat, opt = state.params, state.opt_state
    full = {"data": flat.data}
    for key in ("mu", "nu"):
        mine = getattr(opt, key)
        if mine.numel() != flat.data.numel():
            buf = torch.zeros_like(flat.data)
            flat.local(buf, replica_index()).copy_(mine)
            mine = all_gather_(buf)
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
    adam = {"count": opt.count, "mu": flat.named_views(copies["mu"]),
            "nu": flat.named_views(copies["nu"])}
    return sd, adam


def flax_tree(state_dict: Mapping[str, torch.Tensor], adam: Mapping, step: int) -> dict:
    """The state dict flax's ``to_state_dict(TrainState)`` gives the JAX
    package for the same state: ``step`` and ``opt_state/0/count`` as 0-d
    int32 arrays, ``params``, ``batch_stats``, ``opt_state/0/{mu,nu}`` in
    the flax layout, and ``opt_state/1`` (optax's ``EmptyState``) an
    empty dict."""
    params, batch_stats, opt = flax_from_torch(state_dict, adam)
    opt["count"] = np.array(opt["count"], np.int32)
    return {
        "step": np.array(step, np.int32),
        "params": params,
        "batch_stats": batch_stats,
        "opt_state": {"0": opt, "1": {}},
    }


def load_state_tree(state, tree: Optional[Mapping], src: int = 0) -> None:
    """Place replica ``src``'s state tree (:func:`flax_tree`'s layout, as a
    checkpoint restores it) into every replica's train state, in place and
    in that replica's layout (:func:`load_canonical`), step included.
    ``src`` lays the canonical state out in full flat buffers on its
    device, and one broadcast a buffer carries them to the others, whose
    ``tree`` is None (every replica must call it); in a world of one the
    broadcasts do nothing."""
    from ddlpc_tpu_torch.parallel.mesh import broadcast_, replica_index

    flat = state.params
    stat_names = [k for k in state.model.state_dict() if k not in set(flat.names)]
    stats_like = [state.model.get_buffer(k) for k in stat_names]
    if replica_index() == src:
        sd, adam = torch_state_from_flax(tree["params"], tree["batch_stats"], tree["opt_state"]["0"])
        data = _full_buffer(flat, sd, flat.data)
        mu = _full_buffer(flat, adam["mu"], flat.data)
        nu = _full_buffer(flat, adam["nu"], flat.data)
        stats = torch.cat([sd[k].reshape(-1) for k in stat_names] + [torch.zeros(0)]).to(flat.data.device)
        ints = torch.tensor([adam["count"], int(np.asarray(tree["step"]))], device=flat.data.device)
    else:
        data, mu, nu = (torch.empty_like(flat.data) for _ in range(3))
        stats = torch.empty(sum(b.numel() for b in stats_like), device=flat.data.device)
        ints = torch.zeros(2, dtype=torch.int64, device=flat.data.device)
    for t in (data, mu, nu, stats, ints):
        broadcast_(t, src)
    sd = flat.named_views(data)
    for name, v, like in zip(stat_names, stats.split([b.numel() for b in stats_like]), stats_like):
        sd[name] = v.view_as(like)
    count, step = (int(v) for v in ints.tolist())
    load_canonical(state, sd, {"count": count, "mu": flat.named_views(mu), "nu": flat.named_views(nu)})
    state.step = step
