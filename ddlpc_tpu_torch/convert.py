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
- BatchNorm ``scale/bias`` are ``weight/bias``; ``mean/var`` are
  ``running_mean/running_var``; every ``bias`` stays as it is.

Every rule is a permutation (and flip) of the same values, so the round
trip ``flax_from_torch(torch_state_from_flax(p))`` is exact.
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
