"""ZeRO-1/2/3: the weight update sharded across replicas — the port's copy
of the parts of ``ddlpc_tpu/parallel/shard_update.py`` its train step runs.

- ``zero1``: the moments persist as chunks.  The gradient sync stays the
  full all-reduce (every codec and transport, the ring included); each
  replica updates its chunk of the params and one all-gather publishes
  them.
- ``zero2``: the gradient sync is a reduce-scatter, so replica ``r`` gets
  only its chunk of the mean; the update and the publish as zero1.
- ``zero3``: the params persist as chunks too.  The step all-gathers them
  into a temporary full buffer for the forward and backward, and the
  fresh chunks are not gathered at its end.

Chunk layout.  The JAX package chunks each leaf (``chunk_leaf``: flatten,
zero-pad to a multiple of N, view as ``[N, K]``).  The port chunks each
region of its flat buffer (``train_step.FlatParams``: the whole buffer, or
one region a gradient bucket) the same way.  Per element the two are the
same arithmetic (an exact integer sum on the narrow wire, one multiply by
a scalar, a max over the bucket, an elementwise update); only which
replica owns which element differs.  A region holds ``N·K`` elements with
K rounded up to a multiple of 32 (:func:`flat_chunk_rows`), so every
chunk starts 128-byte aligned (the codec kernels' vector loads need 16)
and the collectives read and write the buffers with no copy.  The zero
tail stays zero: its max-abs is 0, its lattice point is 0 under either
rounding, and every optimizer's update of a zero gradient from zero
state at a zero param is 0.

Which kinds persist chunked is not decided here by level: one rule table
decides it (:class:`StateLayout`, over ``partition.state_partition_rules``
as the JAX package's ``StateLayout``), and the state, the steps, the
checkpoint's gather and the HBM gauges read the layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ddlpc_tpu_torch.config import CompressionConfig
from ddlpc_tpu_torch.parallel import partition

CHUNK_LAYOUTS = ("zero1", "zero2", "zero3")
_ALIGN_ELEMENTS = 32  # 128 bytes of fp32
# The rule table of each level (``off`` is JAX's ``replicated`` layout).
LAYOUT_LEVEL = {"off": "replicated", "zero1": "zero1", "zero2": "zero2", "zero3": "zero3"}
# Which kinds each level's rule table chunks on the flat layout, and back:
# the flat layout chunks the params only with the gradients, and those only
# with the moments.
LEVEL_CHUNKS = {
    "off": {"params": False, "grads": False, "opt_state": False},
    "zero1": {"params": False, "grads": False, "opt_state": True},
    "zero2": {"params": False, "grads": True, "opt_state": True},
    "zero3": {"params": True, "grads": True, "opt_state": True},
}
_RUNGS = {tuple(c[k] for k in ("opt_state", "grads", "params")): level
          for level, c in LEVEL_CHUNKS.items()}


def normalize_shard_update(value) -> str:
    """The historical bool (``True`` = the sharded program, zero2) or a
    level string, as one level string."""
    if value is True:
        return "zero2"
    if value is False or value is None or value == "off":
        return "off"
    if value in CHUNK_LAYOUTS:
        return value
    raise ValueError(
        f"unknown shard_update level {value!r} "
        f"(expected off|zero1|zero2|zero3 or a bool)"
    )


def chunk_rows(n_elements: int, n_shards: int) -> int:
    """K of the JAX package's per-leaf layout: ``ceil(n / N)``."""
    return -(-n_elements // n_shards)


def flat_chunk_rows(n_elements: int, n_shards: int) -> int:
    """K of the port's flat layout: ``ceil(n / N)`` rounded up to a
    multiple of 32 elements; ``n`` itself for one shard (nothing pads)."""
    if n_shards == 1:
        return n_elements
    k = chunk_rows(n_elements, n_shards)
    return -(-k // _ALIGN_ELEMENTS) * _ALIGN_ELEMENTS


def region_rows(n_elements: int, n_shards: int, aligned: bool) -> int:
    """K of one region of the flat buffers: :func:`flat_chunk_rows`, or,
    where the buffer holds several regions (gradient buckets), always a
    multiple of 32 elements, so that every region starts 128-byte aligned
    on one replica too."""
    if not aligned:
        return flat_chunk_rows(n_elements, n_shards)
    return -(-chunk_rows(n_elements, n_shards) // _ALIGN_ELEMENTS) * _ALIGN_ELEMENTS


def flat_layout(sizes, n_shards: int, bucket_mb: float = 0.0):
    """The flat buffers' layout for leaves of ``sizes`` elements (fp32, in
    flatten order): ``(offsets, regions, total)``, each leaf's offset, each
    gradient bucket's region ``(start, leaf elements, rows)`` — its leaves
    contiguous from ``start``, then a zero tail up to ``n_shards · rows``
    elements — and the buffers' length."""
    from ddlpc_tpu_torch.parallel.bucketing import bucket_index_groups

    groups = bucket_index_groups([4 * n for n in sizes], bucket_mb)
    offsets = [0] * len(sizes)
    regions = []
    start = 0
    for idxs in groups:
        o = start
        for i in idxs:
            offsets[i] = o
            o += sizes[i]
        rows = region_rows(o - start, n_shards, aligned=len(groups) > 1)
        regions.append((start, o - start, rows))
        start += n_shards * rows
    return offsets, regions, start


def local_chunk(buf: torch.Tensor, n_shards: int, index: int) -> torch.Tensor:
    """Replica ``index``'s chunk of a flat buffer of ``N·K`` elements, a
    view: row ``index`` of its ``[N, K]`` view."""
    if buf.dim() != 1 or buf.numel() % n_shards:
        raise ValueError(
            f"a flat buffer of N·K elements is needed, got {tuple(buf.shape)} "
            f"for N={n_shards}"
        )
    return buf.view(n_shards, buf.numel() // n_shards)[index]


def resolve_shard_update(
    mode: str,
    compression: CompressionConfig,
    data_size: int,
    spatial: bool,
    grad_clip_norm: float = 0.0,
) -> str:
    """``ParallelConfig.shard_update`` as a ZeRO level (``'off' | 'zero1' |
    'zero2' | 'zero3'``), decision for decision as the JAX package resolves
    it (``ddlpc_tpu/parallel/shard_update.py:191``).

    ``auto`` and ``on`` are ``zero2``.  ``auto`` falls back to ``off`` on
    one replica and where the scatter path cannot reproduce the
    replicated one bit for bit: ``transport='ring'``, the pallas backend
    with ``quantize_mean``, and ``grad_clip_norm > 0`` (a clip inside the
    update would see one shard's norm).  An explicit level raises there
    instead; on one replica it is ``off``."""
    if mode not in ("auto", "on", "off", "zero1", "zero2", "zero3"):
        raise ValueError(
            f"unknown shard_update {mode!r} (expected 'auto', 'on', 'off', "
            f"'zero1', 'zero2' or 'zero3')"
        )
    if mode == "off":
        return "off"
    level = "zero2" if mode in ("auto", "on") else mode
    incompatible = None
    if not spatial:
        scatter_based = level in ("zero2", "zero3")
        if scatter_based and compression.mode != "none":
            if compression.transport == "ring":
                incompatible = (
                    "transport='ring' — the ring all-reduce owns its own "
                    "quantized reduce-scatter/all-gather over whole leaves "
                    "(shard_update='zero1' composes with the ring)"
                )
            elif compression.quantize_mean and compression.codec_backend == "pallas":
                # The port's Philox draw could be sliced; the decision is
                # the JAX package's, whose TPU hardware-PRNG draw cannot.
                incompatible = (
                    "codec_backend='pallas' with quantize_mean — the "
                    "kernel's hardware-PRNG noise field cannot be sliced to "
                    "a shard of the mean; use codec_backend='xla' or "
                    "shard_update='zero1'"
                )
        if incompatible is None and grad_clip_norm:
            incompatible = (
                "grad_clip_norm > 0 — a clip by global norm inside the "
                "update would clip each replica's 1/N shard by its own "
                "partial norm, not the global norm; disable clipping"
            )
    if mode != "auto":
        if incompatible:
            raise ValueError(
                f"shard_update={mode!r} cannot compose with {incompatible}; "
                f"set shard_update='off' (or 'auto', which resolves it)"
            )
        return level if data_size > 1 else "off"
    return level if data_size > 1 and incompatible is None else "off"


# ---------------------------------------------------------------------------
# the rule table's placement of the state


@dataclass(frozen=True)
class LeafSpec:
    """A leaf's shape and dtype with no data (JAX's ``ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: Any = np.float32


def _decisions(tree) -> List[partition.Decision]:
    return [d for _, d in partition.leaves_with_path(tree)]


def _one_placement(kind: str, decisions: Sequence[partition.Decision]) -> bool:
    """Whether every leaf of ``kind`` is sharded (True) or whole (False).
    The flat buffers hold a kind one way or the other: a table that splits
    it raises, naming a leaf of each side and its rule."""
    sharded = [d for d in decisions if d.sharded]
    whole = [d for d in decisions if not d.sharded]
    if sharded and whole:
        a, b = sharded[0], whole[0]
        raise ValueError(
            f"the flat layout holds the {kind} all chunked or all whole, but the rule "
            f"table splits them: {a.name} is sharded by rule {a.rule!r} and {b.name} "
            f"is whole by rule {b.rule!r} ({b.reason})"
        )
    return bool(sharded)


class StateLayout:
    """Where each kind of a train state persists on the ``n_shards``
    replicas of the data axis, decided by one ordered rule table
    (``partition.state_partition_rules`` of the level, or ``rules``) in
    the rule engine's ``chunk`` mode — the JAX package's ``StateLayout``
    for its shard_map layouts.  The port's flat buffer is a chunk layout
    on a data mesh and on a ``data × space`` grid alike.

    ``params`` is the model's named leaves in the flax layout (their flax
    paths, ``convert.flax_param_path``, each with its flax shape):
    ``param_decisions``, ``grad_decisions`` (the optimizer-boundary
    gradient, ``grads/...``) and ``opt_decisions`` (optax's state tree of
    ``opt_layout``, ``Optimizer.layout``) are trees of
    ``partition.Decision`` as JAX's.  ``chunked[kind]`` (``params``,
    ``grads``, ``opt_state``: the moments) is what the state, the steps,
    the checkpoint's gather and ``obs/hbm.py`` read, and ``level`` the ZeRO
    level that placement amounts to.

    Refusals: the flat buffers cannot hold a kind split between chunked
    and whole leaves, nor chunked params without chunked gradients, nor
    those without chunked moments, nor a chunked optax count (a host int
    here); such a table raises, naming the leaf and the rule.  A table
    that shards no params at zero3 therefore keeps them whole: it never
    chunks a kind the rules do not shard."""

    KINDS = ("params", "grads", "opt_state")

    def __init__(self, params: dict, opt_layout, level: str, n_shards: int,
                 data_axis: str = "data", rules: Optional[Sequence[partition.Rule]] = None):
        from ddlpc_tpu_torch.convert import MOMENTS, optax_tree

        level = normalize_shard_update(level)
        self.n = int(n_shards)
        if self.n == 1:
            level = "off"
        self.rules = tuple(rules) if rules is not None else partition.state_partition_rules(
            LAYOUT_LEVEL[level], data_axis)
        self.param_avals = params
        self.opt_template = optax_tree(opt_layout, 0, {k: params for k in MOMENTS})
        pshapes = frozenset(tuple(leaf.shape) for _, leaf in partition.leaves_with_path(params))
        kw = dict(mode="chunk", n_shards=self.n, data_axis=data_axis)
        self.param_decisions = partition.decide_tree(self.rules, params, "params", **kw)
        self.grad_decisions = partition.decide_tree(self.rules, params, "grads", **kw)
        self.opt_decisions = partition.decide_tree(self.rules, self.opt_template, "opt_state",
                                                   pshapes=pshapes, **kw)
        moments, other = [], []
        for path, d in partition.leaves_with_path(self.opt_decisions):
            (moments if any(k in MOMENTS for k in path) else other).append(d)
        for d in other:
            if d.sharded:
                raise ValueError(
                    f"{d.name} is sharded by rule {d.rule!r}, but the port keeps optax's "
                    f"counts whole (host ints)"
                )
        kinds = {"params": _decisions(self.param_decisions),
                 "grads": _decisions(self.grad_decisions), "opt_state": moments}
        self.chunked: Dict[str, bool] = {
            k: _one_placement("moments" if k == "opt_state" else k, ds) for k, ds in kinds.items()}
        rung = (self.chunked["opt_state"], self.chunked["grads"], self.chunked["params"])
        if rung not in _RUNGS:
            bad = [k for k in self.KINDS if self.chunked[k]][0]
            missing = [k for k in self.KINDS[self.KINDS.index(bad) + 1:] if not self.chunked[k]][0]
            a, b = kinds[bad][0], kinds[missing][0]
            raise ValueError(
                f"the flat layout chunks the params only with the gradients, and those only "
                f"with the moments: {a.name} is sharded by rule {a.rule!r} but {b.name} is "
                f"whole by rule {b.rule!r}"
            )
        self.level = _RUNGS[rung]

    @classmethod
    def from_flat(cls, flat, opt_layout, level: str, data_axis: str = "data",
                  rules: Optional[Sequence[partition.Rule]] = None) -> "StateLayout":
        """The layout of a ``train_step.FlatParams``'s leaves (its torch
        names and shapes, in flatten order) over its ``n_shards``."""
        from ddlpc_tpu_torch.convert import flax_param_path, flax_param_shape

        params: dict = {}
        for name, shape in zip(flat.names, flat.shapes):
            path = flax_param_path(name, len(shape))
            node = params
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = LeafSpec(flax_param_shape(path, shape))
        return cls(params, opt_layout, level, flat.n_shards, data_axis, rules)

    def replicated_by_rule_bytes(self) -> int:
        """Bytes a replica holds of the leaves the rule engine decided to
        keep whole (``replicated-by-rule``): the ``ddlpc_hbm`` budget
        line, as JAX's.  The flat layout pads a leaf the data axis does not
        divide instead (C21), so in chunk mode this is 0."""
        return (partition.replicated_by_rule_bytes(self.opt_decisions, self.opt_template)
                + partition.replicated_by_rule_bytes(self.param_decisions, self.param_avals))

    def summary(self) -> Dict[str, dict]:
        """Each kind's placement: chunked or whole, its leaves, how many the
        rules shard, and the leaves each rule pattern decided."""
        out = {}
        for kind, tree in (("params", self.param_decisions), ("grads", self.grad_decisions),
                           ("opt_state", self.opt_decisions)):
            ds = _decisions(tree)
            rules: Dict[str, int] = {}
            for d in ds:
                key = f"{d.rule} ({d.reason})"
                rules[key] = rules.get(key, 0) + 1
            out[kind] = {"chunked": self.chunked[kind], "leaves": len(ds),
                         "sharded": sum(d.sharded for d in ds), "rules": rules}
        return out
