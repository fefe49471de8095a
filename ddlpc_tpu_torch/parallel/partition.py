"""Declarative regex partition rules — the port's copy of
``ddlpc_tpu/parallel/partition.py``.

Two rule engines over **named leaves**, a leaf's name being its
``/``-joined path in a nested-dict tree (``params/DownBlock_0/DoubleConv_0/
ConvNormAct_0/Conv_0/kernel``): the flax paths, which
``convert.flax_param_path`` maps from torch's dotted names, so that rule
regexes and decisions compare one to one with the JAX package's.

- **ZeRO state rules** (:class:`Rule`, :func:`decide`, :func:`decide_tree`,
  :func:`state_partition_rules`): an ordered ``(regex, spec)`` table, the
  first ``re.search`` match wins, a leaf no rule matches is an error.  A
  spec is a plain tuple of axis names or None (JAX's ``PartitionSpec``;
  ``()`` is replicated) or the :data:`SHARD` sentinel, which resolves per
  layout: ``chunk`` mode shards the leaf's ``[N, K]`` chunk view on the
  data axis, ``leaf`` mode partitions the largest dimension that divides
  evenly (:func:`even_shard_spec`) and otherwise records
  ``replicated-by-rule``.
- **Stage rules** (:class:`StageRule`, :func:`balanced_stage_assignment`,
  :func:`split_tree_by_stage`, :func:`merge_stage_trees`): which pipeline
  stage holds each parameter (``parallel/pipeline.py``).

A tree is a nested dict (or list/tuple) whose leaves have a ``shape``:
torch tensors, numpy arrays, or anything else shaped.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

PyTree = Any


class _ShardSentinel:
    """Marker spec: "shard this leaf, the layout picks how"."""

    def __repr__(self) -> str:
        return "SHARD"


SHARD = _ShardSentinel()

REASON_RULE = "rule"
REASON_AUTO = "auto-shard"
REASON_REPLICATED_BY_RULE = "replicated-by-rule"
REASON_NOT_PARAM_SHAPED = "not-param-shaped"


@dataclass(frozen=True)
class Rule:
    """One ordered partition rule: ``re.search(pattern, leaf_name)``."""

    pattern: str
    spec: Any  # a tuple of axis names / None, or SHARD


@dataclass(frozen=True)
class Decision:
    """The resolved placement of one named leaf."""

    name: str
    shape: Tuple[int, ...]
    spec: tuple
    rule: Optional[str]
    reason: str

    @property
    def sharded(self) -> bool:
        return any(ax is not None for ax in tuple(self.spec))


# ---------------------------------------------------------------------------
# trees


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple)) and not hasattr(x, "shape")


def _items(node):
    if isinstance(node, dict):
        return list(node.items())
    return list(enumerate(node))


def leaves_with_path(tree: PyTree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """``[(path, leaf)]`` in the JAX flatten order (dict keys sorted)."""
    if not _is_node(tree):
        return [(path, tree)]
    items = _items(tree)
    if isinstance(tree, dict):
        items = sorted(items, key=lambda kv: kv[0])
    out = []
    for k, v in items:
        out.extend(leaves_with_path(v, path + (k,)))
    return out


def tree_map_with_path(fn: Callable, tree: PyTree, path: Tuple = ()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if not _is_node(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return type(tree)(tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))


def leaf_name(prefix: str, path) -> str:
    return "/".join(([prefix] if prefix else []) + [str(k) for k in path])


def named_leaves(tree: PyTree, prefix: str = "") -> List[Tuple[str, Any]]:
    """Flatten ``tree`` to ``[(name, leaf)]`` with ``/``-joined path names
    (``prefix`` prepended) — the namespace the rule tables match."""
    return [(leaf_name(prefix, p), leaf) for p, leaf in leaves_with_path(tree)]


def leaf_bytes(leaf) -> int:
    """Bytes of a shaped leaf (torch, numpy, or any ``dtype.itemsize``)."""
    n = 1
    for d in leaf.shape:
        n *= int(d)
    if hasattr(leaf, "element_size"):
        item = leaf.element_size()
    else:
        item = np.dtype(leaf.dtype).itemsize
    return n * item


# ---------------------------------------------------------------------------
# the ZeRO rule engine


def match_partition_rules(rules: Sequence[Rule], name: str) -> Rule:
    """First rule whose pattern ``re.search``-matches ``name``; none is an
    error (the table must end with ``Rule('.*', ())``)."""
    for rule in rules:
        if re.search(rule.pattern, name):
            return rule
    raise ValueError(
        f"no partition rule matches leaf {name!r} — the rule table must "
        f"be total (end it with Rule('.*', P()))"
    )


def even_shard_spec(shape: Tuple[int, ...], n_shards: int, data_axis: str) -> tuple:
    """Partition the largest dimension that divides evenly by the data
    axis; no such dimension is ``()`` (the caller records
    ``replicated-by-rule``)."""
    if not shape:
        return ()
    pick = None
    for d in sorted(range(len(shape)), key=lambda d: shape[d], reverse=True):
        if shape[d] >= n_shards and shape[d] % n_shards == 0:
            pick = d
            break
    if pick is None:
        return ()
    spec = [None] * len(shape)
    spec[pick] = data_axis
    return tuple(spec)


def decide(
    rules: Sequence[Rule],
    name: str,
    shape: Tuple[int, ...],
    *,
    mode: str,
    n_shards: int,
    data_axis: str,
    param_shaped: bool = True,
) -> Decision:
    """Resolve one named leaf against the rule table (``mode`` ``chunk`` or
    ``leaf``, as the JAX package's ``decide``)."""
    if mode not in ("chunk", "leaf"):
        raise ValueError(f"unknown partition mode {mode!r}")
    shape = tuple(int(d) for d in shape)
    rule = match_partition_rules(rules, name)
    if not isinstance(rule.spec, _ShardSentinel):
        return Decision(name, shape, tuple(rule.spec), rule.pattern, REASON_RULE)
    if not param_shaped:
        return Decision(name, shape, (), rule.pattern, REASON_NOT_PARAM_SHAPED)
    if mode == "chunk":
        return Decision(name, shape, (data_axis,), rule.pattern, REASON_AUTO)
    spec = even_shard_spec(shape, n_shards, data_axis)
    reason = REASON_AUTO if any(ax is not None for ax in spec) else REASON_REPLICATED_BY_RULE
    return Decision(name, shape, spec, rule.pattern, reason)


def decide_tree(
    rules: Sequence[Rule],
    tree: PyTree,
    prefix: str,
    *,
    mode: str,
    n_shards: int,
    data_axis: str,
    pshapes: Optional[frozenset] = None,
) -> PyTree:
    """:func:`decide` over a tree → a tree of :class:`Decision` of the same
    structure.  ``pshapes`` (the parameter shapes) feeds the param-shaped
    gate; None disables it."""

    def one(path, leaf):
        shape = tuple(int(d) for d in leaf.shape)
        param_shaped = True
        if pshapes is not None:
            param_shaped = len(shape) > 0 and shape in pshapes
        return decide(rules, leaf_name(prefix, path), shape, mode=mode, n_shards=n_shards,
                      data_axis=data_axis, param_shaped=param_shaped)

    return tree_map_with_path(one, tree)


def state_partition_rules(level: str, data_axis: str = "data") -> Tuple[Rule, ...]:
    """The ZeRO ladder as one ordered table over ``params/...``,
    ``grads/...`` and ``opt_state/...`` names: zero1 shards the moments
    (``mu``/``nu``/``trace``), zero2 the gradients too, zero3 the params
    too; the total catch-all ``Rule('.*', ())`` ends it."""
    if level not in ("replicated", "zero1", "zero2", "zero3"):
        raise ValueError(
            f"unknown ZeRO level {level!r} (expected replicated|zero1|zero2|zero3)"
        )
    del data_axis
    rules: List[Rule] = []
    if level == "zero3":
        rules.append(Rule(r"^params/", SHARD))
    if level in ("zero2", "zero3"):
        rules.append(Rule(r"^grads/", SHARD))
    if level != "replicated":
        rules.append(Rule(r"^opt_state/(.*/)?(mu|nu|trace)(/|$)", SHARD))
    rules.append(Rule(r".*", ()))
    return tuple(rules)


def _decisions(decisions: PyTree) -> List[Decision]:
    return [leaf for _, leaf in leaves_with_path(decisions)]


def replicated_by_rule_bytes(decisions: PyTree, tree: PyTree) -> int:
    """Bytes of the leaves the engine decided to replicate
    (``replicated-by-rule``)."""
    total = 0
    for d, (_, leaf) in zip(_decisions(decisions), leaves_with_path(tree)):
        if d.reason == REASON_REPLICATED_BY_RULE:
            total += leaf_bytes(leaf)
    return total


def chunk_leaf(x, n_shards: int):
    """Flatten, zero-pad to a multiple of ``n_shards`` and view as ``[N,
    K]`` (the JAX package's ``shard_update.chunk_leaf``); torch or numpy."""
    flat = x.reshape(-1)
    k = -(-flat.shape[0] // n_shards)
    pad = n_shards * k - flat.shape[0]
    if hasattr(flat, "new_zeros"):
        import torch

        flat = torch.cat([flat, flat.new_zeros(pad)])
    else:
        flat = np.concatenate([flat, np.zeros(pad, flat.dtype)])
    return flat.reshape(n_shards, k)


def unchunk_leaf(x, shape: Tuple[int, ...]):
    n = 1
    for d in shape:
        n *= int(d)
    return x.reshape(-1)[:n].reshape(shape)


def make_shard_and_gather_fns(decisions: PyTree, n_shards: int, mode: str):
    """Per-leaf ``(shard_fns, gather_fns)`` from one decision tree: in
    ``chunk`` mode an auto-sharded leaf chunks to ``[N, K]`` and back,
    every other leaf (and every leaf in ``leaf`` mode) is the identity."""
    if mode not in ("chunk", "leaf"):
        raise ValueError(f"unknown partition mode {mode!r}")
    chunked = mode == "chunk"

    def shard_fn(_, d: Decision):
        if chunked and d.reason == REASON_AUTO:
            return lambda x, n=n_shards: chunk_leaf(x, n)
        return lambda x: x

    def gather_fn(_, d: Decision):
        if chunked and d.reason == REASON_AUTO:
            return lambda x, shape=d.shape: unchunk_leaf(x, shape)
        return lambda x: x

    return tree_map_with_path(shard_fn, decisions), tree_map_with_path(gather_fn, decisions)


# ---------------------------------------------------------------------------
# pipeline stage rules


@dataclass(frozen=True)
class StageRule:
    """``re.search(pattern, leaf_name)`` → the leaf lives on ``stage``."""

    pattern: str
    stage: int


def match_stage_rules(rules: Sequence[StageRule], name: str) -> int:
    for rule in rules:
        if re.search(rule.pattern, name):
            return rule.stage
    raise ValueError(
        f"no stage rule matches leaf {name!r} — the stage table must cover "
        f"every parameter (parallel/pipeline.py builds it from the model's "
        f"block list; an uncovered leaf means the cut and the model "
        f"disagree)"
    )


def stage_rules_for_blocks(
    block_names: Sequence[str], assignment: Sequence[int]
) -> Tuple[StageRule, ...]:
    """One rule a top-level module path, anchored at the start of the leaf
    name (``^{block}/``): block names recur nested, so only the top-level
    path may decide."""
    if len(block_names) != len(assignment):
        raise ValueError("block_names and assignment length mismatch")
    return tuple(StageRule(rf"^{re.escape(b)}/", int(s)) for b, s in zip(block_names, assignment))


def balanced_stage_assignment(block_bytes: Sequence[int], n_stages: int) -> List[int]:
    """The contiguous cut of the ordered blocks into ``n_stages`` groups
    that minimizes the largest group's bytes (the linear-partition DP of
    the JAX package, its ties broken the same way); the per-block stage,
    non-decreasing."""
    n = len(block_bytes)
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if n_stages > n:
        raise ValueError(
            f"cannot cut {n} blocks into {n_stages} stages — at most one stage per block"
        )
    prefix = [0]
    for b in block_bytes:
        prefix.append(prefix[-1] + int(b))
    inf = float("inf")
    cost = [[inf] * (n + 1) for _ in range(n_stages + 1)]
    cut = [[0] * (n + 1) for _ in range(n_stages + 1)]
    cost[0][0] = 0
    for k in range(1, n_stages + 1):
        for j in range(k, n + 1):
            for i in range(k - 1, j):
                c = max(cost[k - 1][i], prefix[j] - prefix[i])
                if c < cost[k][j]:
                    cost[k][j], cut[k][j] = c, i
    bounds = [n]
    for k in range(n_stages, 0, -1):
        bounds.append(cut[k][bounds[-1]])
    bounds.reverse()
    out: List[int] = []
    for s in range(n_stages):
        out.extend([s] * (bounds[s + 1] - bounds[s]))
    return out


def split_tree_by_stage(
    rules: Sequence[StageRule], tree: PyTree, n_stages: int, prefix: str
) -> List[dict]:
    """A nested-dict tree cut into ``n_stages`` trees by each leaf's stage
    (empty dicts pruned); the inverse of :func:`merge_stage_trees`."""
    outs: List[dict] = [{} for _ in range(n_stages)]
    for path, leaf in leaves_with_path(tree):
        name = leaf_name(prefix, path)
        stage = match_stage_rules(rules, name)
        if not 0 <= stage < n_stages:
            raise ValueError(
                f"stage rule for {name!r} assigns stage {stage}, outside [0, {n_stages})"
            )
        node = outs[stage]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return outs


def _copy_dicts(v):
    return {k: _copy_dicts(x) for k, x in v.items()} if isinstance(v, dict) else v


def merge_stage_trees(stage_trees: Sequence[dict]) -> dict:
    """Deep-merge per-stage trees back into one; a key two stages both
    hold raises."""

    def merge_into(dst: dict, src: dict, path: str):
        for k, v in src.items():
            here = f"{path}/{k}" if path else str(k)
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                merge_into(dst[k], v, here)
            elif k in dst:
                raise ValueError(
                    f"stage trees collide at {here!r} — stages must own disjoint blocks"
                )
            else:
                dst[k] = _copy_dicts(v)

    out: dict = {}
    for t in stage_trees:
        merge_into(out, t, "")
    return out
