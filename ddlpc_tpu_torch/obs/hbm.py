"""Per-device state bytes by kind — the port's copy of ``state_hbm_bytes``
and ``publish_hbm_gauges`` from ``ddlpc_tpu/obs/hbm.py``, over the port's
flat buffers (``parallel/train_step.FlatParams``).

The kinds are the JAX package's; which of them a replica holds chunked
is the state's placement (``state.placement``, the
``parallel/shard_update.StateLayout`` of one rule table), and the bytes
are what the port holds (``K`` = ``shard``, a replica's owned elements
over every bucket region; the buffers pad each region to ``N·K_b``, which
is ``n`` on one replica without buckets):

- ``params``: the flat parameter buffer, ``Σ N·K_b`` fp32 elements, where
  JAX holds the ``n`` params of the leaves; where the params persist
  chunked (zero3) this replica's ``K`` owned elements (the full buffer is
  a temporary of the step, freed after its update);
- ``grads``: the optimizer-boundary gradient — the whole flat gradient,
  or this replica's ``K`` elements where it persists chunked (zero2,
  zero3; JAX: ``n``, or ``Σ ceil(n_leaf / N)`` over its per-leaf chunks);
- ``grads_accum``: the flat gradient buffer backward accumulates into,
  ``Σ N·K_b`` elements under every level (JAX: ``n``);
- ``opt_state``: the optimizer's moments (Adam's ``mu`` and ``nu``, SGD's
  ``trace``), whole or ``K`` elements each (the counts are host ints;
  JAX's are 4-byte device scalars);
- ``batch_stats``: the BatchNorm running means and variances, as in JAX.

``ddlpc_hbm_replicated_by_rule_bytes`` is the placement's
``replicated_by_rule_bytes()``: 0 on the flat layout, which pads a leaf
the data axis does not divide where JAX's GSPMD layouts keep it whole
(ROADMAP C21).
"""

from __future__ import annotations

from typing import Dict, Optional


def state_hbm_bytes(state, level: Optional[str] = None) -> Dict[str, int]:
    """Bytes one replica holds of a ``TrainState``, by kind, as its
    placement chunks them.  ``level``, where given (JAX's signature), is
    the ZeRO level the caller expects: a placement that amounts to
    another raises rather than count another level's bytes."""
    flat, placement = state.params, state.placement
    if level is not None and placement.level != level:
        raise ValueError(f"the state's placement is {placement.level}, not {level}")
    item = flat.grad.element_size()
    params = flat.shard if placement.chunked["params"] else flat.grad.numel()
    grads = flat.shard if placement.chunked["grads"] else flat.grad.numel()
    stats = [b for name, b in state.model.named_buffers()
             if name.endswith(("running_mean", "running_var"))]
    return {
        "params": params * item,
        "grads": grads * item,
        "grads_accum": flat.grad.numel() * item,
        "opt_state": sum(t.numel() * t.element_size() for t in state.opt_state.buffers().values()),
        "batch_stats": sum(b.numel() * b.element_size() for b in stats),
    }


def publish_hbm_gauges(registry, state) -> Dict[str, int]:
    """Set ``ddlpc_hbm_bytes{kind}`` from a ``TrainState`` and
    ``ddlpc_hbm_replicated_by_rule_bytes`` from its placement's
    ``replicated_by_rule_bytes()``; returns the breakdown.  Static for a
    run's layout: the trainer publishes it once."""
    gauge = registry.gauge(
        "ddlpc_hbm_bytes",
        "Per-device resident state bytes (grads = optimizer-boundary "
        "gradient, this replica's chunks under zero2/zero3; grads_accum = the flat "
        "fp32 gradient buffer backward accumulates into).",
        labelnames=("kind",),
    )
    breakdown = state_hbm_bytes(state)
    for kind, nbytes in breakdown.items():
        gauge.set(float(nbytes), kind=kind)
    registry.gauge(
        "ddlpc_hbm_replicated_by_rule_bytes",
        "Per-device bytes the partition-rule engine decided to keep "
        "replicated (uneven GSPMD dims, reason='replicated-by-rule') — "
        "the sharding contract's budgeted fallback.",
    ).set(float(state.placement.replicated_by_rule_bytes()))
    return breakdown


def pipeline_stage_hbm_bytes(stage_states) -> list:
    """Each stage's :func:`state_hbm_bytes`, as each stage's own
    placement (the ZeRO level within the stage's data group) has it:
    under ``pipe = S`` every kind that scales with the parameters drops
    to the stage's share, as in ``ddlpc_tpu/obs/hbm.py``."""
    return [state_hbm_bytes(st) for st in stage_states]


def pipeline_carry_stash_bytes(carry_shapes, n_microbatches: int, n_data: int) -> int:
    """Bytes of one stage's GPipe input-carry stash: ``M`` micro-batches'
    carries (``carry_shapes``: ``(shape, dtype)`` of one global
    micro-batch's carry, ``PipelineTrainStep.carry_shapes``), the batch
    split over the stage's ``n_data`` replicas."""
    import torch

    per_mb = 0
    for shape, dtype in carry_shapes:
        n = 1
        for d in shape:
            n *= int(d)
        per_mb += n * torch.empty((), dtype=dtype).element_size()
    return (per_mb // max(1, n_data)) * int(n_microbatches)
