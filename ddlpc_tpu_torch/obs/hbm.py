"""Per-device state bytes by kind — the port's copy of ``state_hbm_bytes``
and ``publish_hbm_gauges`` from ``ddlpc_tpu/obs/hbm.py``, over the port's
flat buffers (``parallel/train_step.FlatParams``).

The kinds are the JAX package's; the bytes are what the port holds
(``K`` = ``shard``, a replica's owned elements over every bucket region;
the buffers pad each region to ``N·K_b``, which is ``n`` on one replica
without buckets):

- ``params``: the flat parameter buffer, ``Σ N·K_b`` fp32 elements, where
  JAX holds the ``n`` params of the leaves; under ``zero3`` this
  replica's ``K`` owned elements (the full buffer is a temporary of the
  step, freed after its update);
- ``grads``: the optimizer-boundary gradient — the whole flat gradient
  under ``off`` and ``zero1``, this replica's ``K`` elements under
  ``zero2`` and ``zero3`` (JAX: ``n``, or ``Σ ceil(n_leaf / N)`` over its
  per-leaf chunks);
- ``grads_accum``: the flat gradient buffer backward accumulates into,
  ``Σ N·K_b`` elements under every level (JAX: ``n``);
- ``opt_state``: the optimizer's moments (Adam's ``mu`` and ``nu``, SGD's
  ``trace``), whole under ``off`` and ``K`` elements each under the
  chunked levels (the counts are host ints; JAX's are 4-byte device
  scalars);
- ``batch_stats``: the BatchNorm running means and variances, as in JAX.
"""

from __future__ import annotations

from typing import Dict


def state_hbm_bytes(state, level: str = "off") -> Dict[str, int]:
    """Bytes one replica holds of a ``TrainState``, by kind; ``level`` is
    the resolved ZeRO level."""
    flat = state.params
    item = flat.grad.element_size()
    sharded = flat.n_shards > 1
    params = flat.shard if level == "zero3" and sharded else flat.grad.numel()
    grads = flat.shard if level in ("zero2", "zero3") and sharded else flat.grad.numel()
    stats = [b for name, b in state.model.named_buffers()
             if name.endswith(("running_mean", "running_var"))]
    return {
        "params": params * item,
        "grads": grads * item,
        "grads_accum": flat.grad.numel() * item,
        "opt_state": sum(t.numel() * t.element_size() for t in state.opt_state.buffers().values()),
        "batch_stats": sum(b.numel() * b.element_size() for b in stats),
    }


def publish_hbm_gauges(registry, state, level: str = "off") -> Dict[str, int]:
    """Set ``ddlpc_hbm_bytes{kind}`` from a ``TrainState``; returns the
    breakdown.  Static for a run's layout: the trainer publishes it once."""
    gauge = registry.gauge(
        "ddlpc_hbm_bytes",
        "Per-device resident state bytes (grads = optimizer-boundary "
        "gradient, this replica's chunks under zero2/zero3; grads_accum = the flat "
        "fp32 gradient buffer backward accumulates into).",
        labelnames=("kind",),
    )
    breakdown = state_hbm_bytes(state, level)
    for kind, nbytes in breakdown.items():
        gauge.set(float(nbytes), kind=kind)
    return breakdown


def pipeline_stage_hbm_bytes(stage_states, level: str = "off") -> list:
    """Each stage's :func:`state_hbm_bytes` (``level`` the ZeRO level
    within the stage's data group): under ``pipe = S`` every kind that
    scales with the parameters drops to the stage's share, as in
    ``ddlpc_tpu/obs/hbm.py``."""
    return [state_hbm_bytes(st, level) for st in stage_states]


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
