"""Per-device state bytes by kind — the port's copy of ``state_hbm_bytes``
and ``publish_hbm_gauges`` from ``ddlpc_tpu/obs/hbm.py``, over the port's
flat buffers (``parallel/train_step.FlatParams``).

The kinds are the JAX package's; the bytes are what the port holds:

- ``params``: the flat parameter buffer, ``N·K`` fp32 elements, where JAX
  holds the ``n`` params of the leaves (``K`` = ``flat_chunk_rows(n, N)``;
  the buffer pads to ``N·K``, which is ``n`` on one replica);
- ``grads``: the optimizer-boundary gradient — the whole flat gradient
  under ``off``, this replica's ``K``-element chunk under ``zero2`` (JAX:
  ``n``, or ``Σ ceil(n_leaf / N)`` over its per-leaf chunks);
- ``grads_accum``: the flat gradient buffer backward accumulates into,
  ``N·K`` elements under every level (JAX: ``n``);
- ``opt_state``: Adam's ``mu`` and ``nu`` (the step count is a host int;
  JAX's is a 4-byte device scalar);
- ``batch_stats``: the BatchNorm running means and variances, as in JAX.
"""

from __future__ import annotations

from typing import Dict


def state_hbm_bytes(state, level: str = "off") -> Dict[str, int]:
    """Bytes one replica holds of a ``TrainState``, by kind; ``level`` is
    the resolved ZeRO level (``off`` or ``zero2``)."""
    flat = state.params
    opt = state.opt_state
    grads = flat.shard if level == "zero2" and flat.n_shards > 1 else flat.grad.numel()
    stats = [b for name, b in state.model.named_buffers()
             if name.endswith(("running_mean", "running_var"))]
    return {
        "params": flat.data.numel() * flat.data.element_size(),
        "grads": grads * flat.grad.element_size(),
        "grads_accum": flat.grad.numel() * flat.grad.element_size(),
        "opt_state": sum(t.numel() * t.element_size() for t in (opt.mu, opt.nu)),
        "batch_stats": sum(b.numel() * b.element_size() for b in stats),
    }


def publish_hbm_gauges(registry, state, level: str = "off") -> Dict[str, int]:
    """Set ``ddlpc_hbm_bytes{kind}`` from a ``TrainState``; returns the
    breakdown.  Static for a run's layout: the trainer publishes it once."""
    gauge = registry.gauge(
        "ddlpc_hbm_bytes",
        "Per-device resident state bytes (grads = optimizer-boundary "
        "gradient, this replica's chunk under zero2; grads_accum = the flat "
        "fp32 gradient buffer backward accumulates into).",
        labelnames=("kind",),
    )
    breakdown = state_hbm_bytes(state, level)
    for kind, nbytes in breakdown.items():
        gauge.set(float(nbytes), kind=kind)
    return breakdown
