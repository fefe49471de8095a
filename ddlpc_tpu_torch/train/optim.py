"""Optimizer from TrainConfig — the port's copy of ``ddlpc_tpu/train/optim.py``.

This slice ports Adam at a constant learning rate, the flagship's
optimizer, written out in optax's order of operations rather than taken
from ``torch.optim.Adam`` (whose ``denom = sqrt(v)/sqrt(bc2) + eps``
rounds differently)::

    mu  = (1 − b1)·g   + b1·mu
    nu  = (1 − b2)·g²  + b2·nu
    m̂   = mu / (1 − b1^t),   v̂ = nu / (1 − b2^t)      (fp32 corrections)
    p  += (−lr) · m̂ / (sqrt(v̂) + eps)

It runs on flat fp32 buffers (``parallel/train_step.FlatParams``), one
elementwise pass per term over the whole model, and updates the params and
moments in place.  Other optimizers, schedules, weight decay and clipping
raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ddlpc_tpu_torch.config import TrainConfig
from ddlpc_tpu_torch.ops.quantize import true_div


@dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: step count and the two moments, as flat
    fp32 buffers aligned with ``FlatParams.data``."""

    count: int
    mu: torch.Tensor
    nu: torch.Tensor


class Adam:
    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr = lr
        self.b1 = b1
        self.b2 = b2
        self.eps = eps

    def init(self, params: torch.Tensor) -> AdamState:
        return AdamState(0, torch.zeros_like(params), torch.zeros_like(params))

    def _bias_correction(self, decay: float, count: int) -> float:
        """``1 − decay**count`` in fp32, as optax computes it.  (XLA's fp32
        ``pow`` is its own; PyTorch's agrees with it to 1 ulp.)"""
        d = torch.tensor(decay, dtype=torch.float32)
        return float(1.0 - d ** torch.tensor(float(count), dtype=torch.float32))

    @torch.no_grad()
    def update(self, grads: torch.Tensor, state: AdamState, params: torch.Tensor) -> None:
        """One Adam step: ``params``, ``state.mu`` and ``state.nu`` in place."""
        b1, b2 = self.b1, self.b2
        torch.add((1 - b1) * grads, b1 * state.mu, out=state.mu)
        torch.add((1 - b2) * (grads * grads), b2 * state.nu, out=state.nu)
        state.count += 1
        mu_hat = true_div(state.mu, self._bias_correction(b1, state.count))
        nu_hat = true_div(state.nu, self._bias_correction(b2, state.count))
        step = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        params.add_((-1.0 * self.lr) * step)


def build_optimizer(cfg: TrainConfig) -> Adam:
    if cfg.optimizer != "adam":
        raise NotImplementedError(f"train.optimizer={cfg.optimizer!r} is not yet ported")
    if cfg.lr_schedule != "constant" or cfg.warmup_steps:
        raise NotImplementedError(
            f"train.lr_schedule={cfg.lr_schedule!r} with warmup_steps="
            f"{cfg.warmup_steps} is not yet ported (constant, no warmup only)"
        )
    if cfg.weight_decay:
        raise NotImplementedError("train.weight_decay is not yet ported")
    if cfg.grad_clip_norm:
        raise NotImplementedError("train.grad_clip_norm is not yet ported")
    return Adam(cfg.learning_rate)
