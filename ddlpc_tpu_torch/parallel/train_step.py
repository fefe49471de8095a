"""Train and eval steps — the port's copy of ``ddlpc_tpu/parallel/train_step.py``
for one device.

One optimizer step, as in the reference: ``A = sync_period`` micro-batches
of forward/backward accumulate fp32 gradients, the mean gradient goes
through the codec's sync (``grad_sync.sync_gradients``), and Adam updates
the params.  BatchNorm running statistics advance once per micro-batch.

PyTorch idiom instead of JAX's pure functions: the state is updated in
place.  Every parameter is a view into one flat fp32 buffer
(:class:`FlatParams`), and every ``.grad`` a view into a second one, so
backward accumulates straight into the buffer the codec kernels and Adam
each sweep in one launch — no per-leaf loop, no gather.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ddlpc_tpu_torch.config import CompressionConfig
from ddlpc_tpu_torch.ops.losses import nll_correct_valid, softmax_cross_entropy_sum
from ddlpc_tpu_torch.ops.metrics import confusion_from_logits
from ddlpc_tpu_torch.ops.philox import step_key
from ddlpc_tpu_torch.parallel.grad_sync import sync_gradients
from ddlpc_tpu_torch.train.optim import Adam, AdamState


class FlatParams:
    """Re-homes every parameter of ``module`` into one contiguous fp32
    buffer (``data``) and points every ``.grad`` at a view of a second one
    (``grad``), both on the module's device.  Offsets follow
    ``named_parameters()`` order; ``views(buf)`` cuts any flat buffer of the
    same layout (the Adam moments) into per-parameter views."""

    def __init__(self, module: nn.Module):
        params = list(module.named_parameters())
        if not params:
            raise ValueError("module has no parameters")
        device = params[0][1].device
        for name, p in params:
            if p.dtype != torch.float32 or p.device != device:
                raise ValueError(f"parameter {name} must be float32 on {device}")
        self.names: List[str] = [n for n, _ in params]
        self.shapes = [tuple(p.shape) for _, p in params]
        self.offsets = []
        n = 0
        for _, p in params:
            self.offsets.append(n)
            n += p.numel()
        self.numel = n
        self.data = torch.empty(n, dtype=torch.float32, device=device)
        self.grad = torch.zeros(n, dtype=torch.float32, device=device)
        with torch.no_grad():
            for (_, p), view, gview in zip(params, self.views(self.data), self.views(self.grad)):
                view.copy_(p)
                p.data = view
                p.grad = gview

    def views(self, buf: torch.Tensor) -> List[torch.Tensor]:
        return [
            buf[o : o + _numel(s)].view(s) for o, s in zip(self.offsets, self.shapes)
        ]

    def named_views(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        return dict(zip(self.names, self.views(buf)))


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


@dataclass
class TrainState:
    """The model (params + BatchNorm statistics), its flat buffers, the
    Adam state and the optimizer step count."""

    model: nn.Module
    params: FlatParams
    opt_state: AdamState
    step: int = 0


def create_train_state(model: nn.Module, tx: Adam) -> TrainState:
    """Flatten an initialized model (already on its device) into a state."""
    flat = FlatParams(model)
    return TrainState(model=model, params=flat, opt_state=tx.init(flat.data))


def loss_from_logits(
    logits: torch.Tensor, labels: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean pixel NLL and tie-corrected accuracy over the micro-batch's
    valid pixels (label −1 is void), full-resolution logits ``[..., C]``."""
    if logits.shape[:-1] != labels.shape:
        raise ValueError(
            f"logits {tuple(logits.shape)} do not match labels {tuple(labels.shape)}"
        )
    nll, correct, valid = nll_correct_valid(logits, labels, ignore_index=-1)
    denom = torch.clamp_min(valid.sum(), 1.0)
    return (nll * valid).sum() / denom, (correct * valid).sum() / denom


def _accumulate_grads(
    state: TrainState, images: torch.Tensor, labels: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward/backward over the ``A`` micro-batches of ``images [A,B,H,W,C]``,
    leaving the MEAN fp32 gradient in ``state.params.grad``.  Returns the
    per-micro-batch losses and accuracies ``[A]`` (on the device)."""
    model = state.model
    model.train()
    state.params.grad.zero_()
    losses, accs = [], []
    for x, y in zip(images, labels):
        loss, acc = loss_from_logits(model(x), y)
        loss.backward()
        losses.append(loss.detach())
        accs.append(acc.detach())
    state.params.grad.div_(images.shape[0])
    return torch.stack(losses), torch.stack(accs)


def grad_norm(flat_grad: torch.Tensor) -> torch.Tensor:
    """Global L2 norm of the (synced) gradient."""
    return torch.linalg.vector_norm(flat_grad)


def _rounding_rng(
    compression: CompressionConfig, seed: int, step: int
) -> Optional[int]:
    """Stochastic-rounding key: a pure function of (experiment seed, step
    counter), so a replayed run draws the same noise and another seed other
    noise; None unless the rounding is stochastic.  ``step`` is a host int,
    so nothing waits on the card."""
    if compression.rounding != "stochastic":
        return None
    return step_key(seed, step)


def make_train_step(
    tx: Adam, compression: CompressionConfig, axis_size: int = 1, seed: int = 0
) -> Callable[[TrainState, torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]:
    """The train step: ``step(state, images [A,B,H,W,C], labels [A,B,H,W])``
    updates ``state`` in place and returns ``{loss, pixel_acc, grad_norm}``
    as device scalars (averaged over the A micro-batches).  ``seed``
    (``train.seed``) keys stochastic rounding together with ``state.step``."""

    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        losses, accs = _accumulate_grads(state, images, labels)
        flat = state.params
        key = _rounding_rng(compression, seed, state.step)
        sync_gradients(flat.grad, compression, axis_size=axis_size, key=key)
        tx.update(flat.grad, state.opt_state, flat.data)
        state.step += 1
        return {
            "loss": losses.mean(),
            "pixel_acc": accs.mean(),
            "grad_norm": grad_norm(flat.grad),
        }

    return step


def make_eval_step(
    num_classes: int,
) -> Callable[[TrainState, torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]:
    """Eval step on a batch ``[B,H,W,C]``: summed confusion matrix, summed
    NLL and valid-pixel count (the caller sums over batches, divides once)."""

    @torch.no_grad()
    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        state.model.eval()
        logits = state.model(images)
        nll_sum, count = softmax_cross_entropy_sum(logits, labels, ignore_index=-1)
        return {
            "confusion": confusion_from_logits(logits, labels, num_classes),
            "loss_sum": nll_sum,
            "pixel_count": count,
        }

    return step
