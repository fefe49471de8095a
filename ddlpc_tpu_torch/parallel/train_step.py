"""Train and eval steps — the port's copy of ``ddlpc_tpu/parallel/train_step.py``.

One optimizer step, as in the reference: ``A = sync_period`` micro-batches
of forward/backward accumulate fp32 gradients, the mean gradient goes
through the codec's sync, and Adam updates the params.  BatchNorm running
statistics advance once per micro-batch.

Data parallel over ``axis_size`` processes (``parallel/mesh.py``), each
one replica with its own columns of the batch, at one of two ZeRO levels
(``shard_update.resolve_shard_update``):

- ``off``: ``grad_sync.sync_gradients`` all-reduces the mean, and every
  replica runs the same Adam update on the whole model;
- ``zero2``: ``grad_sync.sync_gradients_scatter`` leaves each replica its
  chunk of the mean, Adam runs on that chunk with moments of the chunk's
  size, and one all-gather publishes the params.

After the micro-batches the BatchNorm running statistics are averaged over
the replicas (as the JAX step's ``pmean`` does, equal or not), and the
logged loss and accuracy are the replicas' mean.

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
from ddlpc_tpu_torch.models.layers import group_labels
from ddlpc_tpu_torch.ops.losses import nll_correct_valid, softmax_cross_entropy_sum
from ddlpc_tpu_torch.ops.metrics import confusion_from_logits
from ddlpc_tpu_torch.ops.philox import step_key
from ddlpc_tpu_torch.parallel import mesh
from ddlpc_tpu_torch.parallel.grad_sync import (
    sync_gradients,
    sync_gradients_scatter,
    validate_scatter_compression,
)
from ddlpc_tpu_torch.parallel.shard_update import (
    check_ported,
    flat_chunk_rows,
    local_chunk,
    normalize_shard_update,
)
from ddlpc_tpu_torch.train.optim import Adam, AdamState


class FlatParams:
    """Re-homes every parameter of ``module`` into one contiguous fp32
    buffer (``data``) and points every ``.grad`` at a view of a second one
    (``grad``), both on the module's device.  Offsets follow
    ``named_parameters()`` order; ``views(buf)`` cuts any flat buffer of the
    same layout (the Adam moments) into per-parameter views.

    For ``n_shards`` replicas the buffers hold ``n_shards · shard``
    elements, ``shard`` being ``shard_update.flat_chunk_rows``: the
    ``numel`` parameters, then a zero tail that no view covers."""

    def __init__(self, module: nn.Module, n_shards: int = 1):
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
        self.n_shards = n_shards
        self.shard = flat_chunk_rows(n, n_shards)
        self.data = torch.zeros(n_shards * self.shard, dtype=torch.float32, device=device)
        self.grad = torch.zeros_like(self.data)
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

    def local(self, buf: torch.Tensor, index: int) -> torch.Tensor:
        """Replica ``index``'s chunk of a buffer of this layout, a view."""
        return local_chunk(buf, self.n_shards, index)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


@dataclass
class TrainState:
    """The model (params + BatchNorm statistics), its flat buffers, the
    Adam state (over the whole buffer under ``off``, over this replica's
    chunk under ``zero2``) and the optimizer step count."""

    model: nn.Module
    params: FlatParams
    opt_state: AdamState
    step: int = 0


def create_train_state(
    model: nn.Module, tx: Adam, axis_size: int = 1, level: str = "off"
) -> TrainState:
    """Flatten an initialized model (already on its device, the same
    weights on every replica) into a state for ``axis_size`` replicas at
    ZeRO ``level``."""
    check_ported(level)
    flat = FlatParams(model, n_shards=axis_size)
    owned = flat.data
    if level == "zero2":
        owned = flat.local(flat.data, mesh.replica_index())
    return TrainState(model=model, params=flat, opt_state=tx.init(owned))


def loss_from_logits(
    logits: torch.Tensor, labels: torch.Tensor, train_head_layout: str = "fullres"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean pixel NLL and tie-corrected accuracy over the micro-batch's
    valid pixels (label −1 is void), as the reference computes them.

    ``logits`` are ``[..., H, W, C]`` over labels ``[..., H, W]``, or, from
    a model that declares ``train_head_layout='grouped'``, pre-d2s
    ``[..., H/r, W/r, r²·C]``: the labels are grouped the same way
    (``layers.group_labels``) and the loss runs on the ``[..., r², C]``
    view, the same pairs of logit row and label.  A deep-supervision stack
    ``[J, ...]`` takes the labels broadcast over J, and the validity mask
    broadcast to the NLL's shape, so the loss is the mean of the per-head
    losses and the accuracy stays in [0, 1]."""
    if logits.shape[-3:-1] != labels.shape[-2:]:
        # Regroup only where the model declared it: wrong-shaped logits
        # whose dims happen to divide the labels' must not train.
        if train_head_layout != "grouped":
            raise ValueError(
                f"logits spatial shape {tuple(logits.shape[-3:-1])} != labels "
                f"{tuple(labels.shape[-2:])} but the model declares "
                f"train_head_layout={train_head_layout!r} — refusing to "
                "reinterpret as grouped logits"
            )
        r = labels.shape[-2] // logits.shape[-3]
        if (labels.shape[-2] != r * logits.shape[-3]
                or labels.shape[-1] != r * logits.shape[-2]):
            raise ValueError(
                f"grouped logits {tuple(logits.shape)} are not an integer r×r "
                f"regrouping of labels {tuple(labels.shape)}"
            )
        labels = group_labels(labels, r)
        logits = logits.reshape(*logits.shape[:-1], r * r, -1)
    nll, correct, valid = nll_correct_valid(logits, labels, ignore_index=-1)
    valid = valid.expand_as(nll)
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
    layout = getattr(model, "train_head_layout", "fullres")
    state.params.grad.zero_()
    losses, accs = [], []
    for x, y in zip(images, labels):
        loss, acc = loss_from_logits(model(x), y, layout)
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


@torch.no_grad()
def mean_batch_stats(model: nn.Module, axis_size: int) -> None:
    """Average the BatchNorm running statistics over the replicas, in one
    all-reduce of their concatenation."""
    if axis_size == 1:
        return
    bufs = [b for name, b in model.named_buffers() if name.endswith(("running_mean", "running_var"))]
    if not bufs:  # group norm or none: no statistics
        return
    flat = mesh.all_reduce_(torch.cat([b.reshape(-1) for b in bufs]))
    flat.div_(axis_size)
    for b, v in zip(bufs, flat.split([b.numel() for b in bufs])):
        b.copy_(v.view_as(b))


def make_train_step(
    tx: Adam,
    compression: CompressionConfig,
    axis_size: int = 1,
    seed: int = 0,
    level: str = "off",
) -> Callable[[TrainState, torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]:
    """The train step: ``step(state, images [A,B,H,W,C], labels [A,B,H,W])``
    (``B`` this replica's micro-batch) updates ``state`` in place and
    returns ``{loss, pixel_acc, grad_norm}`` as device scalars (averaged
    over the A micro-batches and the replicas).  ``seed`` (``train.seed``)
    keys stochastic rounding together with ``state.step``.  ``level`` is
    the ZeRO level (``off`` or ``zero2``, or the historical bool; one
    replica runs ``off``)."""
    level = normalize_shard_update(level)
    check_ported(level)
    if axis_size == 1:
        level = "off"
    if level == "zero2":
        validate_scatter_compression(compression)

    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        losses, accs = _accumulate_grads(state, images, labels)
        mean_batch_stats(state.model, axis_size)
        flat = state.params
        key = _rounding_rng(compression, seed, state.step)
        if level == "zero2":
            grads = sync_gradients_scatter(flat.grad, compression, axis_size, key=key)
            tx.update(grads, state.opt_state, flat.local(flat.data, mesh.replica_index()))
            mesh.all_gather_(flat.data)
            sq = torch.linalg.vector_norm(grads).square()
        else:
            sync_gradients(flat.grad, compression, axis_size=axis_size, key=key)
            tx.update(flat.grad, state.opt_state, flat.data)
            sq = None
        state.step += 1
        # One reduce for the logged metrics: the replicas' summed loss and
        # accuracy (then their mean) and, under zero2, the chunks' squared
        # norms (then the root of their sum).
        metrics = torch.stack([losses.mean(), accs.mean()] + ([] if sq is None else [sq]))
        if axis_size > 1:
            mesh.all_reduce_(metrics)
            metrics[:2] /= axis_size
        return {
            "loss": metrics[0],
            "pixel_acc": metrics[1],
            "grad_norm": grad_norm(flat.grad) if sq is None else metrics[2].sqrt(),
        }

    return step


def make_eval_step(
    num_classes: int, axis_size: int = 1
) -> Callable[[TrainState, torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]:
    """Eval step on a batch ``[B,H,W,C]``: summed confusion matrix, summed
    NLL and valid-pixel count (the caller sums over batches, divides once).
    With ``axis_size`` replicas, each evaluating its own columns of the
    batch, the three sums are summed over the replicas in one float64
    all-reduce (where the JAX step ``psum``s them)."""

    @torch.no_grad()
    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        state.model.eval()
        logits = state.model(images)
        nll_sum, count = softmax_cross_entropy_sum(logits, labels, ignore_index=-1)
        cm = confusion_from_logits(logits, labels, num_classes)
        if axis_size > 1:
            sums = torch.cat([cm.reshape(-1), nll_sum.reshape(1), count.reshape(1)]).double()
            mesh.all_reduce_(sums)
            cm, nll_sum, count = sums[:-2].view_as(cm), sums[-2], sums[-1]
        return {"confusion": cm, "loss_sum": nll_sum, "pixel_count": count}

    return step
