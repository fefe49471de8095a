"""Train and eval steps — the port's copy of ``ddlpc_tpu/parallel/train_step.py``.

One optimizer step, as in the reference: ``A = sync_period`` micro-batches
of forward/backward accumulate fp32 gradients, the mean gradient goes
through the codec's sync, and the optimizer (``train/optim.py``) updates
the params.  BatchNorm running statistics advance once per micro-batch.
``remat`` recomputes each micro-batch's forward in its backward instead of
keeping its activations (``torch.utils.checkpoint``, the JAX step's
``jax.checkpoint``); the recompute does not advance the running
statistics again (``layers.recomputing``), so the step is the remat-off
step bit for bit.

Data parallel over ``axis_size`` processes (``parallel/mesh.py``), each
one replica with its own columns of the batch, at one of four ZeRO levels
(``shard_update.resolve_shard_update``), synced by
``grad_sync.sync_for_level``:

- ``off``: ``grad_sync.sync_gradients`` all-reduces the mean, and every
  replica runs the same update on the whole model;
- ``zero1``: the same all-reduce (every transport, the ring included),
  then each replica updates its chunks of the params with moments of the
  chunks' size, and one all-gather publishes the params;
- ``zero2``: ``grad_sync.sync_gradients_scatter`` leaves each replica
  only its chunks of the mean; the update and the all-gather as zero1;
- ``zero3``: the params persist as this replica's chunks only
  (``TrainState.owned``).  The step starts by all-gathering them into the
  flat buffer the model's parameters view, and frees that buffer once
  the update has run on the chunks; nothing is published at the end.

Every level gives the same params bit for bit: the update is elementwise
and sees the same mean gradient, element for element.  Which kinds
persist chunked is the state's ``shard_update.StateLayout``'s to say (one
rule table, ``partition.state_partition_rules`` of the level): the state,
the steps and the checkpoint's gather read it, not the level's name.

The spatial step (:func:`make_train_step_spatial`, the JAX package's
``make_train_step_gspmd``) runs on a ``data × space`` grid: each rank
holds its data shard's rows ``[s·H/S, (s+1)·H/S)``, the model's convs
exchange halo rows and its BatchNorm reduces over the stage's whole
(data, space) group (``models.shard_space``).  Its loss is the global
batch's: each rank's NLL sum over the global valid-pixel count, which is
all-reduced (void labels make it differ from shard to shard), and the
gradient is the sum of every rank's contribution, all-reduced over the
group.  The codec sees only that logical mean: ``quantize_mean`` per
bucket (``quantize_local`` and the ring have no per-replica gradient to
act on, and are refused in JAX's words).  The ZeRO levels then chunk the
update over each data group, bit for bit the replicated update.

After the micro-batches the BatchNorm running statistics are averaged over
the replicas (as the JAX step's ``pmean`` does, equal or not), and the
logged loss and accuracy are the replicas' mean.

PyTorch idiom instead of JAX's pure functions: the state is updated in
place.  Every parameter is a view into one flat fp32 buffer
(:class:`FlatParams`), and every ``.grad`` a view into a second one, so
backward accumulates straight into the buffer the codec kernels and the
optimizer sweep — no per-leaf loop, no gather.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ddlpc_tpu_torch.config import CompressionConfig
from ddlpc_tpu_torch.convert import flax_param_path
from ddlpc_tpu_torch.models.layers import group_labels, recomputing
from ddlpc_tpu_torch.ops.losses import nll_correct_valid, softmax_cross_entropy_sum
from ddlpc_tpu_torch.ops.metrics import confusion_from_logits
from ddlpc_tpu_torch.ops import philox
from ddlpc_tpu_torch.ops.philox import step_key
from ddlpc_tpu_torch.parallel import mesh
from ddlpc_tpu_torch.parallel.halo import aligned, reshard, row_layout
from ddlpc_tpu_torch.parallel.grad_sync import (
    check_supported,
    resolve_codec_backend,
    sync_for_level,
    validate_scatter_compression,
)
from ddlpc_tpu_torch.parallel.shard_update import (
    LEVEL_CHUNKS,
    StateLayout,
    flat_layout,
    normalize_shard_update,
)
from ddlpc_tpu_torch.train.optim import OptState, Optimizer


class FlatParams:
    """Re-homes every parameter of ``module`` into one contiguous fp32
    buffer (``data``) and points every ``.grad`` at a view of a second one
    (``grad``), both on the module's device.  The leaves lie in the JAX
    package's flatten order (their flax paths sorted,
    ``convert.flax_param_path``); ``views(buf)`` cuts any flat buffer of
    the same layout into per-parameter views.

    The buffers are cut into regions, one a gradient bucket
    (``bucketing.py``, ``bucket_mb``; one region without buckets): region
    ``b`` holds its leaves, contiguous, then a zero tail up to
    ``n_shards · rows_b`` elements (``shard_update.region_rows``), and its
    row ``r`` (``rows_b`` elements, 128-byte aligned) is replica ``r``'s
    chunk of it.  A replica's chunks of all regions are what it owns under
    the chunked ZeRO levels (``owned``), ``shard`` elements in all."""

    def __init__(self, module: nn.Module, n_shards: int = 1, bucket_mb: float = 0.0):
        named = dict(module.named_parameters())
        if not named:
            raise ValueError("module has no parameters")
        device = next(iter(named.values())).device
        for name, p in named.items():
            if p.dtype != torch.float32 or p.device != device:
                raise ValueError(f"parameter {name} must be float32 on {device}")
        self.names: List[str] = sorted(named, key=lambda n: flax_param_path(n, named[n].dim()))
        params = [named[n] for n in self.names]
        self.shapes = [tuple(p.shape) for p in params]
        sizes = [p.numel() for p in params]
        # regions: (start, leaf elements, rows) of each bucket.
        self.offsets, self.regions, start = flat_layout(sizes, n_shards, bucket_mb)
        self.numel = sum(sizes)
        self.n_shards = n_shards
        self.shard = sum(rows for _, _, rows in self.regions)
        self.data = torch.zeros(start, dtype=torch.float32, device=device)
        self.grad = torch.zeros_like(self.data)
        self.resident = True
        with torch.no_grad():
            for p, view, gview in zip(params, self.views(self.data), self.views(self.grad)):
                view.copy_(p)
                p.data = view
                p.grad = gview

    def views(self, buf: torch.Tensor) -> List[torch.Tensor]:
        return [
            buf[o : o + _numel(s)].view(s) for o, s in zip(self.offsets, self.shapes)
        ]

    def named_views(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        return dict(zip(self.names, self.views(buf)))

    def segments(self) -> List[Tuple[int, int]]:
        """``(offset, numel)`` of each leaf, in flatten order."""
        return [(o, _numel(s)) for o, s in zip(self.offsets, self.shapes)]

    def buckets(self) -> List[Tuple[int, int]]:
        """``(start, elements)`` of each region of the buffers."""
        return [(start, self.n_shards * rows) for start, _, rows in self.regions]

    def owned(self, buf: torch.Tensor, index: int) -> List[torch.Tensor]:
        """Replica ``index``'s chunks of a buffer of this layout: row
        ``index`` of each region, views."""
        return [buf[start + index * rows : start + (index + 1) * rows]
                for start, _, rows in self.regions]

    def split_owned(self, owned: torch.Tensor) -> List[torch.Tensor]:
        """A replica's ``shard`` owned elements, cut into its chunks."""
        return list(owned.split([rows for _, _, rows in self.regions]))

    def gather_owned(self, buf: torch.Tensor, index: int) -> torch.Tensor:
        """A copy of replica ``index``'s chunks, concatenated."""
        return torch.cat(self.owned(buf, index))

    def put_owned(self, owned: torch.Tensor, buf: torch.Tensor, index: int) -> None:
        """Write replica ``index``'s concatenated chunks into ``buf``."""
        for dst, src in zip(self.owned(buf, index), self.split_owned(owned)):
            dst.copy_(src)

    def all_gather_(self, buf: torch.Tensor, role: str = "aux") -> torch.Tensor:
        """Fill every region of ``buf`` with every replica's chunk, one
        all-gather a region (each replica's own chunk in place); ``role``
        is the census' (``wire`` for a ZeRO level's params publish and
        gather)."""
        for start, size in self.buckets():
            mesh.all_gather_(buf[start : start + size], role=role)
        return buf

    def release(self) -> None:
        """Free the param buffer's memory; the parameters' views keep their
        storage, which :meth:`materialize` allocates again (uninitialised)."""
        if self.resident:
            self.data.untyped_storage().resize_(0)
            self.resident = False

    def materialize(self) -> None:
        if not self.resident:
            self.data.untyped_storage().resize_(self.data.numel() * self.data.element_size())
            self.resident = True


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


@dataclass
class TrainState:
    """The model (params + BatchNorm statistics), its flat buffers, the
    optimizer state (over the whole buffer, or over this replica's chunks
    where ``placement`` chunks the moments), the step count, the
    ``placement`` (``shard_update.StateLayout``: which kinds persist
    chunked), the nesting of optax's state for the optimizer
    (``Optimizer.layout``, what a checkpoint writes) and, where the
    placement chunks the params, ``owned``: this replica's chunks of the
    params, their only persistent copy."""

    model: nn.Module
    params: FlatParams
    opt_state: OptState
    placement: StateLayout
    step: int = 0
    layout: tuple = ("adam", "empty")
    owned: Optional[torch.Tensor] = None

    @property
    def level(self) -> str:
        """The ZeRO level the placement amounts to."""
        return self.placement.level

    def owned_params(self) -> List[torch.Tensor]:
        """This replica's chunks of the params the update writes."""
        if self.owned is not None:
            return self.params.split_owned(self.owned)
        return self.params.owned(self.params.data, mesh.replica_index())

    def gather_params(self) -> None:
        """Where the params persist chunked, make the param buffer resident
        and all-gather the replicas' chunks into it (every replica must
        call it); a no-op where the buffer is resident, which it stays
        until the next update."""
        flat = self.params
        if not self.placement.chunked["params"] or flat.resident:
            return
        flat.materialize()
        flat.put_owned(self.owned, flat.data, mesh.replica_index())
        flat.all_gather_(flat.data, role="wire")

    def release_params(self) -> None:
        """Where the params persist chunked, free the param buffer (its
        chunks stay owned)."""
        if self.placement.chunked["params"]:
            self.params.release()


def create_train_state(
    model: nn.Module, tx: Optimizer, axis_size: int = 1, level: str = "off",
    bucket_mb: float = 0.0,
) -> TrainState:
    """Flatten an initialized model (already on its device, the same
    weights on every replica) into a state for ``axis_size`` replicas at
    ZeRO ``level`` (one replica is ``off``), its buffers cut into the
    gradient buckets of ``bucket_mb``, placed as the level's rule table
    decides (``StateLayout``)."""
    flat = FlatParams(model, n_shards=axis_size, bucket_mb=bucket_mb)
    placement = StateLayout.from_flat(flat, tx.layout(), level)
    state = TrainState(model=model, params=flat, opt_state=None, placement=placement,
                       layout=tx.layout())
    if placement.chunked["params"]:
        state.owned = flat.gather_owned(flat.data, mesh.replica_index())
    if placement.chunked["opt_state"]:
        state.opt_state = tx.init(state.owned_params())
    else:
        state.opt_state = tx.init(flat.data)
    return state


def _nll_terms(logits: torch.Tensor, labels: torch.Tensor, train_head_layout: str):
    """``(nll, correct, valid)`` of :func:`loss_from_logits`, the mask
    broadcast to the NLL's shape."""
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
        r = labels.shape[-1] // logits.shape[-2]
        if (labels.shape[-2] != r * logits.shape[-3]
                or labels.shape[-1] != r * logits.shape[-2]):
            raise ValueError(
                f"grouped logits {tuple(logits.shape)} are not an integer r×r "
                f"regrouping of labels {tuple(labels.shape)}"
            )
        labels = group_labels(labels, r)
        logits = logits.reshape(*logits.shape[:-1], r * r, -1)
    nll, correct, valid = nll_correct_valid(logits, labels, ignore_index=-1)
    return nll, correct, valid.expand_as(nll)


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
    nll, correct, valid = _nll_terms(logits, labels, train_head_layout)
    denom = torch.clamp_min(valid.sum(), 1.0)
    return (nll * valid).sum() / denom, (correct * valid).sum() / denom


def spatial_loss_from_logits(
    logits: torch.Tensor, labels: torch.Tensor, train_head_layout: str = "fullres"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's share of the global batch's loss and accuracy on a
    ``data × space`` grid: its NLL and correct sums over the valid-pixel
    count of the whole (data, space) group, all-reduced.  The shares sum
    over the group to :func:`loss_from_logits` of the global batch.
    Grouped logits hold the stem grid's rows, laid out over the space
    group as ``halo.row_layout`` lays out that grid: the labels, in the
    input's even layout, are resharded to the same rows first (the
    identity where the space axis divides the stem grid)."""
    if train_head_layout == "grouped" and logits.shape[-2] != labels.shape[-1]:
        space = mesh.space_size()
        rows = labels.shape[-2] * space
        r = labels.shape[-1] // logits.shape[-2]
        labels = reshard(labels, row_layout(rows, space),
                         aligned(row_layout(rows, space), r), axis=-2)
    nll, correct, valid = _nll_terms(logits, labels, train_head_layout)
    count = mesh.all_reduce_(valid.sum().detach().reshape(1), "sum", "stage")[0]
    denom = torch.clamp_min(count, 1.0)
    return (nll * valid).sum() / denom, (correct * valid).sum() / denom


def _accumulate_grads(
    state: TrainState, images: torch.Tensor, labels: torch.Tensor, remat: bool = False,
    loss_fn: Callable = loss_from_logits,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward/backward over the ``A`` micro-batches of ``images [A,B,H,W,C]``,
    leaving the MEAN fp32 gradient in ``state.params.grad``.  Returns the
    per-micro-batch losses and accuracies ``[A]`` (on the device) of
    ``loss_fn``.
    ``remat`` keeps no activation between a micro-batch's forward and its
    backward, which recomputes the forward (under ``layers.recomputing``)."""
    model = state.model
    model.train()
    layout = getattr(model, "train_head_layout", "fullres")
    forward = model
    if remat:
        # Imported here: torch.utils.checkpoint loads torch._dynamo, whose
        # threads a run without remat has no use for.
        from torch.utils.checkpoint import checkpoint

        forward = functools.partial(
            checkpoint, model, use_reentrant=False,
            context_fn=lambda: (contextlib.nullcontext(), recomputing()),
        )
    state.params.grad.zero_()
    losses, accs = [], []
    for x, y in zip(images, labels):
        loss, acc = loss_fn(forward(x), y, layout)
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
    tx: Optimizer,
    compression: CompressionConfig,
    axis_size: int = 1,
    seed: int = 0,
    level: str = "off",
    remat: bool = False,
) -> Callable[[TrainState, torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]:
    """The train step: ``step(state, images [A,B,H,W,C], labels [A,B,H,W])``
    (``B`` this replica's micro-batch) updates ``state`` in place and
    returns ``{loss, pixel_acc, grad_norm}`` as device scalars (averaged
    over the A micro-batches and the replicas).  ``seed`` (``train.seed``)
    keys stochastic rounding together with ``state.step``.  ``level`` is
    the ZeRO level (or the historical bool; one replica runs ``off``), the
    state's own.  ``remat`` is ``train.remat``."""
    level = normalize_shard_update(level)
    if axis_size == 1:
        level = "off"
    chunked = LEVEL_CHUNKS[level]
    if chunked["grads"]:
        validate_scatter_compression(compression)
    else:
        check_supported(compression)
    if tx.grad_clip_norm and any(chunked.values()):
        raise ValueError(
            f"shard_update={level!r} cannot compose with grad_clip_norm > 0 — a "
            "clip by global norm inside the update would clip each replica's 1/N "
            "shard by its own partial norm, not the global norm; disable clipping"
        )

    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        if state.level != level:
            raise ValueError(f"a {state.level} state given to a {level} step")
        state.gather_params()
        losses, accs = _accumulate_grads(state, images, labels, remat)
        mean_batch_stats(state.model, axis_size)
        sq = sync_and_update(state, tx, compression, axis_size, seed)
        # One reduce for the logged metrics: the replicas' summed loss and
        # accuracy (then their mean) and, under zero2/zero3, the chunks'
        # squared norms (then the root of their sum).
        metrics = torch.stack([losses.mean(), accs.mean()] + ([] if sq is None else [sq]))
        if axis_size > 1:
            mesh.all_reduce_(metrics)
            metrics[:2] /= axis_size
        return {
            "loss": metrics[0],
            "pixel_acc": metrics[1],
            "grad_norm": grad_norm(state.params.grad) if sq is None else metrics[2].sqrt(),
        }

    return step


def sync_and_update(
    state: TrainState, tx: Optimizer, compression: CompressionConfig, axis_size: int,
    seed: int,
) -> Optional[torch.Tensor]:
    """The step's tail after backward, as the state's placement has it:
    the gradient sync over the data axis (the mean gradient of
    ``state.params.grad``; a reduce-scatter where the gradients persist
    chunked), the update, the publish (none where the params persist
    chunked), the step count.  Returns the squared norm of this replica's
    chunks of the mean where the gradients are chunked (to be summed over
    the replicas), else None (the whole mean is in ``params.grad``).  The
    pipeline's stage update runs it on the stage's data group."""
    flat, placement = state.params, state.placement
    key = _rounding_rng(compression, seed, state.step)
    grads = sync_for_level(flat.grad, compression, axis_size, placement.chunked["grads"], key=key,
                           buckets=flat.buckets(), n_elements=flat.numel)
    mesh.note_grads([flat.grad] if grads is None else grads)
    sq = None
    if grads is not None:
        tx.update(grads, state.opt_state, state.owned_params())
        if placement.chunked["params"]:
            state.release_params()
        else:
            flat.all_gather_(flat.data, role="wire")
        sq = torch.stack([torch.linalg.vector_norm(g) for g in grads]).square().sum()
    elif placement.chunked["opt_state"]:
        index = mesh.replica_index()
        tx.update(flat.owned(flat.grad, index), state.opt_state, state.owned_params())
        flat.all_gather_(flat.data, role="wire")
    else:
        tx.update(flat.grad, state.opt_state, flat.data, segments=flat.segments())
    state.step += 1
    return sq


def check_spatial_compression(compression: CompressionConfig) -> None:
    """The JAX GSPMD step's refusals, in its words: it has no per-replica
    gradient, so no ``quantize_local`` and no ring."""
    check_supported(compression)
    if compression.mode != "none" and not compression.quantize_mean:
        raise ValueError(
            "the GSPMD step cannot represent quantize_local-only compression "
            "(there is no per-replica gradient in the program): set "
            "compression.quantize_mean=True, or mode='none', or use a pure "
            "data mesh for reference-parity codec semantics"
        )
    if compression.transport == "ring" and compression.mode != "none":
        raise ValueError(
            "transport='ring' requires explicit per-replica collectives — "
            "use the shard_map step (pure data mesh); the GSPMD partitioner "
            "owns the collectives in this path"
        )
    if compression.mode != "none" and compression.quantize_local:
        raise ValueError(
            "the GSPMD step cannot apply quantize_local (no per-replica "
            "gradient exists in the program — only the averaged gradient is "
            "representable): set compression.quantize_local=False to record "
            "the semantics that actually execute, or use a pure data mesh "
            "(shard_map step) for reference-parity two-point codec semantics"
        )


def codec_on_mean(flat: FlatParams, compression: CompressionConfig, key: Optional[int]) -> None:
    """The spatial step's codec: the JAX package's
    ``apply_codec_fenced_bucketed`` over the logical mean gradient in
    ``flat.grad``, in place — one fake-quantize a bucket region (its own
    max-abs, the step's key with the bucket's index folded in where there
    are several)."""
    if compression.mode == "none":
        return
    fq = resolve_codec_backend(compression)
    buckets = flat.buckets()
    for b, (start, size) in enumerate(buckets):
        region = flat.grad[start : start + size]
        draw = {}
        if key is not None:
            draw["key"] = key if len(buckets) == 1 else philox.fold_in(key, b)
        fq(region, compression, out=region, **draw)


def make_train_step_spatial(
    tx: Optimizer,
    compression: CompressionConfig,
    data_size: int,
    space_size: int,
    seed: int = 0,
    level: str = "off",
    remat: bool = False,
) -> Callable[[TrainState, torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]:
    """The train step on a ``data × space`` grid (``mesh.init_grid``):
    ``step(state, images [A,B,H/S,W,C], labels [A,B,H/S,W])``, this rank's
    rows of its data shard, updates ``state`` in place and returns the
    global batch's ``{loss, pixel_acc, grad_norm}``.  The model must be
    sharded (``models.shard_space``); ``level`` (resolved with
    ``spatial=True``) chunks the update over the data axis."""
    check_spatial_compression(compression)
    level = normalize_shard_update(level)
    if data_size == 1:
        level = "off"
    group = data_size * space_size

    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        if state.level != level:
            raise ValueError(f"a {state.level} state given to a {level} step")
        state.gather_params()
        losses, accs = _accumulate_grads(state, images, labels, remat, spatial_loss_from_logits)
        flat = state.params
        # Every rank's share of the gradient of the global loss, summed.
        mesh.all_reduce_(flat.grad, "sum", "stage")
        codec_on_mean(flat, compression, _rounding_rng(compression, seed, state.step))
        norm = grad_norm(flat.grad)
        placement = state.placement
        if not placement.chunked["opt_state"]:
            tx.update(flat.grad, state.opt_state, flat.data, segments=flat.segments())
        else:
            clip = tx.global_norm(flat.grad, flat.segments()) if tx.grad_clip_norm else None
            index = mesh.replica_index()
            tx.update(flat.owned(flat.grad, index), state.opt_state, state.owned_params(),
                      norm=clip)
            if placement.chunked["params"]:
                state.release_params()
            else:
                flat.all_gather_(flat.data)
        state.step += 1
        metrics = torch.stack([losses.mean(), accs.mean()])
        if group > 1:
            mesh.all_reduce_(metrics, "sum", "stage")
        return {"loss": metrics[0], "pixel_acc": metrics[1], "grad_norm": norm}

    return step


def make_eval_step(
    num_classes: int, axis_size: int = 1, axis: str = "data",
) -> Callable[[TrainState, torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]:
    """Eval step on a batch ``[B,H,W,C]``: summed confusion matrix, summed
    NLL and valid-pixel count (the caller sums over batches, divides once).
    With ``axis_size`` ranks in this rank's ``axis`` group, each evaluating
    its own columns of the batch (and, on a ``data × space`` grid, its own
    rows: ``axis='stage'``, the JAX package's ``make_eval_step_gspmd``),
    the three sums are summed over the group in one float64 all-reduce
    (where the JAX step ``psum``s them)."""

    @torch.no_grad()
    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        state.gather_params()
        state.model.eval()
        logits = state.model(images)
        nll_sum, count = softmax_cross_entropy_sum(logits, labels, ignore_index=-1)
        cm = confusion_from_logits(logits, labels, num_classes)
        if axis_size > 1:
            sums = torch.cat([cm.reshape(-1), nll_sum.reshape(1), count.reshape(1)]).double()
            mesh.all_reduce_(sums, "sum", axis)
            cm, nll_sum, count = sums[:-2].view_as(cm), sums[-2], sums[-1]
        return {"confusion": cm, "loss_sum": nll_sum, "pixel_count": count}

    return step
