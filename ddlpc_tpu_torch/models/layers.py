"""Building blocks of the model zoo, mirroring ``ddlpc_tpu/models/layers.py``.

Activations run NCHW inside; module and parameter names follow the flax
param tree (``DoubleConv_0/ConvNormAct_1/Norm_0/BatchNorm_0/...``) so that
``convert.py`` maps one onto the other by path.  The flax cast points are
written out, not left to autocast: every conv casts its input and kernel
(and bias) to the module's compute dtype, parameters and normalization
statistics stay float32.

flax's 'SAME' padding is not torch's ``padding=k//2`` once the stride is
2: flax pads ``max((ceil(H/s)−1)·s + (k−1)·d + 1 − H, 0)`` rows in all,
the top getting half rounded down and the bottom the rest (the same for
columns), so a 3×3 stride-2 conv on an even grid pads the bottom and the
right only.  :func:`same_pads` computes it; :class:`Conv` and
:func:`max_pool_same` pad with it explicitly.

H sharded over the ``space`` axis (``models.shard_space``): a conv with
``Conv.halo = (top, bottom)`` takes those rows from its neighbours
(``parallel/halo.py``, across several shards where a dilated conv reads
further than a shard's rows) and pads only W — ``(d, d)`` for a stride-1
conv of dilation ``d``, ``(0, 1)`` for a 3×3 stride-2 conv on an even
grid, ``(0, 0)`` for a strided 1×1 conv, which subsamples its own rows;
the 3×3/2 'SAME' max pool takes one row from below, ``-inf`` past the
global bottom (:func:`max_pool_same`); a bilinear ×r up-sampling takes
one clamped halo row a side (:func:`upsample`); BatchNorm reduces its
statistics over the stage's whole (data, space) group
(``BatchNorm.axis``), GroupNorm over the space group
(``GroupNorm.space``).  Every other op of the zoo (space-to-depth, the
2×2 pool, the 2×2 transposed conv, the 1×1 heads, depth-to-space,
``group_labels``) is row-local.

Uneven shards: the model's forward passes each op ``rows``, the global
rows of its input, whose layout over the space group is
``halo.row_layout(rows, S)``.  A stride-``n`` op (:class:`Conv`,
:func:`max_pool_2x2`, :func:`max_pool_same`, :func:`space_to_depth`) first
reshards its input to the boundaries rounded down to multiples of ``n``
(``halo.aligned``), so that it runs locally and leaves the layout of
``rows/n``; an up-sampling (:class:`UpBlock`, :func:`upsample`,
:func:`depth_to_space`) reshards its output to the layout of ``r·rows``,
which its skip or the labels hold.  Where ``S`` divides the rows both are
the identity.  BatchNorm and GroupNorm then sum their statistics over the
group and divide by the group's element count (equal shards keep the mean
of the ranks' means), and a rank with no rows of a level computes nothing
there (:func:`_rowless`) but joins every collective of it.  ``rows=None``
(the default) is the equal-shard layout.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F
from torch import nn

from ddlpc_tpu_torch.parallel import mesh
from ddlpc_tpu_torch.parallel.halo import (
    aligned,
    halo_exchange,
    reshard,
    row_layout,
    scaled,
)

BN_MOMENTUM = 0.9  # flax convention: running = m·running + (1−m)·batch
BN_EPSILON = 1e-5
GN_EPSILON = 1e-6  # flax nn.GroupNorm's default


def stat_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype flax takes statistics in: at least float32."""
    return torch.promote_types(x.dtype, torch.float32)


def _layout(rows):
    """The layout of ``rows`` global rows over this rank's space group, or
    None when the caller gave no rows or there is no space group."""
    return row_layout(rows, mesh.space_size()) if rows is not None and mesh.space_size() > 1 \
        else None


def _rowless(fn, x: torch.Tensor, rows: int) -> torch.Tensor:
    """``fn`` of a shard that holds no rows of this level (an empty range
    of an uneven layout), NCHW: ``fn`` runs on a stand-in of ``x`` with no
    batch and ``rows`` rows (enough for its window), which computes
    nothing but keeps the graph — so the rank's backward reaches every
    collective before it and its parameters' gradients are zeros — and
    the result is ``x``'s batch with no rows."""
    y = fn(x.reshape(0, x.shape[1], rows, x.shape[3]))
    return y.reshape(x.shape[0], y.shape[1], 0, y.shape[3])


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's default kernel init: truncated normal (±2σ) with variance
    1/fan_in, σ corrected for the truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class _AllReduceSum(torch.autograd.Function):
    """Sum over this rank's ``axis`` group (``mesh.all_reduce_``),
    differentiable: the backward sums the cotangents over the group too,
    which is what the JAX package's ``pmean`` transposes to inside
    ``shard_map(check=False)`` — each replica's gradient then holds every
    replica's loss's dependence on its own activations through the shared
    statistics."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, axis: str = "data") -> torch.Tensor:
        ctx.axis = axis
        return mesh.all_reduce_(x.clone(), "sum", axis)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return mesh.all_reduce_(g.clone(), "sum", ctx.axis), None


_RECOMPUTE = threading.local()


@contextlib.contextmanager
def recomputing():
    """Marks a forward as the backward's recomputation of one already run
    (``torch.utils.checkpoint``'s ``context_fn`` under ``train.remat``):
    BatchNorm's running statistics, which the first forward advanced, are
    not advanced again.  Per thread: the backward of CUDA tensors, and so
    the recompute, runs on the autograd engine's own thread."""
    prev = getattr(_RECOMPUTE, "on", False)
    _RECOMPUTE.on = True
    try:
        yield
    finally:
        _RECOMPUTE.on = prev


def batch_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    train: bool,
    axis_size: int = 1,
    axis: str = "data",
    rows: int | None = None,
) -> torch.Tensor:
    """flax ``nn.BatchNorm`` semantics over NCHW (statistics per channel).

    Train mode: float32 statistics with the fast variance E[x²]−E[x]²
    clipped at 0, and the running averages updated in place with flax's
    momentum (0.9 on the old value) and the *biased* batch variance — not
    ``nn.BatchNorm2d``'s rule (once a forward: not inside
    :func:`recomputing`).  With ``axis_size > 1`` (sync-BN) the batch
    mean and mean of squares are averaged over the ``axis`` group of that
    size in one reduce, as flax's ``axis_name`` does (``stage``, the
    (data, space) group, is the logical global batch of the JAX package's
    GSPMD step: each rank's own rows, equal counts).  ``rows``: H is
    sharded over the space group, ``rows`` global rows laid out by
    ``halo.row_layout``; where the ranks' rows differ (or some have none)
    each rank's sums are summed over the group and divided by the group's
    element count, ``axis_size / S`` data replicas of ``rows`` rows.
    Output in ``x.dtype``."""
    shape = (1, -1, 1, 1)
    if train:
        xf = x.to(stat_dtype(x))
        if axis_size > 1 and rows is not None and rows % mesh.space_size():
            count = axis_size // mesh.space_size() * x.shape[0] * rows * x.shape[3]
            sums = torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))])
            mean, mean2 = (_AllReduceSum.apply(sums, axis) / count).split(x.shape[1])
        else:
            mean = xf.mean(dim=(0, 2, 3))
            mean2 = (xf * xf).mean(dim=(0, 2, 3))
            if axis_size > 1:
                both = _AllReduceSum.apply(torch.cat([mean, mean2]), axis) / axis_size
                mean, mean2 = both.split(mean.numel())
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        if not getattr(_RECOMPUTE, "on", False):
            with torch.no_grad():
                running_mean.copy_(
                    BN_MOMENTUM * running_mean + (1 - BN_MOMENTUM) * mean.detach()
                )
                running_var.copy_(
                    BN_MOMENTUM * running_var + (1 - BN_MOMENTUM) * var.detach()
                )
    else:
        mean, var = running_mean, running_var
    mul = torch.rsqrt(var + BN_EPSILON) * weight
    y = (x - mean.view(shape)) * mul.view(shape) + bias.view(shape)
    return y.to(x.dtype)


class BatchNorm(nn.Module):
    """``axis_size > 1``: sync-BN over this rank's ``axis`` group, of that
    size (``models.build_model(norm_axis_size=)`` and
    ``models.shard_space`` set them)."""

    def __init__(self, features: int, axis_size: int = 1):
        super().__init__()
        self.axis_size = axis_size
        self.axis = "data"
        self.weight = nn.Parameter(torch.ones(features))  # flax 'scale'
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, rows: int | None = None) -> torch.Tensor:
        return batch_norm(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            self.training, self.axis_size, self.axis, rows,
        )


def group_norm(
    x: torch.Tensor, groups: int, weight: torch.Tensor, bias: torch.Tensor,
    space: int = 1, rows: int | None = None,
) -> torch.Tensor:
    """flax ``nn.GroupNorm`` over NCHW: float32 statistics per sample and
    group with the fast variance E[x²]−E[x]² clipped at 0, ε = 1e-6, the
    output in ``x.dtype``.  ``space > 1``: H is sharded over a space group
    of that size, and the statistics are averaged over it (equal rows a
    shard); where ``rows`` global rows do not divide by ``space``, the
    ranks' sums are summed and divided by the group's elements."""
    n, c = x.shape[:2]
    xf = x.to(stat_dtype(x)).reshape(n, groups, -1)
    if space > 1 and rows is not None and rows % space:
        sums = torch.stack([xf.sum(dim=-1), (xf * xf).sum(dim=-1)])
        both = _AllReduceSum.apply(sums, "space") / (c // groups * rows * x.shape[3])
        mean, mean2 = both[0], both[1]
    else:
        mean = xf.mean(dim=-1)
        mean2 = (xf * xf).mean(dim=-1)
        if space > 1:
            both = _AllReduceSum.apply(torch.stack([mean, mean2]), "space") / space
            mean, mean2 = both[0], both[1]
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    per = c // groups
    mean = mean.repeat_interleave(per, dim=1)
    mul = torch.rsqrt(var + GN_EPSILON).repeat_interleave(per, dim=1) * weight
    y = (x - mean.view(n, c, 1, 1)) * mul.view(n, c, 1, 1) + bias.view(1, c, 1, 1)
    return y.to(x.dtype)


class GroupNorm(nn.Module):
    def __init__(self, features: int, groups: int):
        super().__init__()
        self.groups = groups
        self.space = 1
        self.weight = nn.Parameter(torch.ones(features))  # flax 'scale'
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, rows: int | None = None) -> torch.Tensor:
        return group_norm(x, self.groups, self.weight, self.bias, self.space, rows)


class Norm(nn.Module):
    """The reference's pluggable norm: ``batch`` (sync-BN through
    ``BatchNorm.axis_size``), ``group`` (the group count lowered until it
    divides the channels) or ``none`` (no parameters; the conv before it
    then has a bias)."""

    def __init__(self, features: int, kind: str = "batch", groups: int = 8):
        super().__init__()
        self.kind = kind
        if kind == "batch":
            self.BatchNorm_0 = BatchNorm(features)
        elif kind == "group":
            groups = min(groups, features)
            while features % groups:
                groups -= 1
            self.GroupNorm_0 = GroupNorm(features, groups)
        elif kind != "none":
            raise ValueError(f"unknown norm kind {kind!r}")

    def forward(self, x: torch.Tensor, rows: int | None = None) -> torch.Tensor:
        if self.kind == "batch":
            return self.BatchNorm_0(x, rows)
        if self.kind == "group":
            return self.GroupNorm_0(x, rows)
        return x


def same_pads(size: int, kernel: int, stride: int = 1, dilation: int = 1):
    """flax/XLA 'SAME' padding of one spatial dim: ``(before, after)``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` with 'SAME' padding (:func:`same_pads`), any stride
    and dilation: weight OIHW float32, computed in ``dtype``.  ``halo =
    (top, bottom)`` (H sharded over the space axis, :func:`space_halo`):
    the input takes those rows of its neighbours (``parallel/halo.py``,
    multi-hop) in place of 'SAME''s padding of H and is padded along W
    only; ``(0, 0)`` marks a sharded strided 1×1 conv.  ``rows`` (the
    input's global rows): a strided conv first reshards its input to the
    stride's phase (``halo.aligned``); without them the local rows must
    divide by the stride."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel: int,
        dtype: torch.dtype,
        use_bias: bool = True,
        generator: torch.Generator | None = None,
        stride: int = 1,
        dilation: int = 1,
    ):
        super().__init__()
        self.dtype = dtype
        self.kernel = kernel
        self.stride = stride
        self.dilation = dilation
        self.halo = 0
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        lecun_normal_(self.weight, in_features * kernel * kernel, generator)

    def forward(self, x: torch.Tensor, rows: int | None = None) -> torch.Tensor:
        k, s, d = self.kernel, self.stride, self.dilation
        x = x.to(self.dtype)
        layout = _layout(rows)
        if self.halo:
            # A shard's output rows are the global ones only if every shard
            # starts on the stride's phase.
            if layout is not None and s > 1:
                x = reshard(x, layout, aligned(layout, s))
                layout = aligned(layout, s)
            elif x.shape[2] % s:
                raise ValueError(
                    f"a stride-{s} conv under the space axis on {x.shape[2]} rows a "
                    f"shard: the rows must divide by the stride (pass the input's "
                    f"global rows)"
                )
            x = halo_exchange(x, self.halo, multi_hop=True, layout=layout)
        if k == 1 and s > 1:
            # The same conv on the subsampled grid ('SAME' pads a 1×1 conv
            # nowhere).  PyTorch's CPU (oneDNN) backward of a strided 1×1
            # conv on a channels-last input corrupts the heap (torch 2.13).
            x, s = x[:, :, ::s, ::s], 1
        if x.shape[2] == 0:
            return _rowless(lambda t: self._conv(t, s), x, (k - 1) * d + 1)
        return self._conv(x, s)

    def _conv(self, x: torch.Tensor, s: int) -> torch.Tensor:
        k, d = self.kernel, self.dilation
        (top, bottom), (left, right) = (same_pads(n, k, s, d) for n in x.shape[2:])
        if self.halo:
            top = bottom = 0  # the halo is H's padding
        if top == bottom and left == right:
            pad = (top, left)
        else:  # stride 2 on an even grid: flax pads the bottom and right only
            x = F.pad(x, (left, right, top, bottom))
            pad = 0
        y = F.conv2d(x, self.weight.to(self.dtype), stride=s, padding=pad, dilation=d)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype).view(1, -1, 1, 1)
        return y


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(kernel 2×2, stride 2, 'SAME')`` with bias.

    flax keeps the kernel as ``(kh, kw, in, out)`` and does not flip it
    (``transpose_kernel=False``); torch's transposed conv uses the kernel
    flipped.  The weight here is stored the torch way, ``(in, out, kh, kw)``,
    already flipped (``convert.py`` does the flip)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        dtype: torch.dtype,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(in_features, features, 2, 2))
        self.bias = nn.Parameter(torch.zeros(features))
        lecun_normal_(self.weight, in_features * 4, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[2] == 0:
            return _rowless(self.forward, x, 1)
        y = F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype), stride=2)
        return y + self.bias.to(self.dtype).view(1, -1, 1, 1)


class ConvNormAct(nn.Module):
    """conv (``kernel_size``, ``stride``, ``dilation``; a bias only under
    ``norm='none'``) → norm → ReLU."""

    def __init__(self, in_features, features, dtype, norm="batch", generator=None,
                 norm_groups=8, kernel_size=3, stride=1, dilation=1):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, kernel_size, dtype,
                           use_bias=norm == "none", generator=generator,
                           stride=stride, dilation=dilation)
        self.Norm_0 = Norm(features, norm, norm_groups)

    def forward(self, x: torch.Tensor, rows: int | None = None) -> torch.Tensor:
        out = None if rows is None else rows // self.Conv_0.stride
        return F.relu(self.Norm_0(self.Conv_0(x, rows), out))


class DoubleConv(nn.Module):
    """(Conv3×3 → norm → ReLU) ×2."""

    def __init__(self, in_features, features, dtype, norm="batch", generator=None,
                 norm_groups=8):
        super().__init__()
        self.ConvNormAct_0 = ConvNormAct(in_features, features, dtype, norm, generator,
                                         norm_groups)
        self.ConvNormAct_1 = ConvNormAct(features, features, dtype, norm, generator,
                                         norm_groups)

    def forward(self, x: torch.Tensor, rows: int | None = None) -> torch.Tensor:
        return self.ConvNormAct_1(self.ConvNormAct_0(x, rows), rows)


def max_pool_2x2(x: torch.Tensor, rows: int | None = None) -> torch.Tensor:
    """The 2×2/2 max pool; ``rows`` (H sharded over the space axis, the
    input's global rows): first reshard to even boundaries."""
    layout = _layout(rows)
    if layout is not None:
        x = reshard(x, layout, aligned(layout, 2))
    if x.shape[2] == 0:
        return _rowless(max_pool_2x2, x, 2)
    return F.max_pool2d(x, 2, 2)


def space_halo(kernel: int, stride: int = 1, dilation: int = 1) -> tuple:
    """The ``(top, bottom)`` rows a shard of an H-sharded 'SAME' window
    reads from its neighbours, for local rows that divide by the stride:
    flax's pads of the whole H (:func:`same_pads`, which then depend on
    nothing but the window), so ``(d·(k//2),) * 2`` at stride 1 and
    ``(0, 1)`` for 3×3/2."""
    return same_pads(stride, kernel, stride, dilation)


def max_pool_same(x: torch.Tensor, kernel: int = 3, stride: int = 2,
                  space: int = 1, rows: int | None = None) -> torch.Tensor:
    """flax ``nn.max_pool(x, (k, k), strides=(s, s), padding='SAME')``: the
    'SAME' pads filled with −inf (:func:`same_pads`; bottom and right only
    for 3×3/2 on an even grid).  ``space > 1``: H is sharded over a space
    group of that size; the shard takes its window's rows from its
    neighbours (:func:`space_halo`), ``-inf`` past the global edges, as
    the unsharded pad (zeros would give the same forward on post-ReLU
    input, but route a tie's gradient otherwise).  ``rows``, the input's
    global rows: the input is first resharded to the stride's phase; without
    them the local rows must divide by the stride."""
    if space > 1:
        layout = _layout(rows)
        if layout is not None:
            x = reshard(x, layout, aligned(layout, stride))
            layout = aligned(layout, stride)
        elif x.shape[2] % stride:
            raise ValueError(
                f"a stride-{stride} max pool under the space axis on {x.shape[2]} rows a "
                f"shard: the rows must divide by the stride (pass the input's global rows)"
            )
        x = halo_exchange(x, space_halo(kernel, stride), edge="-inf", multi_hop=True,
                          layout=layout)
        if x.shape[2] == 0:
            return _rowless(lambda t: max_pool_same(t, kernel, stride), x, kernel)
        top = bottom = 0
        left, right = same_pads(x.shape[3], kernel, stride)
    else:
        (top, bottom), (left, right) = (same_pads(n, kernel, stride) for n in x.shape[2:])
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, kernel, stride)


def rows_first(h: int, w: int, out_h: int, out_w: int) -> bool:
    """Whether ``jnp.einsum`` contracts the rows first when resizing
    ``(h, w)`` to ``(out_h, out_w)``: the cheaper order, the rows on a tie."""
    return h * w * out_h + out_h * w * out_w <= h * w * out_w + h * out_w * out_h


def resize_bilinear(x: torch.Tensor, size, rows: bool | None = None) -> torch.Tensor:
    """``jax.image.resize(x, ..., 'bilinear')`` for an up-sampling
    ``size = (H, W)``, NCHW, in ``x.dtype``.

    JAX's triangle kernel renormalizes the taps that fall off the edge,
    which is ``align_corners=False``'s clamp.  JAX contracts one dimension
    at a time, each a dot that rounds to the input dtype, in the order
    ``jnp.einsum`` finds cheaper (:func:`rows_first`; ``rows`` overrides
    it, for a shard that must take its whole array's order); one pass a
    dimension in that order gives JAX's bf16 bits wherever the scale's
    weights are exact in bf16 (a power of two).  JAX anti-aliases when it
    down-samples, which bilinear ``F.interpolate`` does not: refused."""
    h, w = x.shape[2:]
    out_h, out_w = size
    if out_h < h or out_w < w:
        raise ValueError(
            f"resize_bilinear from {(h, w)} to {(out_h, out_w)} down-samples; "
            f"jax.image.resize anti-aliases there and this port does not"
        )
    if rows is None:
        rows = rows_first(h, w, out_h, out_w)
    for step in ((out_h, w), (out_h, out_w)) if rows else ((h, out_w), (out_h, out_w)):
        if step != tuple(x.shape[2:]):
            x = F.interpolate(x, size=step, mode="bilinear", align_corners=False)
    return x


def upsample(x: torch.Tensor, r: int, space: int = 1, rows: int | None = None) -> torch.Tensor:
    """×``r`` bilinear up-sampling of NCHW (:func:`resize_bilinear`).
    ``space > 1``: H is sharded over a space group of that size, and each
    rank holds its rows.  The shard takes one halo row a side, clamped at
    the global edges (``halo_exchange(edge="clamp")``), resizes its
    ``h + 2`` rows in the whole array's pass order and drops ``r`` output
    rows at each end: under ``align_corners=False`` output row ``r·k + j``
    sits at input coordinate ``k + (j + 0.5)/r − 0.5``, between rows
    ``k − 1`` and ``k + 1``, so the rows kept are the unsharded resize's
    rows of this shard, each from the same two rows with the same weights,
    and at the global edges the clamped row weighs what the edge clamp
    gives it.  ``rows``, the input's global rows (None: ``space`` equal
    shards): the halo rows come from the ranks that hold them, and the
    output is resharded to the layout of ``r·rows`` rows."""
    h, w = x.shape[2:]
    if space <= 1:
        return resize_bilinear(x, (r * h, r * w))
    total = h * space if rows is None else rows
    layout = _layout(rows)
    order = rows_first(total, w, r * total, r * w)
    x = halo_exchange(x, 1, edge="clamp", layout=layout)
    if x.shape[2] == 0:
        y = _rowless(lambda t: resize_bilinear(t, (r, r * w), order), x, 1)
    else:
        y = resize_bilinear(x, (r * (h + 2), r * w), order)[:, :, r : r * (h + 1)]
    if layout is not None:
        y = reshard(y, scaled(layout, r), row_layout(r * rows, space))
    return y


def upsample_2x(x: torch.Tensor, space: int = 1, rows: int | None = None) -> torch.Tensor:
    """2× bilinear up-sampling of NCHW, sharded over H where ``space > 1``
    (:func:`upsample`)."""
    return upsample(x, 2, space, rows)


class DownBlock(nn.Module):
    """DoubleConv then 2× max pool; returns (downsampled, skip)."""

    def __init__(self, in_features, features, dtype, norm="batch", generator=None,
                 norm_groups=8):
        super().__init__()
        self.DoubleConv_0 = DoubleConv(in_features, features, dtype, norm, generator,
                                       norm_groups)

    def forward(self, x: torch.Tensor, rows: int | None = None):
        skip = self.DoubleConv_0(x, rows)
        return max_pool_2x2(skip, rows), skip


class UpBlock(nn.Module):
    """2× upsample (transposed conv or bilinear), concat ``[*skips, x]``,
    DoubleConv.  ``skip_features`` counts the channels of all the skips.
    ``space > 1`` (``models.shard_space`` sets it): H is sharded over a
    space group of that size, which the bilinear resize takes a halo from."""

    def __init__(self, in_features, skip_features, features, dtype, norm="batch",
                 generator=None, up_sample_mode="conv_transpose", norm_groups=8):
        super().__init__()
        if up_sample_mode == "conv_transpose":
            self.ConvTranspose_0 = ConvTranspose(in_features, features, dtype, generator)
            up_features = features
        elif up_sample_mode == "bilinear":
            up_features = in_features
        else:
            raise ValueError(f"unknown up_sample_mode {up_sample_mode!r}")
        self.up_sample_mode = up_sample_mode
        self.space = 1
        self.DoubleConv_0 = DoubleConv(
            skip_features + up_features, features, dtype, norm, generator, norm_groups
        )

    def forward(self, x: torch.Tensor, skips: list, phase: str = "all",
                rows: int | None = None) -> torch.Tensor:
        """``phase`` is for pipeline stages (``parallel/pipeline.py``):
        ``'up'`` runs the up-sampling and the concat only, ``'conv'`` the
        DoubleConv only on what ``'up'`` returned, ``'all'`` both.
        ``rows``: the input's global rows (H sharded over the space axis);
        the up-sampled rows are resharded to the skips' layout."""
        if phase not in ("all", "up", "conv"):
            raise ValueError(f"unknown UpBlock phase {phase!r}")
        if phase in ("all", "up"):
            if self.up_sample_mode == "conv_transpose":
                x = self.ConvTranspose_0(x)
                layout = _layout(rows)
                if layout is not None:
                    x = reshard(x, scaled(layout, 2), _layout(2 * rows))
            else:
                x = upsample_2x(x, self.space, rows)
            x = torch.cat([*skips, x], dim=1)
            if phase == "up":
                return x
        return self.DoubleConv_0(x, None if rows is None else 2 * rows)


def space_to_depth(x: torch.Tensor, r: int, rows: int | None = None) -> torch.Tensor:
    """NCHW [B,C,H,W] → [B,C·r²,H/r,W/r] with the reference's channel order:
    channel ``(dy·r + dx)·C + c`` holds pixel ``(r·i + dy, r·j + dx)`` of
    channel c — the NHWC ``layers.space_to_depth`` seen through NCHW.
    ``rows`` (H sharded over the space axis, the input's global rows): the
    input is first resharded to the factor's phase."""
    layout = _layout(rows)
    if layout is not None:
        x = reshard(x, layout, aligned(layout, r))
    b, c, h, w = x.shape
    if h % r or w % r:
        raise ValueError(f"spatial dims {(h, w)} not divisible by r={r}")
    x = x.reshape(b, c, h // r, r, w // r, r)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(b, r * r * c, h // r, w // r)


def depth_to_space(x: torch.Tensor, r: int, rows: int | None = None) -> torch.Tensor:
    """Inverse of :func:`space_to_depth` — the subpixel head.  ``rows``
    (H sharded over the space axis, the input's global rows): the output
    is resharded to the layout of ``r·rows`` rows."""
    b, cr, h, w = x.shape
    if cr % (r * r):
        raise ValueError(f"channels {cr} not divisible by r²={r * r}")
    c = cr // (r * r)
    x = x.reshape(b, r, r, c, h, w)
    y = x.permute(0, 3, 4, 1, 5, 2).reshape(b, c, h * r, w * r)
    layout = _layout(rows)
    if layout is not None:
        y = reshard(y, scaled(layout, r), _layout(r * rows))
    return y


class DetailHead(nn.Module):
    """Full-resolution residual refinement for subpixel heads:
    ``logits += Conv3x3(classes)·relu·Conv3x3(hidden)(logits ++ image)``,
    the hidden conv in the compute dtype, the delta conv in the head dtype."""

    def __init__(self, num_classes, image_channels, hidden, dtype, head_dtype,
                 generator=None):
        super().__init__()
        self.dtype = dtype
        self.head_dtype = head_dtype
        self.Conv_0 = Conv(num_classes + image_channels, hidden, 3, dtype,
                           generator=generator)
        self.Conv_1 = Conv(hidden, num_classes, 3, head_dtype, generator=generator)

    def forward(self, logits: torch.Tensor, image: torch.Tensor,
                rows: int | None = None) -> torch.Tensor:
        z = torch.cat([logits.to(self.dtype), image.to(self.dtype)], dim=1)
        z = F.relu(self.Conv_0(z, rows))
        return logits + self.Conv_1(z.to(self.head_dtype), rows)


class StemGridDetailHead(nn.Module):
    """Residual refinement at the stem grid (``detail_head_kind='s2d'``):
    ``z += Conv3x3(C·r²)·relu·Conv3x3(hidden)(z ++ s2d(image))`` on the
    pre-depth-to-space logits ``z``, the hidden conv in the compute dtype,
    the delta conv in the head dtype."""

    def __init__(self, num_classes, image_channels, stem_factor, hidden, dtype,
                 head_dtype, generator=None):
        super().__init__()
        r = stem_factor
        self.r = r
        self.dtype = dtype
        self.head_dtype = head_dtype
        self.Conv_0 = Conv((num_classes + image_channels) * r * r, hidden, 3, dtype,
                           generator=generator)
        self.Conv_1 = Conv(hidden, num_classes * r * r, 3, head_dtype, generator=generator)

    def forward(self, z: torch.Tensor, image: torch.Tensor,
                rows: int | None = None) -> torch.Tensor:
        """``rows``: the stem grid's global rows (the image has ``r`` times
        as many)."""
        image_rows = None if rows is None else rows * self.r
        zin = torch.cat([z.to(self.dtype), space_to_depth(image.to(self.dtype), self.r,
                                                           image_rows)], dim=1)
        y = F.relu(self.Conv_0(zin, rows))
        return z + self.Conv_1(y.to(self.head_dtype), rows)


def group_labels(labels: torch.Tensor, r: int) -> torch.Tensor:
    """``[..., H, W]`` labels → ``[..., H/r, W/r, r²]``, phase-major: the
    order of the pre-depth-to-space logits' ``r²·C`` channels, so that the
    ``[..., r², C]`` view pairs phase p's class row with phase p's label."""
    *lead, h, w = labels.shape
    if h % r or w % r:
        raise ValueError(f"spatial dims {(h, w)} not divisible by r={r}")
    x = labels.reshape(*lead, h // r, r, w // r, r).movedim(-3, -2)
    return x.reshape(*lead, h // r, w // r, r * r)
