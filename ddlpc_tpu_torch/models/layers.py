"""Building blocks of the U-Net, mirroring ``ddlpc_tpu/models/layers.py``.

Activations run NCHW inside; module and parameter names follow the flax
param tree (``DoubleConv_0/ConvNormAct_1/Norm_0/BatchNorm_0/...``) so that
``convert.py`` maps one onto the other by path.  The flax cast points are
written out, not left to autocast: every conv casts its input and kernel
(and bias) to the module's compute dtype, parameters and BatchNorm
statistics stay float32.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM = 0.9  # flax convention: running = m·running + (1−m)·batch
BN_EPSILON = 1e-5


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's default kernel init: truncated normal (±2σ) with variance
    1/fan_in, σ corrected for the truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the process group, differentiable: the backward sums the
    cotangents over the group too, which is what the JAX package's
    ``pmean`` transposes to inside ``shard_map(check=False)`` — each
    replica's gradient then holds every replica's loss's dependence on its
    own activations through the shared statistics."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        g = g.clone()
        dist.all_reduce(g)
        return g


def batch_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    train: bool,
    axis_size: int = 1,
) -> torch.Tensor:
    """flax ``nn.BatchNorm`` semantics over NCHW (statistics per channel).

    Train mode: float32 statistics with the fast variance E[x²]−E[x]²
    clipped at 0, and the running averages updated in place with flax's
    momentum (0.9 on the old value) and the *biased* batch variance — not
    ``nn.BatchNorm2d``'s rule.  With ``axis_size > 1`` (sync-BN) the batch
    mean and mean of squares are averaged over the process group of that
    size in one reduce, as flax's ``axis_name`` does.  Output in
    ``x.dtype``."""
    shape = (1, -1, 1, 1)
    if train:
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        mean2 = (xf * xf).mean(dim=(0, 2, 3))
        if axis_size > 1:
            both = _AllReduceSum.apply(torch.cat([mean, mean2])) / axis_size
            mean, mean2 = both.split(mean.numel())
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
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
    """``axis_size > 1``: sync-BN over a process group of that size
    (``models.build_model(norm_axis_size=)`` sets it)."""

    def __init__(self, features: int, axis_size: int = 1):
        super().__init__()
        self.axis_size = axis_size
        self.weight = nn.Parameter(torch.ones(features))  # flax 'scale'
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            self.training, self.axis_size,
        )


class Norm(nn.Module):
    """The reference's pluggable norm; this slice ports ``kind='batch'``."""

    def __init__(self, features: int, kind: str = "batch"):
        super().__init__()
        if kind != "batch":
            raise NotImplementedError(f"norm={kind!r} is not yet ported")
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.BatchNorm_0(x)


class Conv(nn.Module):
    """flax ``nn.Conv`` with 'SAME' padding at stride 1 (odd kernels):
    weight OIHW float32, computed in ``dtype``."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel: int,
        dtype: torch.dtype,
        use_bias: bool = True,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.padding = (kernel - 1) // 2
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        lecun_normal_(self.weight, in_features * kernel * kernel, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), padding=self.padding)
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
        y = F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype), stride=2)
        return y + self.bias.to(self.dtype).view(1, -1, 1, 1)


class ConvNormAct(nn.Module):
    """3×3 conv (no bias under batch norm) → norm → ReLU."""

    def __init__(self, in_features, features, dtype, norm="batch", generator=None):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, 3, dtype, use_bias=False,
                           generator=generator)
        self.Norm_0 = Norm(features, norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.Norm_0(self.Conv_0(x)))


class DoubleConv(nn.Module):
    """(Conv3×3 → norm → ReLU) ×2."""

    def __init__(self, in_features, features, dtype, norm="batch", generator=None):
        super().__init__()
        self.ConvNormAct_0 = ConvNormAct(in_features, features, dtype, norm, generator)
        self.ConvNormAct_1 = ConvNormAct(features, features, dtype, norm, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ConvNormAct_1(self.ConvNormAct_0(x))


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


class DownBlock(nn.Module):
    """DoubleConv then 2× max pool; returns (downsampled, skip)."""

    def __init__(self, in_features, features, dtype, norm="batch", generator=None):
        super().__init__()
        self.DoubleConv_0 = DoubleConv(in_features, features, dtype, norm, generator)

    def forward(self, x: torch.Tensor):
        skip = self.DoubleConv_0(x)
        return max_pool_2x2(skip), skip


class UpBlock(nn.Module):
    """Transposed-conv 2× upsample, concat ``[skip, x]``, DoubleConv."""

    def __init__(self, in_features, skip_features, features, dtype, norm="batch",
                 generator=None):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose(in_features, features, dtype, generator)
        self.DoubleConv_0 = DoubleConv(
            skip_features + features, features, dtype, norm, generator
        )

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = torch.cat([skip, self.ConvTranspose_0(x)], dim=1)
        return self.DoubleConv_0(x)


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """NCHW [B,C,H,W] → [B,C·r²,H/r,W/r] with the reference's channel order:
    channel ``(dy·r + dx)·C + c`` holds pixel ``(r·i + dy, r·j + dx)`` of
    channel c — the NHWC ``layers.space_to_depth`` seen through NCHW."""
    b, c, h, w = x.shape
    if h % r or w % r:
        raise ValueError(f"spatial dims {(h, w)} not divisible by r={r}")
    x = x.reshape(b, c, h // r, r, w // r, r)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(b, r * r * c, h // r, w // r)


def depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    """Inverse of :func:`space_to_depth` — the subpixel head."""
    b, cr, h, w = x.shape
    if cr % (r * r):
        raise ValueError(f"channels {cr} not divisible by r²={r * r}")
    c = cr // (r * r)
    x = x.reshape(b, r, r, c, h, w)
    return x.permute(0, 3, 4, 1, 5, 2).reshape(b, c, h * r, w * r)


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

    def forward(self, logits: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
        z = torch.cat([logits.to(self.dtype), image.to(self.dtype)], dim=1)
        z = F.relu(self.Conv_0(z))
        return logits + self.Conv_1(z.to(self.head_dtype))
