"""DeepLabV3+ (atrous convolutions, ASPP, a light decoder), mirroring
``ddlpc_tpu/models/deeplabv3p.py``.

A stride-2 3×3 stem and a 3×3/2 'SAME' max pool (both padded as flax
pads: the bottom and right on an even grid, ``layers.same_pads``), four
stages of residual blocks whose last one (two at ``output_stride`` 8)
dilates instead of striding, ASPP with an image-pool branch, and a decoder
that up-samples bilinearly to the stride-4 features and the logits to the
input.  Names are flax's (``ConvNormAct_0``, ``stage{s}_block{b}``,
``ASPP_0``, …; inside a block ``Conv_0``/``Norm_0`` … in creation order).

H sharded over the space axis (``models.shard_space`` sets ``space`` here
and in ``ASPP``): every 3×3 conv takes its halo (one-sided for the
stride-2 ones, up to ``dilation`` rows and several shards for the dilated
ones, ``layers.Conv``), the stem's pool one ``-inf``-filled row from below
(``layers.max_pool_same``), the image pool a sum over the space group,
and both decoder resizes one clamped row a side (``layers.upsample``).
The forward passes each layer its input's global rows: where the space
axis does not divide a level's rows, a stride-2 layer reshards its input
to even boundaries and a resize its output to the next level's layout
(``models/layers.py``), and the image pool divides by the global rows.
The height must be a multiple of the output stride
(``models.check_space_rows``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ddlpc_tpu_torch.models.layers import (
    Conv,
    ConvNormAct,
    Norm,
    _AllReduceSum,
    max_pool_same,
    resize_bilinear,
    stat_dtype,
    upsample,
)


class ResidualBlock(nn.Module):
    """Two 3×3 convs (the first strided, both dilated), a 1×1 strided
    projection shortcut where the shape changes; no conv has a bias."""

    def __init__(self, in_features, features, dtype, stride=1, dilation=1, norm="batch",
                 norm_groups=8, generator=None):
        super().__init__()
        conv = dict(use_bias=False, generator=generator)
        self.Conv_0 = Conv(in_features, features, 3, dtype, stride=stride,
                           dilation=dilation, **conv)
        self.Norm_0 = Norm(features, norm, norm_groups)
        self.Conv_1 = Conv(features, features, 3, dtype, dilation=dilation, **conv)
        self.Norm_1 = Norm(features, norm, norm_groups)
        self.project = in_features != features or stride != 1
        if self.project:
            self.Conv_2 = Conv(in_features, features, 1, dtype, stride=stride, **conv)
            self.Norm_2 = Norm(features, norm, norm_groups)

    def forward(self, x: torch.Tensor, rows: int | None = None) -> torch.Tensor:
        """``rows``: the input's global rows under the space axis."""
        out = None if rows is None else rows // self.Conv_0.stride
        y = F.relu(self.Norm_0(self.Conv_0(x, rows), out))
        y = self.Norm_1(self.Conv_1(y, out), out)
        shortcut = self.Norm_2(self.Conv_2(x, rows), out) if self.project else x
        return F.relu(y + shortcut)


class ASPP(nn.Module):
    """1×1 and dilated 3×3 branches and an image-pool branch (a mean over
    the grid, a 1×1 ConvNormAct on the 1×1 grid, broadcast back), fused by
    a 1×1 ConvNormAct.  ``space > 1``: H is sharded over a space group of
    that size, and the mean takes every shard's rows."""

    def __init__(self, in_features, features, rates: Sequence[int], dtype, norm="batch",
                 norm_groups=8, generator=None):
        super().__init__()
        common = dict(norm=norm, generator=generator, norm_groups=norm_groups)
        self.n_rates = len(rates)
        self.ConvNormAct_0 = ConvNormAct(in_features, features, dtype, kernel_size=1, **common)
        for k, rate in enumerate(rates):
            self.add_module(f"ConvNormAct_{k + 1}",
                            ConvNormAct(in_features, features, dtype, dilation=rate, **common))
        self.add_module(f"ConvNormAct_{len(rates) + 1}",
                        ConvNormAct(in_features, features, dtype, kernel_size=1, **common))
        self.add_module(f"ConvNormAct_{len(rates) + 2}",
                        ConvNormAct(features * (len(rates) + 2), features, dtype,
                                    kernel_size=1, **common))
        self.dtype = dtype
        self.space = 1

    def forward(self, x: torch.Tensor, rows: int | None = None) -> torch.Tensor:
        """``rows``: the input's global rows under the space axis (None:
        ``space`` equal shards)."""
        branches = [getattr(self, f"ConvNormAct_{k}")(x, rows) for k in range(self.n_rates + 1)]
        # jnp.mean of bf16 sums in float32 and rounds once.
        if self.space > 1:
            # The shard's rows summed in float32, the sum over the space
            # group, divided by the whole grid.  Every rank then holds the
            # same pooled value, and the 1×1 ConvNormAct runs on it
            # replicated.  The gradient is summed over the group exactly
            # once, by this all-reduce's backward: each rank's cotangent
            # of the pooled value carries only its own rows' loss, and the
            # branch's stage-wide BatchNorm (``BatchNorm.axis``) does not
            # add the others' — its statistics' backward hands each rank
            # 1/(data·space) of the group's cotangent of the shared mean,
            # which summed over the space group is that cotangent once.
            total = _AllReduceSum.apply(
                x.sum(dim=(2, 3), keepdim=True, dtype=stat_dtype(x)), "space")
            grid = x.shape[2] * self.space if rows is None else rows
            pooled = (total / (grid * x.shape[3])).to(x.dtype)
        else:
            pooled = x.mean(dim=(2, 3), keepdim=True, dtype=stat_dtype(x)).to(x.dtype)
        pooled = getattr(self, f"ConvNormAct_{self.n_rates + 1}")(pooled)
        branches.append(pooled.expand(-1, -1, *x.shape[2:]).to(self.dtype))
        return getattr(self, f"ConvNormAct_{self.n_rates + 2}")(torch.cat(branches, dim=1), rows)


class DeepLabV3Plus(nn.Module):
    def __init__(
        self,
        num_classes: int = 6,
        features: tuple = (64, 128, 256, 512),
        stem_features: int = 64,
        blocks_per_stage: int = 2,
        width_divisor: int = 1,
        output_stride: int = 16,
        aspp_features: int = 256,
        aspp_rates: Sequence[int] = (6, 12, 18),
        decoder_low_level_features: int = 48,
        decoder_features: int = 256,
        norm: str = "batch",
        norm_groups: int = 8,
        dtype: torch.dtype = torch.bfloat16,
        head_dtype: torch.dtype = torch.float32,
        in_channels: int = 3,
        seed: int = 0,
    ):
        """Parameters drawn with flax's default initializers from a
        ``torch.Generator`` seeded with ``seed`` (see ``UNet``)."""
        super().__init__()
        if output_stride not in (8, 16):
            raise ValueError(f"output_stride must be 8 or 16, got {output_stride}")
        g = torch.Generator().manual_seed(seed)
        w = lambda f: max(1, f // width_divisor)  # noqa: E731
        common = dict(norm=norm, generator=g, norm_groups=norm_groups)
        self.dtype = dtype
        self.head_dtype = head_dtype
        self.output_stride = output_stride
        self.space = 1  # models.shard_space sets the space axis's size
        self.ConvNormAct_0 = ConvNormAct(in_channels, w(stem_features), dtype, stride=2, **common)
        # Stage strides: 1, 2, 2 until the output stride is reached, then
        # dilation doubling instead (16: the last stage; 8: the last two).
        stages, stride_so_far, dilation = [], 4, 1
        for f in features:
            if stride_so_far >= output_stride:
                dilation *= 2
                stages.append((f, 1, dilation))
            else:
                stride = 1 if not stages else 2
                stride_so_far *= stride
                stages.append((f, stride, 1))
        self.blocks = []
        c = w(stem_features)
        for s, (f, stride, dil) in enumerate(stages):
            for b in range(blocks_per_stage):
                name = f"stage{s}_block{b}"
                self.add_module(name, ResidualBlock(
                    c, w(f), dtype, stride=stride if b == 0 else 1, dilation=dil,
                    norm=norm, norm_groups=norm_groups, generator=g,
                ))
                self.blocks.append((s, name))
                c = w(f)
            if s == 0:
                low_c = c
        self.ASPP_0 = ASPP(c, w(aspp_features), aspp_rates, dtype, **common)
        self.ConvNormAct_1 = ConvNormAct(low_c, w(decoder_low_level_features), dtype,
                                         kernel_size=1, **common)
        self.ConvNormAct_2 = ConvNormAct(w(aspp_features) + w(decoder_low_level_features),
                                         w(decoder_features), dtype, **common)
        self.ConvNormAct_3 = ConvNormAct(w(decoder_features), w(decoder_features), dtype,
                                         **common)
        self.Conv_0 = Conv(w(decoder_features), num_classes, 1, head_dtype, generator=g)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [N,H,W,C] float, H and W divisible by the output stride →
        logits [N,H,W,num_classes] in the head dtype."""
        rows = None  # the input's global rows under the space axis
        if self.space > 1:
            from ddlpc_tpu_torch.models import check_space_rows

            rows = images.shape[1] * self.space
            check_space_rows(rows, self.space, 1, pools=self.output_stride.bit_length() - 1)

        def over(k: int):
            return None if rows is None else rows // k

        x = images.permute(0, 3, 1, 2).to(self.dtype)
        y = max_pool_same(self.ConvNormAct_0(x, rows), 3, 2, self.space, over(2))
        low_level, stride = None, 4
        for s, name in self.blocks:
            block = getattr(self, name)
            y = block(y, over(stride))
            stride *= block.Conv_0.stride
            if s == 0:
                low_level = y  # stride-4 features for the decoder
        y = self._resize(self.ASPP_0(y, over(stride)), low_level.shape[2:], over(stride),
                         over(4))
        y = torch.cat([y, self.ConvNormAct_1(low_level, over(4))], dim=1)
        y = self.ConvNormAct_3(self.ConvNormAct_2(y, over(4)), over(4))
        logits = self.Conv_0(y.to(self.head_dtype), over(4))
        return self._resize(logits, x.shape[2:], over(4), rows).permute(0, 2, 3, 1)

    def _resize(self, x: torch.Tensor, size, rows=None, to_rows=None) -> torch.Tensor:
        """Bilinear up-sampling to ``size``; sharded, a whole factor of the
        global rows ``rows`` to ``to_rows`` (×4 at output stride 16 both
        times, ×2 then ×4 at 8)."""
        if self.space <= 1:
            return resize_bilinear(x, size)
        r = to_rows // rows
        if (r * rows, r * x.shape[3]) != (to_rows, size[1]):
            raise ValueError(f"a sharded resize from {rows} × {x.shape[3]} to {to_rows} × "
                             f"{size[1]} is not a whole factor")
        return upsample(x, r, self.space, rows)
