"""U-Net for semantic segmentation, mirroring ``ddlpc_tpu/models/unet.py``.

Public layout as in the reference: images ``[N,H,W,C]`` in, logits
``[N,H,W,num_classes]`` (``head_dtype``) out.  Inside, activations are
NCHW.  Pipeline staging (the reference's ``blocks``/``carry``) is not part
of this port.
"""

from __future__ import annotations

import torch
from torch import nn

from ddlpc_tpu_torch.models.layers import (
    Conv,
    DetailHead,
    DoubleConv,
    DownBlock,
    UpBlock,
    depth_to_space,
    space_to_depth,
)


class UNet(nn.Module):
    def __init__(
        self,
        num_classes: int = 6,
        features: tuple = (64, 128, 256, 512, 512),
        bottleneck_features: int = 512,
        width_divisor: int = 1,
        norm: str = "batch",
        stem: str = "none",
        stem_factor: int = 2,
        detail_head: bool = False,
        detail_head_hidden: int = 16,
        dtype: torch.dtype = torch.bfloat16,
        head_dtype: torch.dtype = torch.float32,
        in_channels: int = 3,
        seed: int = 0,
    ):
        """Parameters are drawn with flax's default initializers from a
        ``torch.Generator`` seeded with ``seed`` (not flax's draws: carry
        flax weights over with ``convert.torch_state_from_flax``)."""
        super().__init__()
        if stem not in ("none", "s2d"):
            raise ValueError(f"unknown stem {stem!r}")
        g = torch.Generator().manual_seed(seed)
        self.num_classes = num_classes
        self.stem = stem
        self.r = stem_factor if stem == "s2d" else 1
        self.detail_head = detail_head
        self.dtype = dtype
        self.head_dtype = head_dtype
        self.depth = len(features)
        w = lambda f: max(1, f // width_divisor)  # noqa: E731
        c = in_channels * self.r * self.r
        skips = []
        for i, f in enumerate(features):
            self.add_module(f"DownBlock_{i}", DownBlock(c, w(f), dtype, norm, g))
            c = w(f)
            skips.append(c)
        self.DoubleConv_0 = DoubleConv(c, w(bottleneck_features), dtype, norm, g)
        c = w(bottleneck_features)
        for i in range(self.depth):
            f = w(features[self.depth - 1 - i])
            self.add_module(
                f"UpBlock_{i}", UpBlock(c, skips.pop(), f, dtype, norm, g)
            )
            c = f
        self.Conv_0 = Conv(c, num_classes * self.r * self.r, 1, head_dtype,
                           generator=g)
        if detail_head:
            self.DetailHead_0 = DetailHead(
                num_classes, in_channels, detail_head_hidden, dtype, head_dtype, g
            )

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [N,H,W,C] float → logits [N,H,W,num_classes] in head dtype
        (train or eval mode per ``self.training``)."""
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        image = x
        if self.stem == "s2d":
            x = space_to_depth(x, self.r)
        min_px = 2 ** self.depth
        if x.shape[2] < min_px or x.shape[3] < min_px:
            raise ValueError(
                f"input {tuple(images.shape[1:3])} too small for a "
                f"{self.depth}-level pyramid behind the {self.stem!r} stem "
                f"(grid {tuple(x.shape[2:])} after the stem; the deepest pool "
                f"needs ≥ {min_px} px)"
            )
        skips = []
        for i in range(self.depth):
            x, skip = getattr(self, f"DownBlock_{i}")(x)
            skips.append(skip)
        x = self.DoubleConv_0(x)
        for i in range(self.depth):
            x = getattr(self, f"UpBlock_{i}")(x, skips.pop())
        z = self.Conv_0(x.to(self.head_dtype))
        logits = depth_to_space(z, self.r) if self.stem == "s2d" else z
        if self.detail_head:
            logits = self.DetailHead_0(logits, image)
        return logits.permute(0, 2, 3, 1)
