"""U-Net for semantic segmentation, mirroring ``ddlpc_tpu/models/unet.py``.

Public layout as in the reference: images ``[N,H,W,C]`` in, logits
``[N,H,W,num_classes]`` (``head_dtype``) out — or, in train mode under
``train_head_layout='grouped'`` with the s2d stem, the pre-depth-to-space
logits ``[N,H/r,W/r,r²·C]`` (phase-major, see ``layers.group_labels``).
Inside, activations are NCHW.

Pipeline stages (``parallel/pipeline.py``): the network is an ordered list
of cut points (:meth:`UNet.pipeline_block_names`), and ``forward(blocks=,
carry=)`` runs a contiguous slice of it, as the JAX U-Net's staged
``__call__`` does.  A slice that does not end at the head returns the
carry ``{'x', 'skips'[, 'image']}`` — NCHW tensors in the compute dtype —
which the next slice resumes from.

H sharded over the space axis (``models.shard_space`` sets ``space``):
every tensor holds this rank's rows of its level, laid out by
``parallel.halo.row_layout`` over the level's global rows, which the
forward passes to each block; the input's height must be one the
unsharded network takes (``models.check_space_rows``).
"""

from __future__ import annotations

import torch
from torch import nn

from typing import Optional, Sequence

from ddlpc_tpu_torch.models.layers import (
    Conv,
    DetailHead,
    DoubleConv,
    DownBlock,
    StemGridDetailHead,
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
        up_sample_mode: str = "conv_transpose",
        norm: str = "batch",
        norm_groups: int = 8,
        stem: str = "none",
        stem_factor: int = 2,
        detail_head: bool = False,
        detail_head_kind: str = "fullres",
        detail_head_hidden: int = 16,
        train_head_layout: str = "fullres",
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
        self.refine = detail_head_kind if detail_head else None
        # Declared for the train step's loss (parallel/train_step.py).
        self.train_head_layout = train_head_layout
        self.grouped = (
            train_head_layout == "grouped" and stem == "s2d" and self.refine != "fullres"
        )
        self.dtype = dtype
        self.head_dtype = head_dtype
        self.depth = len(features)
        self.up_sample_mode = up_sample_mode
        self.detail_head = detail_head
        self.detail_head_kind = detail_head_kind
        self.space = 1  # models.shard_space sets the space axis's size
        w = lambda f: max(1, f // width_divisor)  # noqa: E731
        c = in_channels * self.r * self.r
        common = dict(norm=norm, generator=g, norm_groups=norm_groups)
        skips = []
        for i, f in enumerate(features):
            self.add_module(f"DownBlock_{i}", DownBlock(c, w(f), dtype, **common))
            c = w(f)
            skips.append(c)
        self.DoubleConv_0 = DoubleConv(c, w(bottleneck_features), dtype, **common)
        c = w(bottleneck_features)
        for i in range(self.depth):
            f = w(features[self.depth - 1 - i])
            self.add_module(
                f"UpBlock_{i}",
                UpBlock(c, skips.pop(), f, dtype, up_sample_mode=up_sample_mode, **common),
            )
            c = f
        self.Conv_0 = Conv(c, num_classes * self.r * self.r, 1, head_dtype,
                           generator=g)
        if self.refine == "s2d":
            if stem != "s2d":
                raise ValueError(
                    "detail_head_kind='s2d' refines the pre-d2s logit grid — "
                    "it requires stem='s2d' (with stem='none' there is no "
                    "stem grid; use detail_head_kind='fullres')"
                )
            self.StemGridDetailHead_0 = StemGridDetailHead(
                num_classes, in_channels, self.r, detail_head_hidden, dtype, head_dtype, g
            )
        elif self.refine == "fullres":
            self.DetailHead_0 = DetailHead(
                num_classes, in_channels, detail_head_hidden, dtype, head_dtype, g
            )

    # -- pipeline staging (parallel/pipeline.py) ---------------------------

    def pipeline_block_names(self) -> tuple:
        """The cut points in execution order: the down blocks, the
        bottleneck, each up block in two (``:up``, the transposed conv and
        the concat; ``:conv``, its DoubleConv), the head."""
        names = [f"DownBlock_{i}" for i in range(self.depth)] + ["DoubleConv_0"]
        for i in range(self.depth):
            names += [f"UpBlock_{i}:up", f"UpBlock_{i}:conv"]
        return tuple(names + ["head"])

    def pipeline_block_modules(self) -> dict:
        """Block name → the flax module paths (``/``-joined) it owns."""
        out = {}
        for b in self.pipeline_block_names():
            if b == "head":
                head = ["Conv_0"]
                if self.refine == "s2d":
                    head.append("StemGridDetailHead_0")
                if self.refine == "fullres":
                    head.append("DetailHead_0")
                out[b] = tuple(head)
            elif b.endswith(":up"):
                out[b] = (b[: -len(":up")] + "/ConvTranspose_0",)
            elif b.endswith(":conv"):
                out[b] = (b[: -len(":conv")] + "/DoubleConv_0",)
            else:
                out[b] = (b,)
        return out

    def carry_has_image(self) -> bool:
        """Whether the carry ships the full-resolution input forward (only
        the detail heads read it)."""
        return bool(self.detail_head)

    def forward(
        self,
        images: Optional[torch.Tensor],
        blocks: Optional[Sequence[str]] = None,
        carry: Optional[dict] = None,
    ):
        """images [N,H,W,C] float → logits [N,H,W,num_classes] in head dtype
        (train or eval mode per ``self.training``; grouped in train mode,
        see the module docstring).  ``blocks`` runs a contiguous slice of
        :meth:`pipeline_block_names` from ``images`` (``carry`` None: the
        slice starts at the first block) or from ``carry``; a slice that
        does not end at the head returns the carry.  ``blocks=None`` runs
        everything."""
        names = self.pipeline_block_names()
        if blocks is None:
            blocks = names
        else:
            blocks = tuple(blocks)
            lo = names.index(blocks[0])
            if blocks != names[lo : lo + len(blocks)]:
                raise ValueError(
                    f"blocks {blocks} is not a contiguous slice of the "
                    f"pipeline block order {names}"
                )
            if (carry is None) != (lo == 0):
                raise ValueError(
                    "the first stage (and only it) starts from the raw "
                    "image: pass carry=None exactly when blocks starts at "
                    f"{names[0]!r}"
                )
        # The stem grid's global rows under the space axis (None: unsharded,
        # or a pipeline stage, which the space axis does not compose with).
        grid = images.shape[1] * self.space // self.r if self.space > 1 and carry is None \
            else None
        if carry is None:
            x, image = self._stem(images)
            skips = []
        else:
            x, skips, image = carry["x"], list(carry["skips"]), carry.get("image")

        def at(level: int):
            return None if grid is None else grid >> level

        i = 0
        while i < len(blocks):
            b = blocks[i]
            if b.startswith("DownBlock_"):
                x, skip = getattr(self, b)(x, at(int(b.split("_")[1])))
                skips.append(skip)
            elif b == "DoubleConv_0":
                x = self.DoubleConv_0(x, at(self.depth))
            elif b.startswith("UpBlock_"):
                base, phase = b.split(":")
                up = getattr(self, base)
                if phase == "up" and i + 1 < len(blocks):
                    # Both halves: the unstaged call.
                    x = up(x, [skips.pop()], rows=at(self.depth - int(base.split("_")[1])))
                    i += 2
                    continue
                x = up(x, [skips.pop()], "up") if phase == "up" else up(x, [], "conv")
            else:  # "head"
                return self._head(x, image, at(0))
            i += 1
        out = {"x": x, "skips": tuple(skips)}
        if self.carry_has_image():
            out["image"] = image
        return out

    def _stem(self, images: torch.Tensor):
        """images [N,H,W,C] → (the first block's input, the full-resolution
        image), NCHW in the compute dtype."""
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        image = x
        rows = None
        if self.space > 1:
            from ddlpc_tpu_torch.models import check_space_rows

            rows = images.shape[1] * self.space
            check_space_rows(rows, self.space, self.r, pools=self.depth)
        if self.stem == "s2d":
            x = space_to_depth(x, self.r, rows)
        grid = (x.shape[2] if rows is None else rows // self.r, x.shape[3])
        min_px = 2 ** self.depth
        if min(grid) < min_px:
            raise ValueError(
                f"input {tuple(images.shape[1:3])} too small for a "
                f"{self.depth}-level pyramid behind the {self.stem!r} stem "
                f"(grid {grid} after the stem; the deepest pool "
                f"needs ≥ {min_px} px)"
            )
        return x, image

    def _head(self, x: torch.Tensor, image: Optional[torch.Tensor],
              rows: Optional[int] = None) -> torch.Tensor:
        """The 1×1 logit conv and the optional detail refinement; ``rows``,
        the stem grid's global rows under the space axis."""
        z = self.Conv_0(x.to(self.head_dtype), rows)
        if self.refine == "s2d":
            z = self.StemGridDetailHead_0(z, image, rows)
        if self.training and self.grouped:
            return z.permute(0, 2, 3, 1)
        logits = depth_to_space(z, self.r, rows) if self.stem == "s2d" else z
        if self.refine == "fullres":
            logits = self.DetailHead_0(logits, image, None if rows is None else rows * self.r)
        return logits.permute(0, 2, 3, 1)
