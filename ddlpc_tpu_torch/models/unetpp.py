"""U-Net++ (nested U-Net, dense skips, deep supervision), mirroring
``ddlpc_tpu/models/unetpp.py``.

Node ``x{i}_{j}`` at depth i takes the concatenation of the same-depth
nodes ``x{i}_0 … x{i}_{j-1}`` and the up-sampled ``x{i+1}_{j-1}``.  With
deep supervision each ``x0_{j}``, j ≥ 1, has a 1×1 logit head
``head_{j}``; without it one ``head`` reads ``x0_{depth-1}``.  Train mode
returns the stacked per-head logits ``[J,N,H,W,C]`` (the loss is the mean
of the per-head losses); eval mode returns the heads' float32 mean, taken
at the stem grid and restored once where no full-resolution refinement
runs.  An optional shared ``detail_head`` (``DetailHead`` or
``StemGridDetailHead``) refines every head (``per_head``) or only the
ensemble mean, which then joins the train stack (``ensemble``).  Names
are flax's, so ``convert.py`` maps the param trees by path.

H sharded over the space axis (``models.shard_space`` sets ``space``):
every tensor holds this rank's rows of its level, laid out by
``parallel.halo.row_layout`` over the level's global rows, which the
forward passes to each node (the height must be one the unsharded
network takes, ``models.check_space_rows``); the heads, their mean and
the detail heads are row-local, their 3×3 convs taking halos
(``layers.Conv.halo``).
"""

from __future__ import annotations

import torch
from torch import nn

from ddlpc_tpu_torch.models.layers import (
    Conv,
    DetailHead,
    DoubleConv,
    StemGridDetailHead,
    UpBlock,
    depth_to_space,
    max_pool_2x2,
    space_to_depth,
)


class UNetPP(nn.Module):
    def __init__(
        self,
        num_classes: int = 6,
        features: tuple = (32, 64, 128, 256, 512),
        width_divisor: int = 1,
        up_sample_mode: str = "conv_transpose",
        norm: str = "batch",
        norm_groups: int = 8,
        deep_supervision: bool = True,
        stem: str = "none",
        stem_factor: int = 2,
        detail_head: bool = False,
        detail_head_kind: str = "fullres",
        detail_head_hidden: int = 16,
        detail_head_scope: str = "per_head",
        train_head_layout: str = "fullres",
        dtype: torch.dtype = torch.bfloat16,
        head_dtype: torch.dtype = torch.float32,
        in_channels: int = 3,
        seed: int = 0,
    ):
        """Parameters drawn with flax's default initializers from a
        ``torch.Generator`` seeded with ``seed`` (see ``UNet``)."""
        super().__init__()
        if stem not in ("none", "s2d"):
            raise ValueError(f"unknown stem {stem!r}")
        g = torch.Generator().manual_seed(seed)
        self.stem = stem
        self.r = stem_factor if stem == "s2d" else 1
        self.depth = depth = len(features)
        self.deep_supervision = deep_supervision
        self.space = 1  # models.shard_space sets the space axis's size
        self.dtype = dtype
        self.head_dtype = head_dtype
        self.refine = detail_head_kind if detail_head else None
        if self.refine == "s2d" and stem != "s2d":
            raise ValueError(
                "detail_head_kind='s2d' requires stem='s2d' "
                "(see ModelConfig.detail_head_kind)"
            )
        # With one head there is no ensemble to refine apart.
        self.ensemble_scope = (
            detail_head and detail_head_scope == "ensemble" and deep_supervision
        )
        self.train_head_layout = train_head_layout
        self.grouped = (
            train_head_layout == "grouped" and stem == "s2d" and self.refine != "fullres"
        )
        w = [max(1, f // width_divisor) for f in features]
        common = dict(norm=norm, generator=g, norm_groups=norm_groups)
        c = in_channels * self.r * self.r
        for i in range(depth):
            self.add_module(f"x{i}_0", DoubleConv(c, w[i], dtype, **common))
            c = w[i]
        for j in range(1, depth):
            for i in range(depth - j):
                self.add_module(
                    f"x{i}_{j}",
                    UpBlock(w[i + 1], j * w[i], w[i], dtype,
                            up_sample_mode=up_sample_mode, **common),
                )
        head_c = num_classes * self.r * self.r
        self.head_names = (
            [f"head_{j}" for j in range(1, depth)] if deep_supervision else ["head"]
        )
        for name in self.head_names:
            self.add_module(name, Conv(w[0], head_c, 1, head_dtype, generator=g))
        if self.refine == "s2d":
            self.detail_head = StemGridDetailHead(
                num_classes, in_channels, self.r, detail_head_hidden, dtype, head_dtype, g
            )
        elif self.refine == "fullres":
            self.detail_head = DetailHead(
                num_classes, in_channels, detail_head_hidden, dtype, head_dtype, g
            )

    def _restore(self, z: torch.Tensor, rows=None) -> torch.Tensor:
        """Depth-to-space of the stem grid's logits (``rows``: its global
        rows under the space axis)."""
        return depth_to_space(z, self.r, rows) if self.stem == "s2d" else z

    def _to_pixel(self, z: torch.Tensor, image: torch.Tensor, refine: bool,
                  rows=None) -> torch.Tensor:
        logits = self._restore(z, rows)
        if refine and self.refine == "fullres":
            logits = self.detail_head(logits, image, None if rows is None else rows * self.r)
        return logits

    def _mean(self, zs) -> torch.Tensor:
        """The heads' float32 mean."""
        return torch.stack(zs).float().mean(dim=0)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [N,H,W,C] float, H and W divisible by 2**(depth−1)
        (× the stem factor under s2d) → logits in the head dtype,
        ``[J,N,H,W,C]`` in train mode with deep supervision (``[J,N,H/r,
        W/r,r²·C]`` grouped), else ``[N,H,W,C]`` (the eval mean in
        float32 where there is more than one head)."""
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        image = x
        rows = None  # the input's global rows under the space axis
        if self.space > 1:
            from ddlpc_tpu_torch.models import check_space_rows

            rows = images.shape[1] * self.space
            check_space_rows(rows, self.space, self.r, pools=self.depth - 1)
        if self.stem == "s2d":
            x = space_to_depth(x, self.r, rows)
        size = (x.shape[2] if rows is None else rows // self.r, x.shape[3])
        min_px = 2 ** (self.depth - 1)
        if min(size) < min_px:
            raise ValueError(
                f"input {tuple(images.shape[1:3])} too small for a {self.depth}-level "
                f"U-Net++ grid behind the {self.stem!r} stem (grid {size} "
                f"after the stem; the deepest pool needs ≥ {min_px} px)"
            )

        def at(level: int):
            return None if rows is None else rows // self.r >> level

        grid = {}
        h = x
        for i in range(self.depth):
            grid[i, 0] = getattr(self, f"x{i}_0")(h, at(i))
            if i < self.depth - 1:
                h = max_pool_2x2(grid[i, 0], at(i))
        for j in range(1, self.depth):
            for i in range(self.depth - j):
                grid[i, j] = getattr(self, f"x{i}_{j}")(
                    grid[i + 1, j - 1], [grid[i, k] for k in range(j)], rows=at(i + 1)
                )
        cols = range(1, self.depth) if self.deep_supervision else [self.depth - 1]
        zs = [getattr(self, name)(grid[0, j].to(self.head_dtype), at(0))
              for name, j in zip(self.head_names, cols)]
        if self.refine == "s2d" and not self.ensemble_scope:
            zs = [self.detail_head(z, image, at(0)) for z in zs]
        # scope='ensemble': one refinement of the ensemble mean, which
        # joins the train stack as one more supervised output.
        ens_z = ens_px = None
        if self.ensemble_scope:
            ens = self._mean(zs).to(self.head_dtype) if len(zs) > 1 else zs[0]
            if self.refine == "s2d":
                ens_z = self.detail_head(ens, image, at(0))
            else:
                ens_px = self.detail_head(self._restore(ens, at(0)), image, rows)
        if self.training:
            if self.grouped:
                outs = zs + ([ens_z] if ens_z is not None else [])
            else:
                outs = [self._to_pixel(z, image, not self.ensemble_scope, at(0)) for z in zs]
                if ens_z is not None:
                    outs.append(self._restore(ens_z, at(0)))
                elif ens_px is not None:
                    outs.append(ens_px)
            if self.deep_supervision:
                return torch.stack(outs).permute(0, 1, 3, 4, 2)
            return outs[0].permute(0, 2, 3, 1)
        if ens_z is not None:
            out = self._restore(ens_z, at(0))
        elif ens_px is not None:
            out = ens_px
        elif self.refine != "fullres":
            # depth_to_space is a permutation: average at the stem grid and
            # restore once.
            out = self._restore(zs[0] if len(zs) == 1 else self._mean(zs), at(0))
        else:
            logits = [self._to_pixel(z, image, True, at(0)) for z in zs]
            out = logits[0] if len(logits) == 1 else self._mean(logits)
        return out.permute(0, 2, 3, 1)
