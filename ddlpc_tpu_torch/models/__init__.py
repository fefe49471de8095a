"""Model registry: ``build_model`` with the reference's validation and
messages (``ddlpc_tpu/models/__init__.py``) over ``unet``, ``unetpp`` and
``deeplabv3p``.  ``build_model_from_experiment`` switches sync-BN on from
``parallel.sync_batch_norm`` in a world of more than one replica, and
under ``parallel.space_axis_size > 1`` shards the model's H over the space
axis (:func:`shard_space`)."""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from ddlpc_tpu_torch.config import ExperimentConfig, ModelConfig
from ddlpc_tpu_torch.models.deeplabv3p import ASPP, DeepLabV3Plus
from ddlpc_tpu_torch.models.layers import BatchNorm, Conv, GroupNorm, UpBlock, space_halo
from ddlpc_tpu_torch.models.unet import UNet
from ddlpc_tpu_torch.models.unetpp import UNetPP

# Models that implement ModelConfig.detail_head (and the grouped layout).
_DETAIL_HEAD_MODELS = ("unet", "unetpp")
_DTYPES = {"float64": torch.float64, "float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r} (float64 | float32 | bfloat16)") from None


def _common(cfg: ModelConfig, in_channels: int, seed: int) -> dict:
    return dict(
        in_channels=in_channels, seed=seed,
        num_classes=cfg.num_classes, features=tuple(cfg.features),
        width_divisor=cfg.width_divisor, norm=cfg.norm, norm_groups=cfg.group_norm_groups,
        dtype=torch_dtype(cfg.compute_dtype), head_dtype=torch_dtype(cfg.head_dtype),
    )


def _heads(cfg: ModelConfig) -> dict:
    return dict(
        up_sample_mode=cfg.up_sample_mode, stem=cfg.stem, stem_factor=cfg.stem_factor,
        detail_head=cfg.detail_head, detail_head_kind=cfg.detail_head_kind,
        detail_head_hidden=cfg.detail_head_hidden, train_head_layout=cfg.train_head_layout,
    )


_REGISTRY: dict = {}


def register(name: str):
    """A decorator that registers a builder ``fn(cfg, in_channels, seed)``
    under ``name`` for :func:`build_model`, as the reference's
    ``register`` does; returns the builder unchanged."""

    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


@register("unet")
def _build_unet(cfg: ModelConfig, *common) -> nn.Module:
    return UNet(bottleneck_features=cfg.bottleneck_features, **_heads(cfg), **_common(cfg, *common))


@register("unetpp")
def _build_unetpp(cfg: ModelConfig, *common) -> nn.Module:
    return UNetPP(deep_supervision=cfg.deep_supervision, detail_head_scope=cfg.detail_head_scope,
                  **_heads(cfg), **_common(cfg, *common))


@register("deeplabv3p")
def _build_deeplabv3p(cfg: ModelConfig, *common) -> nn.Module:
    return DeepLabV3Plus(output_stride=cfg.output_stride, aspp_rates=tuple(cfg.aspp_rates),
                         **_common(cfg, *common))


def validate(cfg: ModelConfig) -> None:
    """The reference's refusals, word for word: an unknown model, and the
    detail-head and head-layout combinations a built network would not
    execute."""
    if cfg.name not in _REGISTRY:
        raise ValueError(f"unknown model {cfg.name!r}; registered: {sorted(_REGISTRY)}")
    if cfg.detail_head and cfg.name not in _DETAIL_HEAD_MODELS:
        raise ValueError(
            f"model {cfg.name!r} does not implement detail_head (supported: "
            f"{sorted(_DETAIL_HEAD_MODELS)}) — set model.detail_head=False"
        )
    if cfg.detail_head_kind not in ("fullres", "s2d"):
        raise ValueError(f"unknown detail_head_kind {cfg.detail_head_kind!r} (fullres | s2d)")
    if cfg.train_head_layout not in ("fullres", "grouped"):
        raise ValueError(
            f"unknown train_head_layout {cfg.train_head_layout!r} (fullres | grouped)"
        )
    if cfg.detail_head_scope not in ("per_head", "ensemble"):
        raise ValueError(
            f"unknown detail_head_scope {cfg.detail_head_scope!r} (per_head | ensemble)"
        )
    if cfg.detail_head and cfg.detail_head_kind == "s2d" and cfg.stem != "s2d":
        raise ValueError(
            "detail_head_kind='s2d' refines the pre-d2s logit grid and "
            "requires stem='s2d'; with stem='none' use detail_head_kind='fullres'"
        )
    if cfg.train_head_layout == "grouped":
        if cfg.stem != "s2d":
            raise ValueError(
                "train_head_layout='grouped' skips the subpixel d2s in the "
                "train path — it requires stem='s2d'"
            )
        if cfg.detail_head and cfg.detail_head_kind == "fullres":
            raise ValueError(
                "train_head_layout='grouped' cannot feed a full-resolution "
                "DetailHead (it needs full-res logits): use "
                "detail_head_kind='s2d' or train_head_layout='fullres'"
            )
        if cfg.name not in _DETAIL_HEAD_MODELS:
            raise ValueError(
                f"model {cfg.name!r} does not implement "
                f"train_head_layout='grouped' (supported: "
                f"{sorted(_DETAIL_HEAD_MODELS)})"
            )


def build_model(
    cfg: ModelConfig, in_channels: int = 3, seed: int = 0, norm_axis_size: int = 1
) -> nn.Module:
    """The model, its weights drawn from ``seed``; ``norm_axis_size > 1``
    averages BatchNorm's batch statistics over a process group of that
    size (the JAX package's ``norm_axis_name``)."""
    validate(cfg)
    model = _REGISTRY[cfg.name](cfg, in_channels, seed)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.axis_size = norm_axis_size
    return model


def space_pools(cfg: ModelConfig) -> int:
    """The halvings of H behind the stem, which set the heights the model
    takes (:func:`check_space_rows`): the U-Net pools once a level before
    its bottleneck, U-Net++ ``depth − 1`` times (its deepest node is not
    pooled), DeepLabV3+ ``log2(output_stride)`` times (its stride-2 stem,
    pool and stages)."""
    if cfg.name == "deeplabv3p":
        return cfg.output_stride.bit_length() - 1
    return len(cfg.features) - (cfg.name == "unetpp")


def space_stem_factor(cfg: ModelConfig) -> int:
    """The space-to-depth factor in front of the pools (1 for DeepLabV3+,
    which has no such stem)."""
    return cfg.stem_factor if cfg.stem == "s2d" and cfg.name != "deeplabv3p" else 1


def check_space_rows(height: int, space: int, stem_factor: int, pools: int,
                     shape: tuple | None = None) -> None:
    """Refuse what the JAX package's GSPMD step refuses, and nothing else:
    a height the ``space`` ranks cannot split evenly, in the words of
    JAX's ``device_put`` of the batch (``shape``, the global batch's, for
    the message), and a height the unsharded model does not take, a
    multiple of ``stem_factor · 2**pools`` (the caller's model's,
    :func:`space_stem_factor` and :func:`space_pools`).  Every other
    height shards: a level whose rows the space axis does not divide is
    laid out unevenly (``parallel.halo.row_layout``)."""
    if height % space:
        full = "" if shape is None else f" (full shape: {tuple(shape)})"
        raise ValueError(
            f"image height {height} over parallel.space_axis_size={space}: the batch was "
            f"given the sharding P(None, 'data', 'space'), which implies that the global "
            f"size of its dimension 2 should be divisible by {space}, but it is equal to "
            f"{height}{full}"
        )
    unit = stem_factor * 2 ** pools
    if height % unit:
        raise ValueError(
            f"image height {height} does not divide by stem_factor·2**pools = "
            f"{stem_factor}·2**{pools} = {unit}, which the model needs unsharded too"
        )


_SPACED = (GroupNorm, UpBlock, UNet, UNetPP, DeepLabV3Plus, ASPP)


def shard_space(model: nn.Module, data_size: int, space_size: int) -> nn.Module:
    """Shard ``model``'s H over the space axis, in place: every conv with a
    window or a stride takes the rows its window reads beyond the shard
    from its neighbours (``Conv.halo``, :func:`layers.space_halo`:
    ``dilation · (k // 2)`` a side at stride 1, across several shards
    where that passes a shard's rows; one row from below for a 3×3
    stride-2 conv; none for a strided 1×1 conv, which keeps its own even
    rows), BatchNorm reduces over the stage's (data, space) group of
    ``data_size · space_size`` ranks (the JAX GSPMD step's statistics over
    the logical global batch, which it takes with or without
    ``sync_batch_norm``), GroupNorm over the space group, and the models,
    a bilinear ``UpBlock`` and DeepLabV3+'s ASPP learn the group's size
    (``space``: the height check, the clamped resizes, DeepLabV3+'s pool
    and image pool).  Any height :func:`check_space_rows` takes shards:
    the models pass every op its input's global rows, and a level the
    group does not divide evenly is resharded around its strided ops and
    up-samplings (``models/layers.py``).  The U-Net, U-Net++ and
    DeepLabV3+ shard; another module raises ``NotImplementedError``."""
    if space_size <= 1:
        return model
    if not isinstance(model, (UNet, UNetPP, DeepLabV3Plus)):
        raise NotImplementedError(
            f"{type(model).__name__} under parallel.space_axis_size={space_size}: "
            f"the space axis shards the U-Net, U-Net++ and DeepLabV3+"
        )
    for m in model.modules():
        if isinstance(m, Conv) and (m.kernel > 1 or m.stride > 1):
            m.halo = space_halo(m.kernel, m.stride, m.dilation)
        elif isinstance(m, BatchNorm):
            m.axis_size, m.axis = data_size * space_size, "stage"
        elif isinstance(m, _SPACED):
            m.space = space_size
    return model


@contextlib.contextmanager
def space_off(model: nn.Module):
    """Run a sharded model unsharded for the duration: whole tiles on one
    rank, no halo and no statistics over the space axis (an eval-mode
    forward then needs no collective).  Restores the sharding after."""
    saved = [(m, m.halo) for m in model.modules() if isinstance(m, Conv)]
    saved += [(m, m.space) for m in model.modules() if isinstance(m, _SPACED)]
    for m, _ in saved:
        if isinstance(m, Conv):
            m.halo = 0
        else:
            m.space = 1
    try:
        yield model
    finally:
        for m, v in saved:
            if isinstance(m, Conv):
                m.halo = v
            else:
                m.space = v


def build_model_from_experiment(
    ecfg: ExperimentConfig, in_channels: int, data_size: int
) -> nn.Module:
    """``build_model`` with sync-BN over ``data_size`` replicas where
    ``parallel.sync_batch_norm`` holds, sharded over the space axis
    (:func:`shard_space`) where ``parallel.space_axis_size > 1``."""
    space = ecfg.parallel.space_axis_size
    sync = ecfg.parallel.sync_batch_norm and data_size > 1
    model = build_model(
        ecfg.model, in_channels=in_channels, seed=ecfg.train.seed,
        norm_axis_size=data_size if sync else 1,
    )
    return shard_space(model, data_size, space)
