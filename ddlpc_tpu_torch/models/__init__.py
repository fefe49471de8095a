"""Model registry: ``build_model`` with the reference's validation and
messages (``ddlpc_tpu/models/__init__.py``) over ``unet``, ``unetpp`` and
``deeplabv3p``.  ``build_model_from_experiment`` switches sync-BN on from
``parallel.sync_batch_norm`` in a world of more than one replica."""

from __future__ import annotations

import torch
from torch import nn

from ddlpc_tpu_torch.config import ExperimentConfig, ModelConfig
from ddlpc_tpu_torch.models.deeplabv3p import DeepLabV3Plus
from ddlpc_tpu_torch.models.layers import BatchNorm
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


_REGISTRY = {
    "unet": lambda cfg, *common: UNet(
        bottleneck_features=cfg.bottleneck_features, **_heads(cfg), **_common(cfg, *common)
    ),
    "unetpp": lambda cfg, *common: UNetPP(
        deep_supervision=cfg.deep_supervision, detail_head_scope=cfg.detail_head_scope,
        **_heads(cfg), **_common(cfg, *common)
    ),
    "deeplabv3p": lambda cfg, *common: DeepLabV3Plus(
        output_stride=cfg.output_stride, aspp_rates=tuple(cfg.aspp_rates),
        **_common(cfg, *common)
    ),
}


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


def build_model_from_experiment(
    ecfg: ExperimentConfig, in_channels: int, data_size: int
) -> nn.Module:
    """``build_model`` with sync-BN over ``data_size`` replicas where
    ``parallel.sync_batch_norm`` holds."""
    sync = ecfg.parallel.sync_batch_norm and data_size > 1
    return build_model(
        ecfg.model, in_channels=in_channels, seed=ecfg.train.seed,
        norm_axis_size=data_size if sync else 1,
    )
