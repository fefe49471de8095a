"""Model registry: ``build_model`` with the reference's validation
(``ddlpc_tpu/models/__init__.py``).  This slice ports ``unet``; the other
models raise ``NotImplementedError``.  ``build_model_from_experiment``
switches sync-BN on from ``parallel.sync_batch_norm`` in a world of more
than one replica."""

from __future__ import annotations

import torch

from ddlpc_tpu_torch.config import ExperimentConfig, ModelConfig
from ddlpc_tpu_torch.models.layers import BatchNorm
from ddlpc_tpu_torch.models.unet import UNet

_KNOWN_MODELS = ("unet", "unetpp", "deeplabv3p")
_DETAIL_HEAD_MODELS = ("unet", "unetpp")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r} (float32 | bfloat16)") from None


def build_model(
    cfg: ModelConfig, in_channels: int = 3, seed: int = 0, norm_axis_size: int = 1
) -> UNet:
    """The model, its weights drawn from ``seed``; ``norm_axis_size > 1``
    averages BatchNorm's batch statistics over a process group of that
    size (the JAX package's ``norm_axis_name``)."""
    if cfg.name not in _KNOWN_MODELS:
        raise ValueError(f"unknown model {cfg.name!r}; registered: {sorted(_KNOWN_MODELS)}")
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
    if cfg.name != "unet":
        raise NotImplementedError(f"model {cfg.name!r} is not yet ported")
    for knob, value, ported in (
        ("up_sample_mode", cfg.up_sample_mode, "conv_transpose"),
        ("norm", cfg.norm, "batch"),
        ("train_head_layout", cfg.train_head_layout, "fullres"),
    ):
        if value != ported:
            raise NotImplementedError(f"model.{knob}={value!r} is not yet ported")
    if cfg.detail_head and cfg.detail_head_kind != "fullres":
        raise NotImplementedError(
            f"model.detail_head_kind={cfg.detail_head_kind!r} is not yet ported"
        )
    model = UNet(
        num_classes=cfg.num_classes,
        features=tuple(cfg.features),
        bottleneck_features=cfg.bottleneck_features,
        width_divisor=cfg.width_divisor,
        norm=cfg.norm,
        stem=cfg.stem,
        stem_factor=cfg.stem_factor,
        detail_head=cfg.detail_head,
        detail_head_hidden=cfg.detail_head_hidden,
        dtype=torch_dtype(cfg.compute_dtype),
        head_dtype=torch_dtype(cfg.head_dtype),
        in_channels=in_channels,
        seed=seed,
    )
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.axis_size = norm_axis_size
    return model


def build_model_from_experiment(
    ecfg: ExperimentConfig, in_channels: int, data_size: int
) -> UNet:
    """``build_model`` with sync-BN over ``data_size`` replicas where
    ``parallel.sync_batch_norm`` holds."""
    sync = ecfg.parallel.sync_batch_norm and data_size > 1
    return build_model(
        ecfg.model, in_channels=in_channels, seed=ecfg.train.seed,
        norm_axis_size=data_size if sync else 1,
    )
