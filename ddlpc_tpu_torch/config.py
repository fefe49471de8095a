"""Experiment configuration: the port's own copy of ``ddlpc_tpu.config``.

The same JSON artifacts (``configs/*.json``) parse unchanged, so every
field of the five sections is kept, with the reference's defaults.  The
meaning of each field is documented in ``ddlpc_tpu/config.py``; fields this
slice of the port does not implement are rejected where they are consumed
(``train/trainer.py:unsupported_settings``), never silently ignored.
Knobs only the port has (the device) live on the CLI, not in the JSON.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str = "unet"
    num_classes: int = 6
    width_divisor: int = 1
    features: Tuple[int, ...] = (64, 128, 256, 512, 512)
    bottleneck_features: int = 512
    up_sample_mode: str = "conv_transpose"  # conv_transpose | bilinear
    norm: str = "batch"  # batch | group | none
    group_norm_groups: int = 8
    stem: str = "none"  # none | s2d
    stem_factor: int = 2
    detail_head: bool = False
    detail_head_kind: str = "fullres"  # fullres | s2d
    detail_head_hidden: int = 16
    train_head_layout: str = "fullres"  # fullres | grouped
    detail_head_scope: str = "per_head"  # per_head | ensemble
    deep_supervision: bool = False
    output_stride: int = 16
    aspp_rates: Tuple[int, ...] = (6, 12, 18)
    compute_dtype: str = "bfloat16"
    head_dtype: str = "float32"  # float32 | bfloat16


@dataclass(frozen=True)
class DataConfig:
    data_dir: str | None = None
    dataset: str = "vaihingen"
    image_size: Tuple[int, int] = (512, 512)  # (H, W)
    num_classes: int = 6
    test_split: int = 30
    shuffle: bool = True
    synthetic_len: int = 127
    seed: int = 0
    crops_per_epoch: int = 0
    test_split_scenes: int = 1
    lazy_tiles: bool = False
    mmap_scenes: bool = False
    augment: bool = False
    compact_upload: bool = False
    loader_workers: int = 1
    native_gather: bool = True
    device_cache: bool = False


@dataclass(frozen=True)
class TrainConfig:
    epochs: int = 100
    micro_batch_size: int = 1
    sync_period: int = 50
    learning_rate: float = 1e-3
    optimizer: str = "adam"
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    seed: int = 0
    log_every_steps: int = 1
    checkpoint_every_epochs: int = 1
    keep_checkpoints: int = 3
    checkpoint_async: bool = True
    checkpoint_format: str = "chunked"
    checkpoint_chunk_mb: int = 4
    checkpoint_compression: str = "adaptive"
    eval_every_epochs: int = 1
    dump_images_per_epoch: int = 5
    remat: bool = False
    profile_epoch: int = -1
    stall_timeout_s: float = 0.0
    stall_action: str = "dump"
    preempt_grace_s: float = 30.0
    trace: bool = False
    trace_sync_every_steps: int = 16
    telemetry_port: int = -1
    profile_steps: int = 20
    perf_accounting: bool = True
    peak_flops_per_device: float = 0.0


@dataclass(frozen=True)
class ParallelConfig:
    data_axis_size: int = -1
    space_axis_size: int = 1
    data_axis_name: str = "data"
    space_axis_name: str = "space"
    sync_batch_norm: bool = True
    shard_update: str = "auto"
    pipeline_stages: int = 1
    pipeline_microbatches: int = 0
    pipe_axis_name: str = "pipe"


@dataclass(frozen=True)
class CompressionConfig:
    mode: str = "none"  # none | int8 | float16
    int8_levels: int = 10
    fp16_levels: int = 100
    quantize_local: bool = True
    quantize_mean: bool = True
    transport: str = "simulate"  # simulate | ring
    rounding: str = "nearest"  # nearest | stochastic
    codec_backend: str = "xla"  # xla | pallas — both map to the port's kernels
    bucket_mb: float = 0.0


@dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    compression: CompressionConfig = field(default_factory=CompressionConfig)
    workdir: str = "runs/default"

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ExperimentConfig":
        """Build from a nested dict; unknown keys inside a section raise
        (top-level keys such as ``_comment`` are ignored, as in the
        reference)."""

        def build(klass, sub):
            fields = {f.name for f in dataclasses.fields(klass)}
            kwargs = {}
            for k, v in sub.items():
                if k not in fields:
                    raise ValueError(f"unknown config key {klass.__name__}.{k}")
                kwargs[k] = tuple(v) if isinstance(v, list) else v
            return klass(**kwargs)

        return cls(
            model=build(ModelConfig, d.get("model", {})),
            data=build(DataConfig, d.get("data", {})),
            train=build(TrainConfig, d.get("train", {})),
            parallel=build(ParallelConfig, d.get("parallel", {})),
            compression=build(CompressionConfig, d.get("compression", {})),
            workdir=d.get("workdir", "runs/default"),
        )

    @classmethod
    def from_json(cls, s: str) -> "ExperimentConfig":
        return cls.from_dict(json.loads(s))

    def replace(self, **kwargs) -> "ExperimentConfig":
        return dataclasses.replace(self, **kwargs)
