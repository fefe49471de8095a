"""Experiment configuration: the port's own copy of ``ddlpc_tpu.config``.

The same JSON artifacts (``configs/*.json``) parse unchanged, so every
field of the five sections is kept, with the reference's defaults.  The
meaning of each field is documented in ``ddlpc_tpu/config.py``; a setting
the port refuses (as the JAX package refuses it) is refused where it is
consumed, never silently ignored.
Knobs only the port has (the device) live on the CLI, not in the JSON.
"""

from __future__ import annotations

import dataclasses
import json
import os
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

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

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


@dataclass(frozen=True)
class ServeConfig:
    """The serving deploy (``serve/``) — one artifact per deploy, read from
    ``configs/serve_*.json``; ``ddlpc_tpu/config.py`` documents each field.
    The device is the serve CLI's ``--device``, never a key here."""

    workdir: str = "runs/default"  # training run to restore + reload from
    host: str = "127.0.0.1"
    port: int = 8571
    max_batch: int = 8  # tiles in one forward
    max_wait_ms: float = 5.0  # coalescing latency (coalesce batcher only)
    queue_limit: int = 64  # admission bound (tiles), then Overloaded
    deadline_ms: float = 2000.0  # per-request queue deadline; 0 = none
    batcher: str = "continuous"  # continuous | coalesce
    slots: int = 2  # concurrent in-flight forwards (continuous batcher)
    batch_queue_limit: int = 256  # bulk-class admission bound (tiles)
    starvation_every: int = 4
    quantize: str = "bf16"  # off | int8 | bf16 (serve/quantized.py)
    quantize_activations: bool = False  # input windows cast to bf16
    overlap: float = 0.25  # sliding-window overlap for full scenes
    metrics_window: int = 2048  # latency ring size for p50/p95/p99
    metrics_every_s: float = 10.0  # periodic JSONL snapshot cadence; 0 = off
    trace: bool = False  # request-path spans to serve_spans.jsonl
    profile_steps: int = 8  # batched forwards per /debug/trace capture
    drain_timeout_s: float = 30.0  # SIGTERM: wait for in-flight requests
    metrics_dir: str = ""  # serve_metrics.jsonl and traces; "" = workdir

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ServeConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown config key ServeConfig.{sorted(unknown)[0]}")
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "ServeConfig":
        return cls.from_dict(json.loads(s))

    def replace(self, **kwargs) -> "ServeConfig":
        return dataclasses.replace(self, **kwargs)


@dataclass(frozen=True)
class FleetConfig:
    """The serving fleet (``serve/fleet.py``, ``serve/router.py``): one
    router process supervising ``replicas`` server subprocesses — read from
    ``configs/fleet_*.json``; ``ddlpc_tpu/config.py`` documents each field.
    The replicas' device is the fleet CLI's ``--device``, never a key here."""

    workdir: str = "runs/default"  # training run every replica serves
    fleet_dir: str = ""  # replica homes, router.jsonl; "" = <workdir>/fleet
    host: str = "127.0.0.1"
    port: int = 8570  # router HTTP port (0 = ephemeral)
    replicas: int = 3
    # Per-replica serve knobs, forwarded into each replica's ServeConfig.
    max_batch: int = 8
    max_wait_ms: float = 5.0
    queue_limit: int = 64
    deadline_ms: float = 2000.0
    overlap: float = 0.25
    batcher: str = "continuous"  # continuous | coalesce
    slots: int = 2
    batch_queue_limit: int = 256
    starvation_every: int = 4
    quantize: str = "bf16"  # off | int8 | bf16 (serve/quantized.py)
    quantize_activations: bool = False
    batch_shed_queue_depth: int = 0  # router-side bulk shedding; 0 = off
    no_replica_wait_ms: float = 1000.0  # wait for an eligible replica; 0 = fail fast
    # Dispatch: per-attempt timeout, retries elsewhere with full-jitter
    # backoff, a hedge after hedge_ms (0 = off).
    request_timeout_ms: float = 4000.0
    retries: int = 2
    retry_backoff_ms: float = 25.0
    hedge_ms: float = 1000.0
    hedge_max: int = 1
    # Per-replica circuit breaker.
    breaker_window: int = 16
    breaker_min_samples: int = 8
    breaker_error_rate: float = 0.5
    breaker_cooldown_s: float = 2.0
    breaker_half_open_probes: int = 1
    breaker_close_after: int = 2
    # Health scraping.
    scrape_every_s: float = 1.0
    scrape_timeout_s: float = 2.0
    unhealthy_after: int = 3
    # Drain / rolling reload.
    drain_timeout_s: float = 30.0
    warmup_timeout_s: float = 180.0  # replica readiness deadline per (re)launch
    # Replica supervision (resilience/supervisor.py RestartPolicy).
    max_restarts: int = 100
    crash_loop_limit: int = 3
    backoff_base_s: float = 0.5
    backoff_cap_s: float = 30.0
    metrics_every_s: float = 10.0  # router.jsonl snapshot cadence; 0 = off
    trace: bool = False  # router spans + traceparent to the replicas
    # Fleet telemetry aggregation (obs/aggregate.py); 0 = off.
    aggregate_every_s: float = 2.0
    aggregate_stale_after_s: float = 15.0
    # SLO layer (obs/health.py:SLOTracker).
    slo_enabled: bool = True
    slo_interactive_p99_ms: float = 1000.0
    slo_batch_p99_ms: float = 10000.0
    slo_availability: float = 0.999
    slo_budget_window_s: float = 3600.0
    slo_fast_window_s: float = 300.0
    slo_fast_burn: float = 14.0
    slo_slow_window_s: float = 3600.0
    slo_slow_burn: float = 2.0
    # Elastic fleet (serve/autoscale.py).
    autoscale_enabled: bool = False
    autoscale_min_replicas: int = 1
    autoscale_max_replicas: int = 8
    autoscale_interval_s: float = 2.0
    autoscale_cooldown_s: float = 30.0
    autoscale_burn_threshold: float = 2.0
    autoscale_queue_depth_high: float = 8.0
    autoscale_queue_depth_low: float = 1.0
    autoscale_slot_busy_high: float = 0.85
    autoscale_slot_busy_low: float = 0.30
    cache_max_bytes: int = 0  # response cache (serve/cache.py); 0 = off

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "FleetConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown config key FleetConfig.{sorted(unknown)[0]}")
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "FleetConfig":
        return cls.from_dict(json.loads(s))

    def replace(self, **kwargs) -> "FleetConfig":
        return dataclasses.replace(self, **kwargs)

    def resolved_fleet_dir(self) -> str:
        return self.fleet_dir or os.path.join(self.workdir, "fleet")

    def replica_serve_config(self, metrics_dir: str = "") -> ServeConfig:
        """The ServeConfig one replica subprocess runs with."""
        return ServeConfig(
            workdir=self.workdir,
            host=self.host,
            port=0,  # ephemeral; the supervisor reads the port file
            max_batch=self.max_batch,
            max_wait_ms=self.max_wait_ms,
            queue_limit=self.queue_limit,
            deadline_ms=self.deadline_ms,
            overlap=self.overlap,
            batcher=self.batcher,
            slots=self.slots,
            batch_queue_limit=self.batch_queue_limit,
            starvation_every=self.starvation_every,
            quantize=self.quantize,
            quantize_activations=self.quantize_activations,
            drain_timeout_s=self.drain_timeout_s,
            metrics_dir=metrics_dir,
            trace=self.trace,  # replicas stamp the router's trace context
        )
