"""The training loop — the port's copy of ``ddlpc_tpu/train/trainer.py``.

``Trainer.fit()`` does what the JAX ``Trainer.fit`` does: epochs of
optimizer steps over the seeded, wrap-filled loader, a held-out evaluation
every ``eval_every_epochs``, and one logged record per epoch (loss, pixel
accuracy, grad norm, step time, and the eval's loss, pixel accuracy and
mIoU).  Rank 0 logs every record through ``MetricsLogger``
(``train/observability.py``): ``<workdir>/metrics.jsonl`` (each record
stamped with ``time`` and the stream ``schema``), a ``metrics.txt`` line
(echoed to stdout for the epoch records) and a gauge of each numeric
scalar in the run's registry.

Checkpoints and resume, as in the JAX trainer: every
``checkpoint_every_epochs`` the state is saved to ``<workdir>/checkpoints``
in the background (``train/async_checkpoint.py``); a new Trainer on the
same workdir resumes from the newest checkpoint that verifies, rank 0
deciding and broadcasting.  SIGTERM (or :meth:`Trainer.request_preempt`)
lets the in-flight step finish, writes an emergency checkpoint that
records how far into the epoch it got, and ``fit`` returns with
``preempted`` set (the CLI exits 43); the resume replays the loader to
that step.  ``<workdir>/breadcrumb.json`` names the phase throughout
(``resilience/protocol.py``).

Data parallel across processes: the world that ``RANK``/``WORLD_SIZE``/
``LOCAL_RANK`` describe (``torchrun``) is joined before the model is
built, one replica per process.  ``train.micro_batch_size`` is per
replica, so the global micro-batch is that times the world size, as in the
JAX trainer; ``parallel.shard_update`` resolves to ``off``, ``zero1``,
``zero2`` or ``zero3`` as it does there, and every codec transport,
gradient bucket size, optimizer, schedule and ``train.remat`` runs.

The data are the JAX trainer's (``data/datasets.py:build_dataset``):
synthetic tiles, or a ``data.data_dir`` of tiles (eager, or read per
gather under ``data.lazy_tiles``) or of scenes cropped ``data.crops_per_epoch``
times an epoch (eager, or memory-mapped under ``data.mmap_scenes``), with
``data.augment``'s dihedral transforms; the eval split is always resident.
The loader is the JAX trainer's choice: ``data.device_cache`` uploads the
split once and gathers on the device, else the host path's
``data.loader_workers`` threads prefetch through a pinned ring, gathering
with the native ``dwb_gather_pack`` under ``data.native_gather``
(``data/loader.py``); ``data.compact_upload`` ships bf16 images and int8
labels on either.  ``data.native_gather`` also picks the checkpoint
wire's native deflate (``utils/wire.py``); a host library that does not
build raises.  ``train.stall_timeout_s`` arms the stall watchdog
(``train/watchdog.py``): a data fetch (with the lazy read or mmap page-in
behind it), step or eval batch that stalls is diagnosed in
``<workdir>/stall.log``, and with ``stall_action='abort'`` the process
exits 42 after the ``stalled`` breadcrumb.  ``train.dump_images_per_epoch``
writes the prediction, label and image PNGs of the first test tiles under
``<workdir>/images/``.
``train.perf_accounting`` adds a ``kind="perf"`` record (MFU, goodput and
its debits, ``obs/flops.py``) and a ``kind="comm"`` record (each
collective's bytes, ``obs/comm.py``) to ``metrics.jsonl`` every epoch.

Observability, as in the JAX trainer:

- ``train.trace``: rank 0's span tracer (``obs/tracing.py``) writes
  ``<workdir>/spans.jsonl`` and, when ``fit`` exits, ``trace.json``:
  the ``epoch``, ``evaluate``, ``checkpoint_snapshot`` and
  ``checkpoint_barrier`` spans, every stage of the loop and the loader,
  and every ``train.trace_sync_every_steps`` steps a ``step_sync`` span
  that holds the step's device sync.
- the fenced comm probe (``obs/comm.make_comm_probe``) times the step's
  sync alone once an epoch, which feeds ``comm_s_per_step`` and
  ``comm_fraction`` in the ``kind="comm"`` record.  One deviation from
  JAX, which samples it where its tracer is enabled (process 0): the
  port's ranks are processes and the probe is a collective, so every
  rank samples it under ``train.trace`` (with perf accounting and more
  than one replica) at the same step, and rank 0 records its span.
- a ``kind="lineage"`` ``checkpoint_saved`` record after each save, the
  anchor ``obs/merge.py``'s lineage timeline joins the serving streams on.
- the health monitor (``obs/health.py``) sees every epoch record (a
  chaos ``nan@N`` poisons it first) and hands its alerts to the stream,
  the registry and the watchdog's diagnosis.
- the on-demand profiler (``obs/profiling.py``), armed by SIGUSR2 or
  ``GET /debug/trace?steps=N``, captures the next
  ``train.profile_steps`` steps into ``profile_<n>/`` and
  ``top_ops_<n>.json``; ``train.profile_epoch`` captures that whole
  epoch into ``<workdir>/profile/``.
- ``train.telemetry_port >= 0``: rank 0 serves ``/metrics``, ``/healthz``
  and ``/debug/trace`` on it (0: an ephemeral port, ``telemetry.port``).
  ``fit`` leaves the endpoint and the tracer open; :meth:`Trainer.close`
  closes both.

The space axis (``parallel.space_axis_size > 1``), as the JAX trainer's
GSPMD path: the world is a ``data × space`` grid (``mesh.init_grid``), the
model is sharded over H (``models.shard_space``: the U-Net and U-Net++,
either up-sampling, and DeepLabV3+, at any height the JAX GSPMD step
takes, ``models.check_space_rows``; a level the space axis does not
divide is laid out unevenly, ``parallel.halo.row_layout``),
each rank loads its data shard's rows, and the spatial train and eval steps
(``parallel/train_step.py``) take the global batch's loss, gradient,
BatchNorm statistics and confusion.  Perf accounting divides the FLOPs a
step by the space axis, and the comm record prices the ``gspmd`` variant,
as JAX does; there is no comm probe on that path.  Checkpoints hold the
canonical state, so a spatial run's restores into an unsharded one and
back.  ``parallel.pipeline_stages > 1`` raises the JAX trainer's
``ValueError``: the pipeline driver is ``parallel/pipeline.py``'s.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import signal
import threading
import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from ddlpc_tpu_torch import resolve_device
from ddlpc_tpu_torch.config import ExperimentConfig
from ddlpc_tpu_torch.convert import load_state_tree
from ddlpc_tpu_torch.data.datasets import build_dataset
from ddlpc_tpu_torch.data.loader import (
    DeviceCachedLoader,
    ShardedLoader,
    eval_batches,
    steps_per_epoch,
)
from ddlpc_tpu_torch.kernels.build import load_library
from ddlpc_tpu_torch.models import (
    build_model_from_experiment,
    check_space_rows,
    space_off,
    space_pools,
    space_stem_factor,
)
from ddlpc_tpu_torch.obs import comm as obs_comm
from ddlpc_tpu_torch.obs import flops as obs_flops
from ddlpc_tpu_torch.obs import hbm as obs_hbm
from ddlpc_tpu_torch.obs import lineage
from ddlpc_tpu_torch.obs.health import HealthMonitor
from ddlpc_tpu_torch.obs.http import TelemetryServer
from ddlpc_tpu_torch.obs.profiling import OnDemandProfiler
from ddlpc_tpu_torch.obs.registry import MetricsRegistry
from ddlpc_tpu_torch.obs.tracing import Tracer
from ddlpc_tpu_torch.ops.metrics import accuracy_from_confusion, iou_per_class, mean_iou
from ddlpc_tpu_torch.parallel import mesh
from ddlpc_tpu_torch.parallel.grad_sync import check_supported
from ddlpc_tpu_torch.parallel.shard_update import resolve_shard_update
from ddlpc_tpu_torch.parallel.train_step import (
    check_spatial_compression,
    create_train_state,
    make_eval_step,
    make_train_step,
    make_train_step_spatial,
)
from ddlpc_tpu_torch.resilience import chaos as _chaos_mod
from ddlpc_tpu_torch.resilience.protocol import EXIT_PREEMPTED, write_breadcrumb
from ddlpc_tpu_torch.train import checkpoint as ckpt
from ddlpc_tpu_torch.train.async_checkpoint import AsyncCheckpointer
from ddlpc_tpu_torch.train.observability import (
    MetricsLogger,
    StageTimer,
    dump_prediction_triples,
    maybe_profile,
)
from ddlpc_tpu_torch.utils.fsio import atomic_write_text
from ddlpc_tpu_torch.train.optim import build_optimizer
from ddlpc_tpu_torch.train.watchdog import StallWatchdog
from ddlpc_tpu_torch.utils import wire


PIPELINE_REFUSAL = (
    "pipeline_stages > 1 is not wired into the epoch Trainer: "
    "staged execution is host-scheduled (one program per stage, "
    "microbatch round-robin), which the Trainer's single-step "
    "loop cannot drive — build the step via "
    "parallel/pipeline.make_pipeline_train_step (bench.py "
    "--pipeline-ab shows the full driver loop); Trainer "
    "integration is a ROADMAP follow-on"
)


def check_exclusive(cfg: ExperimentConfig) -> None:
    """The JAX trainer's refusals of settings that exclude each other or
    that its data path cannot carry (``ddlpc_tpu/train/trainer.py:103-125``)."""
    d = cfg.data
    if d.device_cache and d.augment:
        raise ValueError(
            "data.device_cache and data.augment are mutually exclusive: "
            "augmentation runs in the host gather path that the device "
            "cache bypasses"
        )
    if d.compact_upload and d.num_classes > 127:
        raise ValueError(
            f"data.compact_upload ships int8 labels, which cannot hold "
            f"num_classes={d.num_classes} (max 127)"
        )
    if d.lazy_tiles and d.device_cache:
        raise ValueError(
            "data.lazy_tiles and data.device_cache are mutually "
            "exclusive: the device cache uploads whole resident arrays, "
            "exactly what lazy_tiles exists to avoid"
        )
    if d.loader_workers > 1 and d.device_cache:
        raise ValueError(
            "data.loader_workers only affects the host loader path; "
            "device_cache gathers batches on device, so worker threads have "
            "nothing to do — unset one of them"
        )


def warn_large_batch_stochastic(cfg: ExperimentConfig, data_size: int) -> None:
    """The JAX trainer's warning, word for word: stochastic rounding's
    benefit is regime-dependent (docs/QUANTIZATION.md round-3 table) — it
    closes int8's lag at global super-batch 32 but costs val mIoU at the
    flagship's 512, where the large batch already averages the rounding
    error away."""
    global_super_batch = cfg.train.micro_batch_size * data_size * cfg.train.sync_period
    if (
        cfg.compression.mode != "none"
        and cfg.compression.rounding == "stochastic"
        and global_super_batch >= 256
    ):
        warnings.warn(
            f"rounding='stochastic' at global super-batch "
            f"{global_super_batch} (micro {cfg.train.micro_batch_size} x "
            f"sync {cfg.train.sync_period} x {data_size} replicas): the "
            f"committed A/B measured stochastic rounding HELPING at small "
            f"batch (closes int8's lag at super-batch 32) but COSTING "
            f"-0.045 val mIoU at super-batch 512 "
            f"(docs/QUANTIZATION.md round-3 table) — large batches "
            f"average quantization error away on their own; prefer "
            f"rounding='nearest' here",
            stacklevel=3,
        )


def _breadcrumb_stalled(workdir: str, age: float, tag: str) -> None:
    """The last breadcrumb before a stall's abort: a supervisor reads it to
    classify exit 42 even where stderr was lost."""
    write_breadcrumb(workdir, "stalled", stall_age_s=age, stall_tag=tag)


class PreemptedRun(Exception):
    """Raised in the epoch loop when a graceful preemption was requested;
    carries where the run stopped, for the emergency checkpoint."""

    def __init__(self, epoch: int, steps_done: int):
        super().__init__(f"preempted at epoch {epoch}, step {steps_done}")
        self.epoch = epoch
        self.steps_done = steps_done


class Trainer:
    """One replica: the world, data, model, state, the train and eval
    steps, the loop.

    ``device`` is ``'cuda'`` unless the caller asks for ``'cpu'``; without
    CUDA and without ``device='cpu'`` construction raises.  In a world of
    several processes ``cuda`` means ``cuda:{LOCAL_RANK}`` (``cuda:i`` pins
    every rank to card ``i``), and ``dist_backend`` is ``nccl`` for a card
    and ``gloo`` for the CPU unless given.  ``resume`` restores the newest
    checkpoint of ``<workdir>/checkpoints`` when there is one."""

    def __init__(
        self,
        cfg: ExperimentConfig,
        resume: bool = True,
        device: Optional[str] = None,
        dist_backend: Optional[str] = None,
    ):
        self.device = mesh.rank_device(str(resolve_device(device)))
        check_exclusive(cfg)
        if cfg.model.num_classes != cfg.data.num_classes:
            raise ValueError(
                f"model.num_classes={cfg.model.num_classes} != "
                f"data.num_classes={cfg.data.num_classes}"
            )
        check_supported(cfg.compression)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        if cfg.parallel.pipeline_stages > 1:
            raise ValueError(PIPELINE_REFUSAL)
        mesh.initialize_distributed(dist_backend or mesh.default_backend(self.device))
        space = max(1, cfg.parallel.space_axis_size)
        self.spatial = space > 1
        world = mesh.world_size()
        if world % space == 0 and cfg.parallel.data_axis_size not in (-1, world // space):
            raise ValueError(
                f"parallel.data_axis_size={cfg.parallel.data_axis_size} × "
                f"space_axis_size={space} but the world has {world} process(es); "
                f"start one process per device of the data × space grid "
                f"(torchrun --nproc-per-node) or set data_axis_size to -1"
            )
        mesh.init_grid(1, cfg.parallel.data_axis_size, space)
        # ``world``: the replicas along the data axis; ``rank``: the global
        # rank (rank 0 logs and writes); ``replica``: the data index.
        self.world = mesh.data_size()
        self.rank = mesh.world_rank()
        self.replica = mesh.replica_index()
        self.space = (mesh.space_index(), space)
        if self.spatial:
            check_spatial_compression(cfg.compression)
            h, w = cfg.data.image_size
            batch = (cfg.train.sync_period, cfg.train.micro_batch_size * self.world, h, w, 3)
            check_space_rows(h, space, space_stem_factor(cfg.model), space_pools(cfg.model),
                             shape=batch)
        self.shard_update = resolve_shard_update(
            cfg.parallel.shard_update, cfg.compression, self.world, spatial=self.spatial,
            grad_clip_norm=cfg.train.grad_clip_norm,
        )
        warn_large_batch_stochastic(cfg, self.world)
        self.cfg = cfg
        self.workdir = cfg.workdir
        self.ckpt_dir = os.path.join(self.workdir, "checkpoints")
        # One run id a Trainer, and the hash of its config, in every
        # checkpoint's lineage record.
        self.run_id = lineage.new_id()
        self.config_hash = lineage.config_hash(json.dumps(cfg.to_dict(), sort_keys=True))
        if self.device.type == "cuda":
            # fp32 convolutions and matmuls run in true fp32, not TF32.
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            if cfg.compression.mode != "none":
                # The codec kernels build here, before the watchdog arms,
                # so that nvcc's seconds are not a stalled first step.
                load_library()
        # Raises now if the native wire cannot be built.
        wire.set_native(cfg.data.native_gather)
        self.registry = MetricsRegistry()
        # Built unconditionally: disabled, every span is a shared no-op.
        self.tracer = Tracer(
            enabled=cfg.train.trace and self.rank == 0,
            service="train",
            jsonl_path=os.path.join(self.workdir, "spans.jsonl"),
            chrome_path=os.path.join(self.workdir, "trace.json"),
        )
        # The loader's producer threads and the loop time their stages
        # here; traced, each stage is a span too.
        self.timer = StageTimer(tracer=self.tracer)

        self.train_ds, self.test_ds = build_dataset(cfg.data)
        channels = self.train_ds.image_shape[-1]
        model = build_model_from_experiment(cfg, channels, self.world)
        # The schedule's horizon: the run's optimizer steps, as the JAX
        # trainer passes it (the loader's steps an epoch; on a resume too).
        super_batch = cfg.train.micro_batch_size * cfg.train.sync_period * self.world
        epoch_steps = steps_per_epoch(len(self.train_ds), super_batch)
        self.tx = build_optimizer(cfg.train, total_steps=cfg.train.epochs * epoch_steps)
        self.state = create_train_state(
            model.to(self.device), self.tx, self.world, self.shard_update,
            bucket_mb=cfg.compression.bucket_mb,
        )
        loader_kw = dict(
            micro_batch=cfg.train.micro_batch_size,
            sync_period=cfg.train.sync_period,
            device=self.device,
            shuffle=cfg.data.shuffle,
            seed=cfg.data.seed,
            replica=self.replica,
            world=self.world,
            space=self.space,
        )
        if cfg.data.device_cache:
            self.loader = DeviceCachedLoader(self.train_ds, compact=cfg.data.compact_upload, **loader_kw)
        else:
            self.loader = ShardedLoader(
                self.train_ds, compact=cfg.data.compact_upload, workers=cfg.data.loader_workers,
                native_gather=cfg.data.native_gather, timer=self.timer, **loader_kw
            )
        if self.spatial:
            self.train_step = make_train_step_spatial(
                self.tx, cfg.compression, self.world, space, seed=cfg.train.seed,
                level=self.shard_update, remat=cfg.train.remat,
            )
            self.eval_step = make_eval_step(cfg.model.num_classes, self.world * space, "stage")
        else:
            self.train_step = make_train_step(
                self.tx, cfg.compression, self.world, seed=cfg.train.seed,
                level=self.shard_update, remat=cfg.train.remat,
            )
            self.eval_step = make_eval_step(cfg.model.num_classes, self.world)
        self.perf: Optional[obs_flops.PerfAccountant] = None
        self.comm: Optional[obs_comm.CommAccountant] = None
        self._comm_probe = None
        self._comm_probed_epoch = False
        if cfg.train.perf_accounting:
            self._init_accounting(channels)
        self.checkpointer = AsyncCheckpointer(
            keep=cfg.train.keep_checkpoints,
            format=cfg.train.checkpoint_format,
            chunk_bytes=max(1, cfg.train.checkpoint_chunk_mb) << 20,
            compression=cfg.train.checkpoint_compression,
            background=cfg.train.checkpoint_async,
        )
        # Graceful preemption: SIGTERM or request_preempt() sets the event;
        # the loop finishes its step, fit() writes the emergency
        # checkpoint, and ``preempted`` tells the CLI to exit 43.
        self._preempt = threading.Event()
        self._preempt_done = threading.Event()
        # Chaos fault injection (resilience/chaos.py): None unless the
        # DDLPC_CHAOS env var schedules faults; steps count loop iterations
        # since process start, as in the JAX trainer.
        self._chaos = _chaos_mod.active()
        self._chaos_step = 0
        self._grace_timer: Optional[threading.Timer] = None
        self.preempted = False
        # Skip-replay of a mid-epoch (emergency) checkpoint: train_epoch
        # draws and drops that many batches of epoch _skip_epoch.
        self.start_epoch = 0
        self._skip_steps = 0
        self._skip_epoch = -1
        if resume:
            self._restore_synchronized()
        # Every record of the run goes through the logger (rank 0 writes).
        self.logger = MetricsLogger(self.workdir, registry=self.registry)
        # Armed by fit(); the loop beats at each data fetch, step and eval
        # batch.
        self.watchdog = StallWatchdog(
            timeout_s=cfg.train.stall_timeout_s,
            action=cfg.train.stall_action,
            log_path=os.path.join(self.workdir, "stall.log"),
            # No reference back to the Trainer: a cycle would keep a dropped
            # Trainer's device memory until the garbage collector ran.
            on_stall=functools.partial(_breadcrumb_stalled, self.workdir) if self.rank == 0 else None,
        )
        # Loss and step-time alerts, fed each epoch record, fanned out to
        # the stream, the registry and the watchdog's diagnosis.
        self.health = HealthMonitor(logger=self.logger, registry=self.registry,
                                    watchdog=self.watchdog, service="train")
        # Armed by SIGUSR2 (fit installs the handler) or /debug/trace.
        self.profiler = OnDemandProfiler(out_dir=self.workdir, steps=cfg.train.profile_steps,
                                         logger=self.logger, enabled=self.rank == 0)
        self.telemetry: Optional[TelemetryServer] = None
        if cfg.train.telemetry_port >= 0 and self.rank == 0:
            self.telemetry = TelemetryServer(
                self.registry, port=cfg.train.telemetry_port,
                health_fn=self._health_snapshot, arm_profile_fn=self._arm_profile,
            ).start()
            print(f"[telemetry] http://127.0.0.1:{self.telemetry.port}", flush=True)

    def _health_snapshot(self) -> dict:
        return {"status": "ok", "pid": os.getpid(), "alerts": list(self.health.alerts)}

    def _arm_profile(self, steps: int) -> dict:
        self.profiler.arm(steps if steps > 0 else None)
        return {
            "armed": True,
            "steps": self.profiler.steps,
            "note": "capture spans the next N training steps; the top-ops report lands "
                    "in the run workdir",
        }

    def close(self) -> None:
        """Close the telemetry endpoint and the tracer's files.  ``fit``
        leaves both open (the endpoint stays scrapeable after a fit, and
        the tracer serves a later fit), so a process that builds several
        Trainers, or binds a fixed port twice, closes the old one.
        Idempotent."""
        if self.telemetry is not None:
            self.telemetry.close()
            self.telemetry = None
        self.tracer.close()

    def _init_accounting(self, channels: int) -> None:
        """The FLOP model, the peak, the perf and comm accountants and the
        state-bytes gauges.  A FLOP model that fails warns and reads 0, as
        in the JAX trainer: accounting never stops a run."""
        cfg = self.cfg
        try:
            flops_per_step = obs_flops.conv_step_flops(
                cfg, cfg.train.micro_batch_size, cfg.train.sync_period, channels=channels
            )
            if self.spatial:
                # Each rank runs 1/space of the unpartitioned convs (the
                # halo's few rows a conv ignored), as the JAX trainer counts.
                flops_per_step //= cfg.parallel.space_axis_size
        except Exception as e:  # noqa: BLE001 — accounting must never kill the run
            warnings.warn(
                f"per-step FLOP model unavailable ({type(e).__name__}: {e}); "
                f"ddlpc_mfu will read 0",
                stacklevel=3,
            )
            flops_per_step = 0
        peak, assumed = obs_flops.resolve_peak_flops(cfg.train.peak_flops_per_device, self.device)
        self.perf = obs_flops.PerfAccountant(
            self.registry, flops_per_step=flops_per_step, peak_flops=peak,
            peak_assumed=assumed,
            # Read before this run writes its first breadcrumb.
            restart_gap_s=obs_flops.restart_gap_seconds(cfg.workdir),
        )
        obs_hbm.publish_hbm_gauges(self.registry, self.state)
        variant = obs_comm.step_variant(cfg.compression, self.shard_update, self.spatial)
        flat = self.state.params
        self.comm = obs_comm.CommAccountant(
            self.registry,
            obs_comm.comm_plan(flat.numel, flat.data.numel(), cfg.compression, self.world,
                               variant, n_buckets=len(flat.regions), level=self.shard_update),
            variant,
        )
        if cfg.train.trace and self.world > 1 and not self.spatial:
            self._comm_probe = obs_comm.make_comm_probe(
                cfg.compression, flat, self.world,
                chunked_grads=self.state.placement.chunked["grads"], seed=cfg.train.seed)

    # ------------------------------------------------------------------
    # resume

    def _restore_synchronized(self) -> None:
        """Resume with rank 0 as the one source of truth: it alone reads
        the checkpoint (the others may not see its storage) and broadcasts
        ``(found, epoch, skip)`` and then the canonical state, which each
        replica places in its own layout."""
        tree, header = None, [0, 0, 0]
        if self.rank == 0 and ckpt.latest_step(self.ckpt_dir) is not None:
            tree, meta = ckpt.restore_checkpoint(self.ckpt_dir)
            header = [1, int(meta.get("epoch", -1)) + 1, int(meta.get("mid_epoch_steps_done", 0))]
        header_t = mesh.broadcast_(torch.tensor(header, dtype=torch.int64, device=self.device))
        found, epoch_next, skip = (int(v) for v in header_t.tolist())
        if found:
            load_state_tree(self.state, tree)
            self.start_epoch = epoch_next
            self._apply_mid_epoch(skip)

    def _apply_mid_epoch(self, skip: int) -> None:
        """Arm the skip-replay for a checkpoint taken ``skip`` steps into
        epoch ``start_epoch``: those steps are in the restored state, so
        replaying them would apply them twice.  A position at or past the
        epoch's end counts as a whole epoch."""
        if skip <= 0:
            return
        if skip >= len(self.loader):
            self.start_epoch += 1
            return
        self._skip_steps = skip
        self._skip_epoch = self.start_epoch

    # ------------------------------------------------------------------
    # checkpoints and preemption

    def _metadata(self, epoch: int, lin: dict) -> dict:
        return {
            "epoch": epoch,
            "config": self.cfg.to_dict(),
            "input_channels": int(self.train_ds.image_shape[-1]),
            "lineage": lin,
        }

    def _lineage(self, step: int) -> dict:
        return lineage.make_lineage(step, run_id=self.run_id, config_hash_hex=self.config_hash)

    def _log_lineage(self, event: str, lin: dict, **fields) -> None:
        """A flat ``kind="lineage"`` record: the training side's anchor,
        which ``obs/merge.py`` joins the serving streams onto."""
        self.logger.log({"kind": "lineage", "event": event, **lineage.flatten(lin), **fields},
                        echo=False)

    def save(self, epoch: int) -> None:
        """Checkpoint the state after ``epoch``: every replica joins the
        gather of the canonical state, replica 0 writes in the background."""
        step = self.state.step
        lin = self._lineage(step)
        with self.tracer.span("checkpoint_snapshot", epoch=epoch, lineage_id=lin["lineage_id"],
                              step=step):
            self.checkpointer.save(self.ckpt_dir, self.state, step,
                                   metadata=self._metadata(epoch, lin))
        self._log_lineage("checkpoint_saved", lin, epoch=epoch)
        if self.rank == 0:
            write_breadcrumb(self.workdir, "running", epoch=epoch, last_ckpt_step=step)

    def request_preempt(self) -> None:
        """Begin a graceful preemption: the loop finishes its in-flight
        step, writes an emergency checkpoint, and ``fit`` returns with
        ``preempted`` set.  If that has not happened within
        ``train.preempt_grace_s`` the process exits 43 at once, and the
        last durable checkpoint stands.  Idempotent; safe from a signal
        handler."""
        if self._preempt.is_set():
            return
        self._preempt.set()
        if self.rank == 0:
            write_breadcrumb(self.workdir, "preempt_requested", grace_s=self.cfg.train.preempt_grace_s)
        t = threading.Timer(max(self.cfg.train.preempt_grace_s, 0.1), self._grace_expired)
        t.daemon = True
        t.start()
        self._grace_timer = t

    def _grace_expired(self) -> None:
        if self._preempt_done.is_set():
            return
        if self.rank == 0:
            write_breadcrumb(self.workdir, "preempt_timeout")
        print(
            f"[preempt] grace window ({self.cfg.train.preempt_grace_s:.0f}s) expired "
            f"before the emergency checkpoint completed — hard exit; resuming "
            f"from the last durable checkpoint",
            flush=True,
        )
        os._exit(EXIT_PREEMPTED)

    def _graceful_preempt(self, epoch: int, steps_done: int) -> None:
        """The emergency checkpoint, at an optimizer-step boundary, with the
        position in the epoch when it is not the epoch's end."""
        steps_per_epoch = len(self.loader)
        completed = epoch if steps_done >= steps_per_epoch else epoch - 1
        step = self.state.step
        lin = self._lineage(step)
        meta = dict(self._metadata(completed, lin), preempted=True)
        if 0 < steps_done < steps_per_epoch:
            meta["mid_epoch_steps_done"] = steps_done
        with self.watchdog.paused("preempt_checkpoint"):
            self.checkpointer.save(self.ckpt_dir, self.state, step, metadata=meta)
            # The one save that overlaps nothing: durable before fit returns.
            self.checkpointer.wait()
        self.logger.log({"kind": "preempt", "epoch": epoch, "steps_done": steps_done,
                         "ckpt_step": step})
        self._log_lineage("checkpoint_saved", lin, epoch=epoch, preempted=True)
        if self.rank == 0:
            write_breadcrumb(self.workdir, "preempted", epoch=epoch, steps_done=steps_done, ckpt_step=step)
        self.preempted = True
        self._preempt_done.set()
        self._stop_grace_timer()

    def _stop_grace_timer(self) -> None:
        """Cancel the grace timer and wait for its thread.  The timer holds
        this trainer (its callback is a bound method): a daemon thread that
        outlived ``fit`` could drop the last reference and free the train
        state's tensors while the interpreter finalizes, where CPython ends
        the thread and the unwind aborts the process ("terminate called
        without an active exception", ROADMAP C13)."""
        t, self._grace_timer = self._grace_timer, None
        if t is not None:
            t.cancel()
            t.join()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        self.loader.set_epoch(epoch)
        self._comm_probed_epoch = False
        metrics = []
        t_epoch = time.perf_counter()
        it = iter(self.loader)
        skipped = 0
        if self._skip_steps and epoch == self._skip_epoch:
            # Resume from a mid-epoch checkpoint: the state already holds
            # these steps, so draw and drop the same deterministic batches.
            for _ in range(self._skip_steps):
                self.watchdog.beat("resume_skip")
                if next(it, None) is None:
                    break
                skipped += 1
            self._skip_steps = 0
        sync_every = self.cfg.train.trace_sync_every_steps
        while True:
            # "data": the wait for the next batch on the device; "step": the
            # step and the device's sync that ends it, that sync sampled
            # into a "step_sync" span (a child of "epoch": stage spans
            # are recorded without a parent).
            if self._chaos is not None:
                self._chaos.on_data_fetch()
            self.watchdog.beat("data")
            with self.timer.stage("data"):
                batch = next(it, None)
            if batch is None:
                break
            self.watchdog.beat("step")
            step_idx = len(metrics) + 1
            sampled = self.cfg.train.trace and sync_every > 0 and step_idx % sync_every == 0
            with self.timer.stage("step"):
                metrics.append(self.train_step(self.state, *batch))
                with (self.tracer.span("step_sync", epoch=epoch, step=step_idx) if sampled
                      else contextlib.nullcontext()):
                    self._sync()
            if self.comm is not None:
                self.comm.on_step()
            if self._chaos is not None:
                self._chaos_step += 1
                # kill/stall act inside on_step; preempt comes back as an
                # action so it runs the trainer's own graceful path.
                if "preempt" in self._chaos.on_step(self._chaos_step):
                    self.request_preempt()
            if self._preempt.is_set():
                raise PreemptedRun(epoch, skipped + len(metrics))
            if sampled and self._comm_probe is not None and not self._comm_probed_epoch:
                self._sample_comm(epoch)
            # The on-demand profiler (a no-op unless armed).
            self.profiler.step_done(sync=self._sync)
        if not metrics:
            raise RuntimeError(
                f"epoch {epoch} produced 0 training steps: dataset has "
                f"{len(self.train_ds)} tiles against super-batch "
                f"{self.loader.super_batch}"
            )
        epoch_time = time.perf_counter() - t_epoch
        host = [{k: float(v) for k, v in m.items()} for m in metrics]
        steps = len(host)
        record = {
            "epoch": epoch,
            "loss": float(np.mean([m["loss"] for m in host])),
            "pixel_acc": float(np.mean([m["pixel_acc"] for m in host])),
            "grad_norm": host[-1]["grad_norm"],
            "epoch_time_s": epoch_time,
            # The JAX trainer's step time: the epoch over its steps.
            "step_time_s": epoch_time / steps,
            "tiles_per_s": steps * self.loader.super_batch / epoch_time,
        }
        if skipped:
            # A partial epoch: its means cover the steps after the resume.
            record["resumed_mid_epoch_at_step"] = skipped
        wrap = len(self.loader) * self.loader.super_batch / len(self.train_ds)
        if wrap > 1.0 + 1e-9:
            record["wrap_fill_factor"] = round(wrap, 2)
        record.update({f"t_{name}_s": t for name, t in self.timer.means().items()})
        if self.perf is not None:
            # The step stage is productive; the wait for data is a debit
            # (the producer's stages overlap the steps and are not).
            totals = self.timer.summary()
            self.perf.productive(totals.get("step", 0.0), steps)
            self.perf.debit("data", totals.get("data", 0.0))
        self.timer.reset()
        return record

    def _sample_comm(self, epoch: int) -> None:
        """The fenced comm probe, at most once an epoch on the sampled
        step.  It is a collective, so the world drops it as one: where a
        replica cannot make its gradient, every replica is told so before
        the probe's own collectives (``CommProbeDeclined``), warns, and
        runs on without it.  An error inside the probe's sync propagates
        on this replica, as one inside the step's sync does."""
        self._comm_probed_epoch = True
        t_probe = time.perf_counter()
        try:
            with self.tracer.span("comm_probe", epoch=epoch):
                self.comm.record_probe(self._comm_probe())
        except obs_comm.CommProbeDeclined as e:
            warnings.warn(f"comm probe declined ({e}); disabling for this run", stacklevel=3)
            self._comm_probe = None
        if self.perf is not None:
            self.perf.debit("probe", time.perf_counter() - t_probe)

    def evaluate(self) -> Dict[str, float]:
        """Held-out loss, pixel accuracy and mIoU over the test split, in
        batches of the micro-batch size on every replica (the eval step sums
        over the replicas); the batches' sums are fetched once, at the end,
        and accumulated in float64 on the host."""
        if len(self.test_ds) == 0:
            return {}
        per_batch = []
        for images, labels in eval_batches(
            self.test_ds, self.cfg.train.micro_batch_size, self.device,
            self.replica, self.world, self.space,
        ):
            self.watchdog.beat("eval")
            out = self.eval_step(self.state, images, labels)
            per_batch.append((out["confusion"], out["loss_sum"], out["pixel_count"]))
        # The fetch waits for every queued eval batch at once, which may
        # take longer than a step: detection pauses, as in the JAX trainer.
        with self.watchdog.paused("eval_metrics_fetch"):
            per_batch = [tuple(t.double().cpu() for t in b) for b in per_batch]
        n = self.cfg.model.num_classes
        cm = np.zeros((n, n), np.float64)
        loss_sum = 0.0
        pixels = 0.0
        for conf, nll, px in per_batch:
            cm += conf.numpy()
            loss_sum += float(nll)
            pixels += float(px)
        cmt = torch.from_numpy(cm)
        return {
            "val_loss": loss_sum / max(pixels, 1.0),
            "val_pixel_acc": float(accuracy_from_confusion(cmt)),
            "val_miou": float(mean_iou(cmt)),
            "val_iou_per_class": [round(float(v), 4) for v in iou_per_class(cmt)],
        }

    @torch.no_grad()
    def predict(self, images: np.ndarray) -> np.ndarray:
        """Class maps ``[N,H,W]`` of ``images [N,H,W,C]``: an eval-mode
        forward and the argmax over the classes (the first of equal
        maxima, as ``jnp.argmax``)."""
        model = self.state.model
        model.eval()
        # Whole tiles on one rank: the halos are off (eval-mode BatchNorm
        # reads its running statistics, no collective).
        with space_off(model):
            logits = model(torch.from_numpy(np.ascontiguousarray(images)).to(self.device))
        return logits.argmax(-1).cpu().numpy()

    def dump_images(self, epoch: int) -> None:
        """The prediction, label and image PNGs of the first
        ``train.dump_images_per_epoch`` test tiles (rank 0)."""
        n = min(self.cfg.train.dump_images_per_epoch, len(self.test_ds))
        self.state.gather_params()  # zero3: every replica joins
        if n <= 0 or self.rank != 0:
            return
        images = self.test_ds.images[:n]
        dump_prediction_triples(
            self.workdir, images, self.test_ds.labels[:n], self.predict(images),
            self.cfg.model.num_classes, epoch, max_samples=n,
        )

    def fit(self) -> Dict[str, float]:
        """Run the training from ``start_epoch``; returns the last epoch's
        record (``preempted`` tells whether a preemption cut it short)."""
        cfg = self.cfg.train
        record: Dict[str, float] = {}
        # SIGUSR2 → arm the on-demand profiler; SIGTERM → graceful
        # preemption.  Only the main thread may install a handler, so an
        # embedded fit arms by /debug/trace or profiler.arm() and preempts
        # by request_preempt().
        prev_usr2 = prev_term = None
        try:
            prev_usr2 = signal.signal(signal.SIGUSR2, lambda signum, frame: self.profiler.arm())
            prev_term = signal.signal(signal.SIGTERM, lambda signum, frame: self.request_preempt())
        except ValueError:
            pass
        if self.rank == 0:
            # The run's config beside its checkpoints, as the JAX trainer
            # writes it: what the serve engine and predict restore from.
            atomic_write_text(os.path.join(self.workdir, "config.json"), self.cfg.to_json(),
                              durable=False)
            write_breadcrumb(self.workdir, "running", start_epoch=self.start_epoch, epochs=cfg.epochs)
        if self.perf is not None:
            self.perf.start()
        try:
            with self.watchdog:
                try:
                    for epoch in range(self.start_epoch, cfg.epochs):
                        if self._preempt.is_set():
                            raise PreemptedRun(epoch, 0)
                        with self.tracer.span("epoch", epoch=epoch):
                            with maybe_profile(os.path.join(self.workdir, "profile"),
                                               enabled=epoch == cfg.profile_epoch):
                                record = self.train_epoch(epoch)
                        if cfg.eval_every_epochs and (epoch + 1) % cfg.eval_every_epochs == 0:
                            t_eval = time.perf_counter()
                            with self.tracer.span("evaluate", epoch=epoch):
                                record.update(self.evaluate())
                            if self.perf is not None:
                                self.perf.debit("eval", time.perf_counter() - t_eval)
                        if self._chaos is not None:
                            # nan@N: poison what the stream and the
                            # health detectors see.
                            record = self._chaos.corrupt_record(record)
                        self.logger.log(record)
                        self.health.observe_train(record)
                        if cfg.checkpoint_every_epochs and (epoch + 1) % cfg.checkpoint_every_epochs == 0:
                            t_ckpt = time.perf_counter()
                            with self.watchdog.paused("checkpoint"):
                                self.save(epoch)
                            if self.perf is not None:
                                # The training thread's stall, not the
                                # background write.
                                self.perf.debit("checkpoint", time.perf_counter() - t_ckpt)
                        if self.perf is not None:
                            step_time = record.get("step_time_s")
                            self.logger.log(self.perf.publish(step_time_s=step_time), echo=False)
                            self.logger.log(self.comm.publish(step_time_s=step_time), echo=False)
                        if cfg.dump_images_per_epoch:
                            with self.watchdog.paused("image_dump"):
                                self.dump_images(epoch)
                    else:
                        if self.rank == 0:
                            write_breadcrumb(self.workdir, "done", epochs=cfg.epochs)
                except PreemptedRun as p:
                    self._graceful_preempt(p.epoch, p.steps_done)
                finally:
                    # No return with a write in flight; a writer failure is
                    # raised here, on the training thread.
                    with self.watchdog.paused("checkpoint_flush"):
                        with self.tracer.span("checkpoint_barrier"):
                            self.checkpointer.close()
        finally:
            if prev_usr2 is not None:
                signal.signal(signal.SIGUSR2, prev_usr2)
            if prev_term is not None:
                signal.signal(signal.SIGTERM, prev_term)
            self._preempt_done.set()
            self._stop_grace_timer()
            # A capture the run ended in the middle of still reports the
            # steps that ran; the trace is written at every exit of fit.
            self.profiler.finalize(sync=self._sync)
            self.tracer.flush()
        return record
