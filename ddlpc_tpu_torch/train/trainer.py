"""The training loop — the port's copy of ``ddlpc_tpu/train/trainer.py``
for one device.

``Trainer.fit()`` does what the JAX ``Trainer.fit`` does on one device:
epochs of optimizer steps over the seeded, wrap-filled loader, a held-out
evaluation every ``eval_every_epochs``, and one logged record per epoch
(loss, pixel accuracy, grad norm, step time, and the eval's loss, pixel
accuracy and mIoU).  Records print as JSON lines and append to
``<workdir>/metrics.jsonl``.

Settings this slice does not implement raise ``NotImplementedError`` when
enabled, all of them in one message that names the ``--set`` overrides
which switch them off; none is silently ignored.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ddlpc_tpu_torch import resolve_device
from ddlpc_tpu_torch.config import ExperimentConfig
from ddlpc_tpu_torch.data.datasets import build_dataset
from ddlpc_tpu_torch.data.loader import DeviceLoader, eval_batches
from ddlpc_tpu_torch.models import build_model
from ddlpc_tpu_torch.ops.metrics import accuracy_from_confusion, iou_per_class, mean_iou
from ddlpc_tpu_torch.parallel.grad_sync import check_supported
from ddlpc_tpu_torch.parallel.train_step import (
    create_train_state,
    make_eval_step,
    make_train_step,
)
from ddlpc_tpu_torch.train.optim import build_optimizer


def unsupported_settings(cfg: ExperimentConfig) -> List[str]:
    """``key=value`` overrides that switch off every enabled setting this
    slice does not implement (empty when the config is supported)."""
    t, d, p = cfg.train, cfg.data, cfg.parallel
    checks = [  # (key, enabled, value that switches it off)
        ("train.checkpoint_every_epochs", t.checkpoint_every_epochs != 0, 0),
        ("train.dump_images_per_epoch", t.dump_images_per_epoch != 0, 0),
        ("train.profile_epoch", t.profile_epoch >= 0, -1),
        ("train.stall_timeout_s", t.stall_timeout_s != 0, 0.0),
        ("train.trace", t.trace, False),
        ("train.telemetry_port", t.telemetry_port >= 0, -1),
        ("train.perf_accounting", t.perf_accounting, False),
        ("train.remat", t.remat, False),
        ("data.device_cache", d.device_cache, False),
        ("data.native_gather", d.native_gather, False),
        ("data.compact_upload", d.compact_upload, False),
        ("data.augment", d.augment, False),
        ("data.lazy_tiles", d.lazy_tiles, False),
        ("data.mmap_scenes", d.mmap_scenes, False),
        ("data.crops_per_epoch", d.crops_per_epoch != 0, 0),
        ("data.loader_workers", d.loader_workers != 1, 1),
        ("parallel.data_axis_size", p.data_axis_size not in (-1, 1), 1),
        ("parallel.space_axis_size", p.space_axis_size != 1, 1),
        ("parallel.pipeline_stages", p.pipeline_stages != 1, 1),
    ]
    return [f"{key}={value!r}" for key, enabled, value in checks if enabled]


class Trainer:
    """One device: data, model, state, the train and eval steps, the loop.

    ``device`` is ``'cuda'`` unless the caller asks for ``'cpu'``; without
    CUDA and without ``device='cpu'`` construction raises.  ``resume`` is
    accepted for the CLI's sake: checkpoints are not ported, so an existing
    ``<workdir>/checkpoints`` raises rather than being ignored."""

    def __init__(
        self,
        cfg: ExperimentConfig,
        resume: bool = True,
        device: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        off = unsupported_settings(cfg)
        if off:
            raise NotImplementedError(
                "settings not yet ported by ddlpc_tpu_torch; switch them off "
                "with " + " ".join(f"--set {o}" for o in off)
            )
        if cfg.model.num_classes != cfg.data.num_classes:
            raise ValueError(
                f"model.num_classes={cfg.model.num_classes} != "
                f"data.num_classes={cfg.data.num_classes}"
            )
        check_supported(cfg.compression)
        self.cfg = cfg
        self.workdir = cfg.workdir
        if resume and os.path.isdir(os.path.join(self.workdir, "checkpoints")):
            raise NotImplementedError(
                f"{self.workdir}/checkpoints exists but checkpoint restore is "
                "not yet ported; pass --no-resume or another --workdir"
            )
        if self.device.type == "cuda":
            # fp32 convolutions and matmuls run in true fp32, not TF32.
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False

        self.train_ds, self.test_ds = build_dataset(cfg.data)
        channels = self.train_ds.image_shape[-1]
        model = build_model(cfg.model, in_channels=channels, seed=cfg.train.seed)
        self.tx = build_optimizer(cfg.train)
        self.state = create_train_state(model.to(self.device), self.tx)
        self.loader = DeviceLoader(
            self.train_ds,
            micro_batch=cfg.train.micro_batch_size,
            sync_period=cfg.train.sync_period,
            device=self.device,
            shuffle=cfg.data.shuffle,
            seed=cfg.data.seed,
        )
        self.train_step = make_train_step(self.tx, cfg.compression)
        self.eval_step = make_eval_step(cfg.model.num_classes)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        self.loader.set_epoch(epoch)
        metrics = []
        step_times = []
        t_epoch = time.perf_counter()
        for images, labels in self.loader:
            t0 = time.perf_counter()
            metrics.append(self.train_step(self.state, images, labels))
            self._sync()
            step_times.append(time.perf_counter() - t0)
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
            "step_time_s": float(np.mean(step_times)),
            "tiles_per_s": steps * self.loader.super_batch / epoch_time,
        }
        wrap = len(self.loader) * self.loader.super_batch / len(self.train_ds)
        if wrap > 1.0 + 1e-9:
            record["wrap_fill_factor"] = round(wrap, 2)
        return record

    def evaluate(self) -> Dict[str, float]:
        """Held-out loss, pixel accuracy and mIoU over the test split, in
        batches of the micro-batch size; float64 accumulation on the host."""
        if len(self.test_ds) == 0:
            return {}
        n = self.cfg.model.num_classes
        cm = np.zeros((n, n), np.float64)
        loss_sum = 0.0
        pixels = 0.0
        for images, labels in eval_batches(
            self.test_ds, self.cfg.train.micro_batch_size, self.device
        ):
            out = self.eval_step(self.state, images, labels)
            cm += out["confusion"].double().cpu().numpy()
            loss_sum += float(out["loss_sum"])
            pixels += float(out["pixel_count"])
        cmt = torch.from_numpy(cm)
        return {
            "val_loss": loss_sum / max(pixels, 1.0),
            "val_pixel_acc": float(accuracy_from_confusion(cmt)),
            "val_miou": float(mean_iou(cmt)),
            "val_iou_per_class": [round(float(v), 4) for v in iou_per_class(cmt)],
        }

    def _log(self, record: Dict) -> None:
        line = json.dumps(record)
        print(line, flush=True)
        os.makedirs(self.workdir, exist_ok=True)
        with open(os.path.join(self.workdir, "metrics.jsonl"), "a") as f:
            f.write(line + "\n")

    def fit(self) -> Dict[str, float]:
        """Run the training; returns the last epoch's record."""
        cfg = self.cfg.train
        record: Dict[str, float] = {}
        for epoch in range(cfg.epochs):
            record = self.train_epoch(epoch)
            if cfg.eval_every_epochs and (epoch + 1) % cfg.eval_every_epochs == 0:
                record.update(self.evaluate())
            self._log(record)
        return record
