"""Single-device batcher: the seeded epoch sampler and super-batch upload.

``EpochSampler`` is ``ddlpc_tpu/data/loader.py:_EpochSampler``: the same
per-epoch permutation (``default_rng(seed + epoch).shuffle``) and the same
wrap-fill, so a run trains on the same tiles in the same order as the
reference.  ``DeviceLoader`` stacks one optimizer step's ``sync_period``
micro-batches as images ``[A,B,H,W,C]`` float32 and labels ``[A,B,H,W]``
int64 and copies them to the device from pinned host memory without
blocking the host.  The native gather kernel and the device-resident cache
of the reference are not ported yet.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from ddlpc_tpu_torch.data.datasets import TileDataset


class EpochSampler:
    """Seeded per-epoch permutation, wrap-filled to whole super-batches
    (the reference's default ``tail='wrap'``, the only one ported)."""

    def __init__(
        self,
        dataset: TileDataset,
        super_batch: int,
        shuffle: bool = True,
        seed: int = 0,
    ):
        if len(dataset) == 0:
            raise ValueError("dataset is empty")
        self.ds = dataset
        self.super_batch = super_batch
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        return -(-len(self.ds) // self.super_batch)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        return np.resize(idx, len(self) * self.super_batch)


class DeviceLoader(EpochSampler):
    """Iterates ``(images [A,B,H,W,C], labels [A,B,H,W])`` on ``device``,
    one item per optimizer step (A = ``sync_period``, B = micro-batch)."""

    def __init__(
        self,
        dataset: TileDataset,
        micro_batch: int,
        sync_period: int,
        device: torch.device,
        shuffle: bool = True,
        seed: int = 0,
    ):
        super().__init__(dataset, micro_batch * sync_period, shuffle=shuffle, seed=seed)
        self.micro_batch = micro_batch
        self.sync_period = sync_period
        self.device = device

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        idx = self.epoch_indices()
        a, b = self.sync_period, self.micro_batch
        for start in range(0, len(idx) - self.super_batch + 1, self.super_batch):
            images, labels = self.ds.gather(idx[start : start + self.super_batch])
            yield (
                to_device(images.reshape(a, b, *images.shape[1:]), self.device),
                to_device(
                    labels.reshape(a, b, *labels.shape[1:]).astype(np.int64),
                    self.device,
                ),
            )


def eval_batches(
    dataset: TileDataset, batch: int, device: torch.device
) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Fixed-order eval batches ``[b,H,W,C]`` / ``[b,H,W]``; the tail batch is
    simply shorter (eager execution needs no padding to a static shape)."""
    for start in range(0, len(dataset), batch):
        images, labels = dataset.gather(
            np.arange(start, min(start + batch, len(dataset)))
        )
        yield to_device(images, device), to_device(labels.astype(np.int64), device)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array → ``device``: through pinned memory with a non-blocking
    copy on CUDA, a plain tensor on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
