"""The batcher: the seeded epoch sampler, each replica's shard of it, and
the super-batch upload.

``EpochSampler`` is ``ddlpc_tpu/data/loader.py:_EpochSampler``: the same
per-epoch permutation (``default_rng(seed + epoch).shuffle``) and the same
wrap-fill, so a run trains on the same tiles in the same order as the
reference.  ``DeviceLoader`` stacks one optimizer step's ``sync_period``
micro-batches as images ``[A,B,H,W,C]`` float32 and labels ``[A,B,H,W]``
int64 and copies them to the device from pinned host memory without
blocking the host.  In a world of W replicas every replica computes the
same permutation and takes its own columns ``[r·B, (r+1)·B)`` of each
``[A, W·B]`` super-batch, as ``ShardedLoader`` does per process
(``loader.py:305-313``).  The native gather kernel and the
device-resident cache of the reference are not ported yet.
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
    one item per optimizer step (A = ``sync_period``, B = ``micro_batch``,
    the per-replica micro-batch), for replica ``replica`` of ``world``."""

    def __init__(
        self,
        dataset: TileDataset,
        micro_batch: int,
        sync_period: int,
        device: torch.device,
        shuffle: bool = True,
        seed: int = 0,
        replica: int = 0,
        world: int = 1,
    ):
        if not 0 <= replica < world:
            raise ValueError(f"replica {replica} is not in a world of {world}")
        super().__init__(dataset, micro_batch * world * sync_period, shuffle=shuffle, seed=seed)
        self.micro_batch = micro_batch
        self.sync_period = sync_period
        self.device = device
        self.replica = replica
        self.world = world

    def index_chunks(self) -> Iterator[np.ndarray]:
        """This replica's flat tile indices ``[A·B]``, one array per
        super-batch."""
        idx = self.epoch_indices()
        a, b, r = self.sync_period, self.micro_batch, self.replica
        for start in range(0, len(idx) - self.super_batch + 1, self.super_batch):
            chunk = idx[start : start + self.super_batch].reshape(a, self.world * b)
            yield chunk[:, r * b : (r + 1) * b].reshape(-1)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        a, b = self.sync_period, self.micro_batch
        for local in self.index_chunks():
            images, labels = self.ds.gather(local)
            yield (
                to_device(images.reshape(a, b, *images.shape[1:]), self.device),
                to_device(
                    labels.reshape(a, b, *labels.shape[1:]).astype(np.int64),
                    self.device,
                ),
            )


def eval_indices(n: int, batch: int, replica: int = 0, world: int = 1):
    """``(tile indices, valid mask)`` of each of replica ``replica``'s eval
    batches over ``n`` tiles in fixed order.  One replica: batches of
    ``batch``, the tail simply shorter (eager execution needs no static
    shape).  ``world`` replicas: global batches of ``world · batch``, the
    tail padded with the last tile as the JAX package's ``eval_batches``
    pads it (``loader.py:616-656``), each replica taking its ``batch``
    columns and its padded positions marked invalid."""
    if world == 1:
        for start in range(0, n, batch):
            idx = np.arange(start, min(start + batch, n))
            yield idx, np.ones(len(idx), bool)
        return
    global_batch = world * batch
    own = np.arange(replica * batch, (replica + 1) * batch)
    for start in range(0, n, global_batch):
        idx = np.arange(start, min(start + global_batch, n))
        valid = len(idx)
        if valid < global_batch:
            idx = np.concatenate([idx, np.full(global_batch - valid, idx[-1])])
        yield idx[own], own < valid


def eval_batches(
    dataset: TileDataset, batch: int, device: torch.device, replica: int = 0, world: int = 1
) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Fixed-order eval batches ``[b,H,W,C]`` / ``[b,H,W]`` of this
    replica (:func:`eval_indices`); padded tiles carry label −1, which the
    metrics mask out."""
    for idx, valid in eval_indices(len(dataset), batch, replica, world):
        images, labels = dataset.gather(idx)
        labels = labels.astype(np.int64)
        labels[~valid] = -1
        yield to_device(images, device), to_device(labels, device)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array → ``device``: through pinned memory with a non-blocking
    copy on CUDA, a plain tensor on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
