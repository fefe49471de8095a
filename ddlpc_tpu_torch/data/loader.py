"""The batchers: the seeded epoch sampler, each replica's shard of it, and
three ways to put a super-batch on the device, byte for byte the same.

``EpochSampler`` is ``ddlpc_tpu/data/loader.py:_EpochSampler``: the same
per-epoch permutation (``default_rng(seed + epoch).shuffle``) and the same
wrap-fill, so a run trains on the same tiles in the same order as the
reference.  Each loader yields one optimizer step's ``sync_period``
micro-batches as images ``[A,B,H,W,C]`` float32 and labels ``[A,B,H,W]``
int64 on its device.  In a world of W replicas every replica computes the
same permutation and takes its own columns ``[r·B, (r+1)·B)`` of each
``[A, W·B]`` super-batch (``DeviceLoader.index_chunks``), as the JAX
``ShardedLoader`` does per process (``loader.py:305-313``).

- :class:`DeviceLoader`: numpy gathers the tiles, and they go to the
  device through pinned memory, one batch at a time.  The plain version
  the other two are held against.
- :class:`DeviceCachedLoader` (``data.device_cache``): the split is
  uploaded once and each super-batch is gathered on the device, the JAX
  ``DeviceCachedLoader``.
- :class:`ShardedLoader` (the host path, ``device_cache`` off): a producer
  thread gathers up to ``prefetch`` batches ahead into a ring of pinned
  buffers (with ``native_gather``, the port's ``dwb_gather_pack``) and
  copies them to the device, the JAX ``ShardedLoader``.
"""

from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ddlpc_tpu_torch.data.datasets import TileDataset
from ddlpc_tpu_torch.utils import native


def steps_per_epoch(n_tiles: int, super_batch: int) -> int:
    """Optimizer steps an epoch: the tiles wrap-filled to whole super-batches."""
    return -(-n_tiles // super_batch)


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
        return steps_per_epoch(len(self.ds), self.super_batch)

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



class DeviceCachedLoader(DeviceLoader):
    """The train split on the device, uploaded once (images fp32
    ``[N,H,W,C]``, labels int32 ``[N,H,W]``); each super-batch is
    ``index_select``-ed there into ``[A,B,H,W,C]``/``[A,B,H,W]``, the
    labels widened to int64 on the device.  The batches are
    :class:`DeviceLoader`'s, byte for byte.

    In a world of W processes each rank caches the whole split and gathers
    only its own columns.  That reproduces the batches of the JAX
    package's single-process ``data=W`` mesh, which replicates its cache
    on every device and reshards each gathered super-batch over the data
    axis; JAX refuses the cache under more than one process because its
    processes are hosts of a multi-host mesh, which the port does not
    have."""

    def __init__(self, dataset: TileDataset, *args, **kwargs):
        super().__init__(dataset, *args, **kwargs)
        self._images = torch.from_numpy(dataset.images).to(self.device)
        self._labels = torch.from_numpy(dataset.labels).to(self.device)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        a, b = self.sync_period, self.micro_batch
        for local in self.index_chunks():
            idx = torch.from_numpy(local).to(self.device)
            # One expression, so that no local keeps the int32 gather alive
            # while the consumer holds the batch.
            yield (self._images.index_select(0, idx).view(a, b, *self._images.shape[1:]),
                   self._labels.index_select(0, idx).view(a, b, *self._labels.shape[1:]).long())


class _Slot:
    """A ring entry: the ``[A,B,H,W,C]`` fp32 / ``[A,B,H,W]`` int32 host
    destination (pinned on a card) and the CUDA event of the last copy that
    read it (None on the CPU, where the copy is done when it returns)."""

    __slots__ = ("imgs", "labs", "copied")

    def __init__(self, imgs: torch.Tensor, labs: torch.Tensor):
        self.imgs = imgs
        self.labs = labs
        self.copied: Optional[torch.cuda.Event] = None


class _Ring:
    """A fixed pool of slots.  ``acquire`` blocks until a slot is free and
    its last copy to the device has finished, so a gather never overwrites
    a batch still in flight (the JAX ring's ``block_until_ready``)."""

    def __init__(self, slots: List[_Slot]):
        self._slots = slots
        self._cv = threading.Condition()

    def acquire(self) -> _Slot:
        with self._cv:
            while not self._slots:
                self._cv.wait()
            slot = self._slots.pop()
        if slot.copied is not None:
            slot.copied.synchronize()
        return slot

    def release(self, slot: _Slot) -> None:
        with self._cv:
            self._slots.append(slot)
            self._cv.notify()


class ShardedLoader(DeviceLoader):
    """The host path: one producer thread gathers each super-batch into a
    slot of a ring of ``prefetch + 1`` host buffers, pinned on a card, and
    copies it to the device without blocking, up to ``prefetch`` batches
    ahead of the consumer.  With ``native_gather`` the gather is the port's
    ``dwb_gather_pack`` (``kernels/host/batch.cc``, one multithreaded pass
    straight into the slot), else numpy's ``take``; a failed build of the
    native library raises (``utils/native.NativeBuildError``).  Labels go
    to the device as int32 and are widened there.  The batches are
    :class:`DeviceLoader`'s, byte for byte.

    ``timer`` (a ``train/observability.StageTimer``) gets the producer's
    ``loader_gather`` and ``loader_upload`` stages."""

    def __init__(
        self,
        dataset: TileDataset,
        *args,
        native_gather: bool = True,
        prefetch: int = 2,
        timer=None,
        **kwargs,
    ):
        super().__init__(dataset, *args, **kwargs)
        if prefetch < 1:
            raise ValueError(f"prefetch must be >= 1, got {prefetch}")
        self.prefetch = prefetch
        self.timer = timer
        self._native = native.load_batch() if native_gather else None
        self._ring: Optional[_Ring] = None

    def _stage(self, name: str):
        return self.timer.stage(f"loader_{name}") if self.timer is not None else nullcontext()

    def _get_ring(self) -> _Ring:
        if self._ring is None:
            a, b = self.sync_period, self.micro_batch
            h, w, c = self.ds.image_shape
            pin = self.device.type == "cuda"
            self._ring = _Ring([
                _Slot(torch.empty((a, b, h, w, c), dtype=torch.float32, pin_memory=pin),
                      torch.empty((a, b, h, w), dtype=torch.int32, pin_memory=pin))
                for _ in range(self.prefetch + 1)
            ])
        return self._ring

    def _gather(self, flat: np.ndarray, slot: _Slot) -> None:
        images, labels = self.ds.images, self.ds.labels
        imgs, labs = slot.imgs.numpy(), slot.labs.numpy()
        if self._native is not None:
            self._native.gather_pack(images, labels, flat, imgs, labs)
            return
        if len(flat) and (flat.min() < 0 or flat.max() >= len(images)):
            raise IndexError(f"gather index out of range for dataset of {len(images)} tiles")
        # mode='clip' writes straight into ``out`` (numpy buffers 'raise');
        # the bounds are checked above.
        np.take(images, flat, axis=0, mode="clip", out=imgs.reshape(len(flat), *images.shape[1:]))
        np.take(labels, flat, axis=0, mode="clip", out=labs.reshape(len(flat), *labels.shape[1:]))

    def _produce(self, flat: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        ring = self._get_ring()
        slot = ring.acquire()
        try:
            with self._stage("gather"):
                self._gather(np.ascontiguousarray(flat, np.int64), slot)
            with self._stage("upload"):
                if self.device.type != "cuda":
                    return slot.imgs.clone(), slot.labs.long()
                with torch.cuda.device(self.device):
                    imgs = slot.imgs.to(self.device, non_blocking=True)
                    labs = slot.labs.to(self.device, non_blocking=True)
                    slot.copied = torch.cuda.Event()
                    slot.copied.record()
                    return imgs, labs.long()
        finally:
            ring.release(slot)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """Batches in epoch order, the gather and copy of up to
        ``prefetch`` later ones running on the producer thread meanwhile.
        A producer's exception surfaces at its batch."""
        self._get_ring()
        with ThreadPoolExecutor(max_workers=1, thread_name_prefix="loader") as ex:
            pending: deque = deque()
            for flat in self.index_chunks():
                pending.append(ex.submit(self._produce, flat))
                while len(pending) > self.prefetch:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()


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
