"""The batchers: the seeded epoch sampler, each replica's shard of it, and
three ways to put a super-batch on the device, byte for byte the same.

``EpochSampler`` is ``ddlpc_tpu/data/loader.py:_EpochSampler``: the same
per-epoch permutation (``default_rng(seed + epoch).shuffle``) and the same
wrap-fill, so a run trains on the same tiles in the same order as the
reference; ``set_epoch`` also sets the dataset's epoch (crop plans and
augmentations are drawn per epoch).  Each loader yields one optimizer
step's ``sync_period`` micro-batches as images ``[A,B,H,W,C]`` and labels
``[A,B,H,W]`` int64 on its device.  In a world of W replicas every replica
computes the same permutation and takes its own columns ``[r·B, (r+1)·B)``
of each ``[A, W·B]`` super-batch (``DeviceLoader.index_chunks``), as the
JAX ``ShardedLoader`` does per process (``loader.py:305-313``).

On a ``data × space`` grid (``space=(s, S)``, the JAX loaders'
``space_axis``) rank ``(d, s)`` takes data shard ``d``'s columns as above
and of each tile only the rows ``[s·H/S, (s+1)·H/S)``, of images and
labels alike: the bytes of JAX's shard on mesh position ``(d, s)``.

``compact`` (``data.compact_upload``) ships the images as bfloat16 and the
labels as int8 (:func:`compact_cast`, the JAX ``_compact_cast``): the
images arrive on the device as bf16, which every model casts to its
compute dtype first, and the labels are widened to int64 there.

- :class:`DeviceLoader`: numpy gathers the tiles (``dataset.gather``), and
  they go to the device through pinned memory, one batch at a time.  The
  plain version the other two are held against.
- :class:`DeviceCachedLoader` (``data.device_cache``): the split is
  uploaded once and each super-batch is gathered on the device, the JAX
  ``DeviceCachedLoader``.
- :class:`ShardedLoader` (the host path, ``device_cache`` off): producer
  threads assemble batches ahead into a ring of pinned buffers and copy
  them to the device, the JAX ``ShardedLoader``.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ddlpc_tpu_torch.analysis import lockcheck
from ddlpc_tpu_torch.data.datasets import TileDataset, gather_into
from ddlpc_tpu_torch.utils import native


def steps_per_epoch(n_tiles: int, super_batch: int) -> int:
    """Optimizer steps an epoch: the tiles wrap-filled to whole super-batches."""
    return -(-n_tiles // super_batch)


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 → the bit patterns (uint16) of bfloat16, rounded to nearest
    even as ``ml_dtypes`` rounds (numpy has no bfloat16): a NaN becomes
    the quiet NaN of its sign, ±inf and overflow ±inf, subnormals round
    like any other value."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    rne = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)
    nan = (((bits >> 16) & 0x8000) | 0x7FC0).astype(np.uint16)
    return np.where((bits & 0x7FFFFFFF) > 0x7F800000, nan, rne)


def compact_cast(imgs: np.ndarray, labs: np.ndarray, img_out: np.ndarray,
                 lab_out: np.ndarray) -> None:
    """fp32/int32 tiles into bf16 bits (uint16 or int16) and int8 buffers,
    a tile at a time (no batch-sized temporaries).  Labels must fit int8
    with the -1 void sentinel (``utils/native.check_label_range``)."""
    if labs.size:
        native.check_label_range(labs.min(), labs.max())
    img_out = img_out.reshape(imgs.shape).view(np.uint16)
    for i in range(len(imgs)):
        img_out[i] = bf16_bits(imgs[i])
    np.copyto(lab_out.reshape(labs.shape), labs, casting="unsafe")


def _compact_arrays(imgs: np.ndarray, labs: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`compact_cast` into new bf16/int8 tensors."""
    img_t = torch.empty(imgs.shape, dtype=torch.bfloat16)
    lab_t = torch.empty(labs.shape, dtype=torch.int8)
    compact_cast(imgs, labs, img_t.view(torch.int16).numpy(), lab_t.numpy())
    return img_t, lab_t


class EpochSampler:
    """Seeded per-epoch permutation, wrap-filled to whole super-batches
    (the reference's default ``tail='wrap'``, the only one ported)."""

    def __init__(
        self,
        dataset,
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
        self.ds.set_epoch(epoch)

    def epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        return np.resize(idx, len(self) * self.super_batch)


def space_rows(height: int, space: Tuple[int, int]) -> slice:
    """Rank ``space = (s, S)``'s rows of a tile ``height`` rows high."""
    s, n = space
    if not 0 <= s < n:
        raise ValueError(f"space index {s} is not in a space axis of {n}")
    if height % n:
        raise ValueError(f"tile height {height} does not split into {n} space shards")
    rows = height // n
    return slice(s * rows, (s + 1) * rows)


class DeviceLoader(EpochSampler):
    """Iterates ``(images [A,B,H,W,C], labels [A,B,H,W])`` on ``device``,
    one item per optimizer step (A = ``sync_period``, B = ``micro_batch``,
    the per-replica micro-batch), for replica ``replica`` of ``world``;
    images fp32, or bf16 with ``compact``.  ``space = (s, S)``: only rows
    :func:`space_rows` of each tile (H becomes H/S)."""

    def __init__(
        self,
        dataset,
        micro_batch: int,
        sync_period: int,
        device: torch.device,
        shuffle: bool = True,
        seed: int = 0,
        replica: int = 0,
        world: int = 1,
        compact: bool = False,
        space: Tuple[int, int] = (0, 1),
    ):
        if not 0 <= replica < world:
            raise ValueError(f"replica {replica} is not in a world of {world}")
        self.rows = space_rows(dataset.image_shape[0], space)
        self.space = space
        super().__init__(dataset, micro_batch * world * sync_period, shuffle=shuffle, seed=seed)
        self.micro_batch = micro_batch
        self.sync_period = sync_period
        self.device = device
        self.replica = replica
        self.world = world
        self.compact = compact

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
            images, labels = images[:, self.rows], labels[:, self.rows]
            images = images.reshape(a, b, *images.shape[1:])
            labels = labels.reshape(a, b, *labels.shape[1:])
            if self.compact:
                img_t, lab_t = _compact_arrays(images, labels)
                yield to_device(img_t, self.device), to_device(lab_t, self.device).long()
            else:
                yield to_device(images, self.device), to_device(labels.astype(np.int64), self.device)


class DeviceCachedLoader(DeviceLoader):
    """The train split on the device, uploaded once (images fp32
    ``[N,H,W,C]`` and labels int32 ``[N,H,W]``, or bf16 and int8 with
    ``compact``: 44 % of the bytes); each super-batch is ``index_select``-ed
    there into ``[A,B,H,W,C]``/``[A,B,H,W]``, the labels widened to int64
    on the device.  The batches are :class:`DeviceLoader`'s, byte for
    byte.  It needs a fixed-tile :class:`TileDataset`, as JAX's does.

    In a world of W processes each rank caches the whole split (only its
    rows on a ``data × space`` grid) and gathers only its own columns.  That reproduces the batches of the JAX
    package's single-process ``data=W`` mesh, which replicates its cache
    on every device and reshards each gathered super-batch over the data
    axis; JAX refuses the cache under more than one process because its
    processes are hosts of a multi-host mesh, which the port does not
    have."""

    def __init__(self, dataset, *args, **kwargs):
        if not isinstance(dataset, TileDataset):
            raise ValueError(
                "DeviceCachedLoader needs a fixed-tile TileDataset (crop "
                "datasets materialize tiles on the host per epoch)"
            )
        super().__init__(dataset, *args, **kwargs)
        images, labels = dataset.images, dataset.labels
        if self.space[1] > 1:
            images = np.ascontiguousarray(images[:, self.rows])
            labels = np.ascontiguousarray(labels[:, self.rows])
        if self.compact:
            img_t, lab_t = _compact_arrays(images, labels)
        else:
            img_t, lab_t = torch.from_numpy(images), torch.from_numpy(labels)
        self._images = img_t.to(self.device)
        self._labels = lab_t.to(self.device)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        a, b = self.sync_period, self.micro_batch
        for local in self.index_chunks():
            idx = torch.from_numpy(local).to(self.device)
            # One expression, so that no local keeps the narrow gather alive
            # while the consumer holds the batch.
            yield (self._images.index_select(0, idx).view(a, b, *self._images.shape[1:]),
                   self._labels.index_select(0, idx).view(a, b, *self._labels.shape[1:]).long())


class _Slot:
    """A ring entry: the ``[A,B,H,W,C]`` / ``[A,B,H,W]`` host destination
    (fp32/int32, or bf16/int8 under ``compact``; pinned on a card), the
    ``[A,B,H/S,W,..]`` rows of a space shard copied out of it for the
    upload (the destination itself without a space axis), the fp32/int32
    scratch of a compact cast that cannot fuse with the gather (allocated
    at its first use), and the CUDA event of the last copy that read the
    upload buffers (None on the CPU, where the copy is done when it
    returns)."""

    __slots__ = ("imgs", "labs", "up_imgs", "up_labs", "scratch_imgs", "scratch_labs",
                 "copied")

    def __init__(self, imgs: torch.Tensor, labs: torch.Tensor,
                 up_imgs: Optional[torch.Tensor] = None, up_labs: Optional[torch.Tensor] = None):
        self.imgs = imgs
        self.labs = labs
        self.up_imgs = imgs if up_imgs is None else up_imgs
        self.up_labs = labs if up_labs is None else up_labs
        self.scratch_imgs: Optional[np.ndarray] = None
        self.scratch_labs: Optional[np.ndarray] = None
        self.copied: Optional[torch.cuda.Event] = None


@lockcheck.guarded
class _Ring:
    """A fixed pool of slots.  ``acquire`` blocks until a slot is free and
    its last copy to the device has finished, so a gather never overwrites
    a batch still in flight (the JAX ring's ``block_until_ready``)."""

    def __init__(self, slots: List[_Slot]):
        self._cv = lockcheck.condition("_Ring._cv")
        self._slots = slots  # guarded-by: _cv

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


def host_view(t: torch.Tensor) -> np.ndarray:
    """A host tensor's storage as numpy (bf16 as its int16 bit pattern)."""
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


class ShardedLoader(DeviceLoader):
    """The host path, the JAX ``ShardedLoader``: ``workers`` producer
    threads assemble the super-batches into a ring of
    ``max(prefetch, workers) + 1`` host buffers, pinned on a card, and copy
    them to the device without blocking, up to ``max(prefetch, workers)``
    batches ahead of the consumer.  Batches are yielded in epoch order and
    are :class:`DeviceLoader`'s, byte for byte, for any worker count; a
    producer's exception surfaces at its batch, and a consumer that stops
    early waits for the batches in flight.

    Assembly takes one of three routes (:meth:`_assemble`): a resident
    source (a :class:`TileDataset`) with ``native_gather`` goes through the
    port's ``dwb_gather_pack`` (``kernels/host/batch.cc``: gather, the
    compact cast, and the pack in one multithreaded pass); any other
    source under ``compact`` is gathered into the slot's fp32/int32
    scratch (``datasets.gather_into``: lazy reads, crops, augmentation) and
    then cast and packed in one pass (native, or numpy's); and a plain fp32
    batch is gathered into the slot directly.  A failed build of the native
    library raises (``utils/native.NativeBuildError``).  Labels go to the
    device as int32 (int8 under ``compact``) and are widened there.

    ``timer`` (a ``train/observability.StageTimer``) gets the producers'
    ``loader_gather``, ``loader_cast`` and ``loader_upload`` stages."""

    def __init__(
        self,
        dataset,
        *args,
        native_gather: bool = True,
        prefetch: int = 2,
        workers: int = 1,
        timer=None,
        **kwargs,
    ):
        super().__init__(dataset, *args, **kwargs)
        if prefetch < 1:
            raise ValueError(f"prefetch must be >= 1, got {prefetch}")
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.prefetch = prefetch
        self.workers = workers
        self.timer = timer
        self._native = native.load_batch() if native_gather else None
        self._ring: Optional[_Ring] = None
        self._iota_cache: Optional[np.ndarray] = None

    def _stage(self, name: str):
        return self.timer.stage(f"loader_{name}") if self.timer is not None else nullcontext()

    def _get_ring(self) -> _Ring:
        """The ring: one slot for each batch in flight and one for the
        batch being consumed, so that no worker waits for a slot."""
        if self._ring is None:
            a, b = self.sync_period, self.micro_batch
            h, w, c = self.ds.image_shape
            pin = self.device.type == "cuda"
            img_dt, lab_dt = (torch.bfloat16, torch.int8) if self.compact else (torch.float32, torch.int32)
            hs = self.rows.stop - self.rows.start

            def slot() -> _Slot:
                up = ()
                if hs != h:
                    up = (torch.empty((a, b, hs, w, c), dtype=img_dt, pin_memory=pin),
                          torch.empty((a, b, hs, w), dtype=lab_dt, pin_memory=pin))
                return _Slot(torch.empty((a, b, h, w, c), dtype=img_dt, pin_memory=pin),
                             torch.empty((a, b, h, w), dtype=lab_dt, pin_memory=pin), *up)

            self._ring = _Ring([slot() for _ in range(max(self.prefetch, self.workers) + 1)])
        return self._ring

    def _native_source(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """The dataset's resident fp32/int32 arrays, which the fused kernel
        gathers from; None for lazy, crop and augmented sources."""
        imgs = getattr(self.ds, "images", None)
        labs = getattr(self.ds, "labels", None)
        if (
            isinstance(imgs, np.ndarray)
            and isinstance(labs, np.ndarray)
            and imgs.dtype == np.float32
            and labs.dtype == np.int32
            and imgs.flags.c_contiguous
            and labs.flags.c_contiguous
        ):
            return imgs, labs
        return None

    def _iota(self, n: int) -> np.ndarray:
        if self._iota_cache is None or len(self._iota_cache) != n:
            self._iota_cache = np.arange(n, dtype=np.int64)
        return self._iota_cache

    def _ensure_scratch(self, slot: _Slot) -> None:
        if slot.scratch_imgs is None:
            h, w, c = self.ds.image_shape
            n = self.sync_period * self.micro_batch
            slot.scratch_imgs = np.empty((n, h, w, c), np.float32)
            slot.scratch_labs = np.empty((n, h, w), np.int32)

    def _assemble(self, flat: np.ndarray, slot: _Slot) -> None:
        """The tiles ``flat`` into the slot's destination, by one of the
        three routes of the class docstring (all byte-identical)."""
        imgs, labs = host_view(slot.imgs), host_view(slot.labs)
        src = self._native_source() if self._native is not None else None
        if src is not None:
            with self._stage("gather"):
                self._native.gather_pack(src[0], src[1], flat, imgs, labs, self.compact)
        elif self.compact:
            self._ensure_scratch(slot)
            with self._stage("gather"):
                gather_into(self.ds, flat, slot.scratch_imgs, slot.scratch_labs)
            with self._stage("cast"):
                if self._native is not None:
                    self._native.gather_pack(slot.scratch_imgs, slot.scratch_labs,
                                             self._iota(len(flat)), imgs, labs, True)
                else:
                    compact_cast(slot.scratch_imgs, slot.scratch_labs, imgs, labs)
        else:
            with self._stage("gather"):
                gather_into(self.ds, flat, imgs, labs)

    def _produce(self, flat: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        ring = self._get_ring()
        slot = ring.acquire()
        try:
            self._assemble(np.ascontiguousarray(flat, np.int64), slot)
            with self._stage("upload"):
                if slot.up_imgs is not slot.imgs:
                    slot.up_imgs.copy_(slot.imgs[:, :, self.rows])
                    slot.up_labs.copy_(slot.labs[:, :, self.rows])
                if self.device.type != "cuda":
                    return slot.up_imgs.clone(), slot.up_labs.long()
                with torch.cuda.device(self.device):
                    imgs = slot.up_imgs.to(self.device, non_blocking=True)
                    labs = slot.up_labs.to(self.device, non_blocking=True)
                    slot.copied = torch.cuda.Event()
                    slot.copied.record()
                    return imgs, labs.long()
        finally:
            ring.release(slot)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """Batches in epoch order, the assembly and copy of up to
        ``max(prefetch, workers)`` later ones running on the workers
        meanwhile (fewer in flight would leave workers idle)."""
        self._get_ring()  # built here, not raced by the workers
        depth = max(self.prefetch, self.workers)
        with ThreadPoolExecutor(max_workers=self.workers, thread_name_prefix="loader") as ex:
            pending: deque = deque()
            for flat in self.index_chunks():
                pending.append(ex.submit(self._produce, flat))
                while len(pending) > depth:
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
    dataset: TileDataset, batch: int, device: torch.device, replica: int = 0, world: int = 1,
    space: Tuple[int, int] = (0, 1),
) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Fixed-order eval batches ``[b,H,W,C]`` / ``[b,H,W]`` of this
    replica (:func:`eval_indices`), only rows :func:`space_rows` of each
    tile on a ``data × space`` grid; padded tiles carry label −1, which
    the metrics mask out."""
    rows = space_rows(dataset.image_shape[0], space)
    for idx, valid in eval_indices(len(dataset), batch, replica, world):
        images, labels = dataset.gather(idx)
        images, labels = images[:, rows], labels[:, rows]
        labels = labels.astype(np.int64)
        labels[~valid] = -1
        yield to_device(images, device), to_device(labels, device)


def to_device(a, device: torch.device) -> torch.Tensor:
    """Host array or tensor → ``device``: through pinned memory with a
    non-blocking copy on CUDA, a plain tensor on the CPU."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
