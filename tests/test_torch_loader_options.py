"""The port's host loader over every data source, with and without the
compact wire, at one and three workers, in worlds of one and two
replicas, against the JAX package's ``ShardedLoader`` on the CPU; then the
bf16 cast's bits against ``ml_dtypes``, the ring's depth, a producer's
exception, an early stop and the device cache's compact form.

Tolerance: none.  Images are compared as float32 bytes, or as bfloat16
bit patterns under ``compact``; labels as integers.  The JAX loader runs
one process over the 8-device CPU mesh, so a batch is the global
``[A, 8]`` super-batch; replica ``r`` of a port world of W takes its
columns ``[r·8/W, (r+1)·8/W)``.  22 tiles (or crops) against super-batches
of 16 exercise the wrap-fill; two epochs each, so that the crop plans and
augmentations of a second epoch are compared too.
"""

import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from ddlpc_tpu.config import DataConfig as JDataConfig
from ddlpc_tpu.config import ParallelConfig
from ddlpc_tpu.data import datasets as jd
from ddlpc_tpu.data import loader as jloader
from ddlpc_tpu.parallel.mesh import make_mesh
from ddlpc_tpu_torch.config import DataConfig
from ddlpc_tpu_torch.data import datasets as td
from ddlpc_tpu_torch.data.loader import (
    DeviceCachedLoader,
    DeviceLoader,
    ShardedLoader,
    bf16_bits,
    compact_cast,
)
from ddlpc_tpu_torch.utils import native
from test_torch_datasets_dir import write_scenes, write_tiles
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

A, GLOBAL_B, SEED, EPOCHS = 2, 8, 4, 2
CPU = torch.device("cpu")
# source: DataConfig overrides; the directory is filled in per source.
SOURCES = {
    "resident": dict(data_dir="tiles"),
    "lazy": dict(data_dir="tiles", lazy_tiles=True),
    "crop": dict(data_dir="scenes", crops_per_epoch=22),
    "crop_mmap": dict(data_dir="scenes", crops_per_epoch=22, mmap_scenes=True),
    "augmented": dict(data_dir="scenes", crops_per_epoch=22, mmap_scenes=True, augment=True),
}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("loader_src")
    return {"tiles": write_tiles(root / "tiles", n=26, fmt="npy", seed=5),
            "scenes": write_scenes(root / "scenes", fmt="npy", seed=6)}


def _cfg(dirs, source: str, cls):
    kw = dict(dataset="synthetic", image_size=(16, 16), test_split=4, seed=3, **SOURCES[source])
    kw["data_dir"] = dirs[kw["data_dir"]]
    return cls(**kw)


@pytest.fixture(scope="module")
def jax_batches(dirs):
    """{(source, compact): [epoch][batch] -> (images, labels)} from JAX's
    ShardedLoader (numpy route: the JAX package's native library is not
    built here)."""
    mesh = make_mesh(ParallelConfig(data_axis_size=-1, space_axis_size=1))
    out = {}
    for source in SOURCES:
        train, _ = jd.build_dataset(_cfg(dirs, source, JDataConfig))
        for compact in (False, True):
            loader = jloader.ShardedLoader(train, mesh, global_micro_batch=GLOBAL_B, sync_period=A,
                                           seed=SEED, compact=compact, native_gather=False)
            epochs = []
            for e in range(EPOCHS):
                loader.set_epoch(e)
                epochs.append([(np.asarray(i), np.asarray(l)) for i, l in loader])
            out[source, compact] = epochs
    return out


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _jbits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("compact", [False, True], ids=["fp32", "compact"])
@pytest.mark.parametrize("source", list(SOURCES))
def test_host_loader_equals_jax_sharded_loader(dirs, jax_batches, source, compact, workers, world):
    """The native gather at three workers, numpy's at one (both routes of
    every source); the plain ``DeviceLoader`` beside them."""
    train, _ = td.build_dataset(_cfg(dirs, source, DataConfig))
    b = GLOBAL_B // world
    for r in range(world):
        kw = dict(micro_batch=b, sync_period=A, device=CPU, seed=SEED, replica=r, world=world,
                  compact=compact)
        loader = ShardedLoader(train, workers=workers, native_gather=workers > 1, **kw)
        plain = DeviceLoader(train, **kw)
        for e in range(EPOCHS):
            loader.set_epoch(e)
            got = list(loader)
            plain.set_epoch(e)
            want = list(plain)
            jax_e = jax_batches[source, compact][e]
            assert len(got) == len(want) == len(jax_e) == 2
            for (gi, gl), (wi, wl), (ji, jl) in zip(got, want, jax_e):
                assert gi.dtype == (torch.bfloat16 if compact else torch.float32)
                assert gl.dtype == torch.int64 and gi.shape == (A, b, 16, 16, 3)
                cols = slice(r * b, (r + 1) * b)
                assert _bits(gi).tobytes() == np.ascontiguousarray(_jbits(ji)[:, cols]).tobytes()
                np.testing.assert_array_equal(gl.numpy(), jl[:, cols])
                assert torch.equal(gi, wi) and torch.equal(gl, wl)


def test_bf16_cast_bits_equal_ml_dtypes():
    """Ties to even, subnormals, ±0, ±inf, overflow and NaNs: the numpy
    cast equals ``ml_dtypes`` (JAX's ``_compact_cast``) on every value; the
    native kernel equals it too except on NaN payloads, where it keeps the
    payload's top bits as the JAX package's native kernel does."""
    words = [0x00000000, 0x80000000, 0x3F808000, 0x3F818000, 0x3F807FFF, 0x00008000, 0x00018000,
             0x00000001, 0x807FFFFF, 0x7F7FFFFF, 0xFF7FFFFF, 0x7F800000, 0xFF800000, 0x7FC00000,
             0xFFC00000, 0x7F800001, 0xFF800001, 0x7FA00000, 0xFFA00001, 0x3EAAAAAB]
    rng = np.random.default_rng(0)
    words += rng.integers(0, 2**32, 4000, dtype=np.uint64).astype(np.uint32).tolist()
    x = np.array(words, np.uint32).view(np.float32)
    want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(bf16_bits(x), want)
    labs = np.full((1, len(x)), -1, np.int32)
    jimg, jlab = jloader._compact_cast(x[None], labs)
    np.testing.assert_array_equal(jimg.view(np.uint16)[0], want)
    img_out, lab_out = np.empty((1, len(x)), np.uint16), np.empty((1, len(x)), np.int8)
    compact_cast(x[None], labs, img_out, lab_out)
    np.testing.assert_array_equal(img_out[0], want)
    np.testing.assert_array_equal(lab_out, jlab)
    nat = np.empty((1, len(x)), np.int16)
    native.load_batch().gather_pack(x[None].copy(), labs, np.zeros(1, np.int64), nat, lab_out, True)
    payload = np.isnan(x) & ((x.view(np.uint32) & 0x003FFFFF) != 0)
    np.testing.assert_array_equal(nat.view(np.uint16)[0][~payload], want[~payload])
    np.testing.assert_array_equal(nat.view(np.uint16)[0][payload],
                                  (x.view(np.uint32)[payload] >> 16).astype(np.uint16) | 0x40)


def test_compact_label_refusal_is_jax_words():
    imgs = np.zeros((2, 4, 4, 3), np.float32)
    labs = np.full((2, 4, 4), 200, np.int32)
    with pytest.raises(ValueError) as je:
        jloader._compact_cast(imgs, labs)
    for native_gather in (True, False):
        loader = ShardedLoader(td.TileDataset(imgs, labs), micro_batch=2, sync_period=1, device=CPU,
                               compact=True, native_gather=native_gather)
        with pytest.raises(ValueError) as te:
            next(iter(loader))
        assert str(te.value) == str(je.value)


class _Recording:
    """A lazy-like source (no resident arrays) that records each gather's
    start and end, sleeps a little, and raises at one chunk's gather."""

    def __init__(self, ds, fail_at=None, sleep=0.0):
        self.ds, self.fail_at, self.sleep = ds, fail_at, sleep
        self.started, self.finished = [], []
        self.lock = threading.Lock()

    def __len__(self):
        return len(self.ds)

    def set_epoch(self, epoch):
        self.ds.set_epoch(epoch)

    @property
    def image_shape(self):
        return self.ds.image_shape

    def gather(self, indices):
        return self.ds.gather(indices)

    def gather_into(self, indices, img_out, lab_out):
        key = int(indices[0])
        with self.lock:
            self.started.append(key)
        time.sleep(self.sleep)
        if key == self.fail_at:
            raise RuntimeError(f"read failed at tile {key}")
        self.ds.gather_into(indices, img_out, lab_out)
        with self.lock:
            self.finished.append(key)


def _tiles(n=40):
    return td.SyntheticTiles(num_tiles=n, image_size=(8, 8), seed=9)


@pytest.mark.parametrize("compact", [False, True])
def test_ring_grows_with_workers_and_every_held_batch_keeps_its_content(compact):
    """Four workers, prefetch 2: five slots, not three, and an epoch of 20
    batches all held to the end equals the plain loader's."""
    ds = _tiles()
    src = _Recording(ds, sleep=0.002)
    loader = ShardedLoader(src, micro_batch=2, sync_period=1, device=CPU, seed=1, prefetch=2,
                           workers=4, compact=compact)
    held = list(loader)
    assert len(loader._ring._slots) == 5
    plain = list(DeviceLoader(ds, micro_batch=2, sync_period=1, device=CPU, seed=1, compact=compact))
    assert len(held) == len(plain) == 20
    for (gi, gl), (wi, wl) in zip(held, plain):
        assert torch.equal(gi, wi) and torch.equal(gl, wl)
    assert len(ShardedLoader(ds, micro_batch=2, sync_period=1, device=CPU, prefetch=3,
                             workers=2)._get_ring()._slots) == 4
    with pytest.raises(ValueError, match="workers must be >= 1"):
        ShardedLoader(ds, micro_batch=2, sync_period=1, device=CPU, workers=0)


def test_producer_exception_surfaces_at_its_batch():
    ds = _tiles()
    probe = DeviceLoader(ds, micro_batch=2, sync_period=1, device=CPU, seed=1, shuffle=False)
    fail_at = int(list(probe.index_chunks())[3][0])
    loader = ShardedLoader(_Recording(ds, fail_at=fail_at), micro_batch=2, sync_period=1,
                           device=CPU, seed=1, shuffle=False, workers=3, native_gather=False)
    got = []
    with pytest.raises(RuntimeError, match=f"read failed at tile {fail_at}"):
        for batch in loader:
            got.append(batch)
    assert len(got) == 3


def test_early_stop_waits_for_the_work_in_flight():
    src = _Recording(_tiles(), sleep=0.05)
    loader = ShardedLoader(src, micro_batch=2, sync_period=1, device=CPU, seed=1, prefetch=2,
                           workers=3)
    it = iter(loader)
    next(it)
    it.close()
    with src.lock:
        assert sorted(src.started) == sorted(src.finished)
        assert 1 < len(src.started) <= 1 + max(2, 3)


def test_device_cache_compact_and_crop_refusal(dirs):
    ds = _tiles(33)
    kw = dict(micro_batch=4, sync_period=2, device=CPU, seed=5)
    for e in range(2):
        cache = DeviceCachedLoader(ds, compact=True, **kw)
        plain = DeviceLoader(ds, compact=True, **kw)
        cache.set_epoch(e)
        plain.set_epoch(e)
        assert cache._images.dtype == torch.bfloat16 and cache._labels.dtype == torch.int8
        for (ci, cl), (pi, pl) in zip(cache, plain):
            assert ci.dtype == torch.bfloat16 and cl.dtype == torch.int64
            assert torch.equal(ci, pi) and torch.equal(cl, pl)
    crop, _ = td.build_dataset(_cfg(dirs, "crop", DataConfig))
    jcrop, _ = jd.build_dataset(_cfg(dirs, "crop", JDataConfig))
    mesh = make_mesh(ParallelConfig(data_axis_size=-1, space_axis_size=1))
    with pytest.raises(ValueError) as je:
        jloader.DeviceCachedLoader(jcrop, mesh, global_micro_batch=8)
    with pytest.raises(ValueError) as te:
        DeviceCachedLoader(crop, **kw)
    assert str(te.value) == str(je.value)
