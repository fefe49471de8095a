"""The port's three batchers against each other and against the JAX
package's ``DeviceCachedLoader`` and ``ShardedLoader``, on the CPU.  Exact:
the same tiles in the same order, byte for byte.

The JAX loaders run one process over the 8-device CPU mesh, so a batch is
the global ``[A, W·B]`` super-batch; replica ``r`` of a port world of W
takes its columns ``[r·B, (r+1)·B)``.  21 tiles against super-batches of
16 exercise the wrap-fill (two batches an epoch, 11 tiles repeated).  Then the
ring of ``ShardedLoader``: its slots are reused, a slot is not written
again before its last copy to the device has finished, every batch held by
the consumer keeps its content, and a native library that does not build
raises.
"""

import numpy as np
import pytest
import torch

from ddlpc_tpu.config import ParallelConfig
from ddlpc_tpu.data import datasets as jdatasets
from ddlpc_tpu.data.loader import DeviceCachedLoader as JDeviceCachedLoader
from ddlpc_tpu.data.loader import ShardedLoader as JShardedLoader
from ddlpc_tpu.parallel.mesh import make_mesh
from ddlpc_tpu_torch.data.datasets import TileDataset
from ddlpc_tpu_torch.data.loader import (
    DeviceCachedLoader,
    DeviceLoader,
    ShardedLoader,
    _Ring,
    _Slot,
)
from ddlpc_tpu_torch.utils import native
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

EPOCHS = 3
A, GLOBAL_B, SEED = 2, 8, 4  # the JAX global micro-batch: 8 = the mesh's data axis


@pytest.fixture(scope="module")
def tiles():
    ds = jdatasets.SyntheticTiles(num_tiles=21, image_size=(8, 8), seed=9)
    ds.labels[0, 0, 0] = -1
    return ds


@pytest.fixture(scope="module")
def jax_epochs(tiles):
    """{kind: [epoch][batch] -> (images, labels) numpy, global batches}."""
    mesh = make_mesh(ParallelConfig(data_axis_size=-1, space_axis_size=1))
    out = {}
    for kind, cls in (("cache", JDeviceCachedLoader), ("sharded", JShardedLoader)):
        loader = cls(tiles, mesh, global_micro_batch=GLOBAL_B, sync_period=A, seed=SEED)
        epochs = []
        for e in range(EPOCHS):
            loader.set_epoch(e)
            epochs.append([(np.asarray(i), np.asarray(l)) for i, l in loader])
        out[kind] = epochs
    return out


def _port_epochs(cls, tiles, replica: int, world: int, **kw):
    loader = cls(TileDataset(tiles.images, tiles.labels), micro_batch=GLOBAL_B // world,
                 sync_period=A, device=torch.device("cpu"), seed=SEED, replica=replica,
                 world=world, **kw)
    epochs = []
    for e in range(EPOCHS):
        loader.set_epoch(e)
        epochs.append(list(loader))
    return epochs


PORT_LOADERS = {
    "device_loader": (DeviceLoader, {}),
    "device_cache": (DeviceCachedLoader, {}),
    "ring_native": (ShardedLoader, {"native_gather": True}),
    "ring_numpy": (ShardedLoader, {"native_gather": False}),
}


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("name", list(PORT_LOADERS))
def test_batches_equal_device_loader_and_jax(tiles, jax_epochs, name, world):
    cls, kw = PORT_LOADERS[name]
    b = GLOBAL_B // world
    for r in range(world):
        got = _port_epochs(cls, tiles, r, world, **kw)
        want = _port_epochs(DeviceLoader, tiles, r, world)
        assert [len(e) for e in got] == [len(e) for e in want] == [2] * EPOCHS
        for e in range(EPOCHS):
            for (gi, gl), (wi, wl), (ji, jl) in zip(got[e], want[e], jax_epochs["sharded"][e]):
                assert gi.dtype == torch.float32 and gl.dtype == torch.int64
                assert gi.shape == (A, b, 8, 8, 3) and gl.shape == (A, b, 8, 8)
                assert torch.equal(gi, wi) and torch.equal(gl, wl)
                cols = slice(r * b, (r + 1) * b)
                assert gi.numpy().tobytes() == np.ascontiguousarray(ji[:, cols]).tobytes()
                np.testing.assert_array_equal(gl.numpy(), jl[:, cols])


def test_jax_cache_and_sharded_loaders_agree(jax_epochs):
    """The reference's two transports serve the same batches (what the
    port's equality with one of them extends to the other)."""
    for e in range(EPOCHS):
        for (ci, cl), (si, sl) in zip(jax_epochs["cache"][e], jax_epochs["sharded"][e]):
            np.testing.assert_array_equal(ci, si)
            np.testing.assert_array_equal(cl, sl)


def test_ring_reuses_its_slots_and_held_batches_keep_their_content(tiles):
    ds = TileDataset(np.tile(tiles.images, (3, 1, 1, 1)), np.tile(tiles.labels, (3, 1, 1)))
    loader = ShardedLoader(ds, micro_batch=2, sync_period=2, device=torch.device("cpu"),
                           seed=1, prefetch=2)
    held = list(loader)  # every batch of the epoch alive at once
    assert len(held) == len(list(loader.index_chunks())) == 16
    for (imgs, labs), flat in zip(held, loader.index_chunks()):
        ri, rl = ds.gather(flat)
        assert imgs.numpy().tobytes() == ri.tobytes()
        np.testing.assert_array_equal(labs.numpy().reshape(rl.shape), rl)
    slots = loader._ring._slots
    assert len(slots) == 3  # prefetch + 1, however many batches went through
    assert len({s.imgs.data_ptr() for s in slots}) == 3


class _Copy:
    """A stand-in for the CUDA event of a slot's copy to the device."""

    def __init__(self, log: list, name: str):
        self.log, self.name = log, name

    def synchronize(self):
        self.log.append(("waited", self.name))


def test_acquire_waits_for_the_slots_last_copy():
    log = []
    slot = _Slot(torch.zeros(1), torch.zeros(1, dtype=torch.int32))
    ring = _Ring([slot])
    got = ring.acquire()
    assert got is slot and log == []  # never copied: nothing to wait for
    slot.copied = _Copy(log, "first")
    ring.release(slot)
    assert log == []  # release does not wait; the next acquire does
    assert ring.acquire() is slot and log == [("waited", "first")]


def test_failed_native_build_raises_from_the_loader(tiles, tmp_path, monkeypatch):
    def broken():
        raise native.NativeBuildError(native._failed("libdwbatch", "g++ failed"))

    monkeypatch.setattr(native, "load_batch", broken)
    ds = TileDataset(tiles.images, tiles.labels)
    with pytest.raises(native.NativeBuildError, match="--set data.native_gather=False"):
        ShardedLoader(ds, micro_batch=2, sync_period=2, device=torch.device("cpu"))
    ShardedLoader(ds, micro_batch=2, sync_period=2, device=torch.device("cpu"), native_gather=False)
