"""The port's synthetic tiles, holdout split and epoch order against the JAX
package's, on the CPU.

Both sides are numpy with the same seeded draws, so everything is held
byte-exact: the tiles and labels of ``build_dataset``, and the per-epoch
index order (permutation plus wrap-fill) of the sampler.
"""

import numpy as np
import pytest
import torch

from ddlpc_tpu.config import DataConfig as JDataConfig
from ddlpc_tpu.data import datasets as jdatasets
from ddlpc_tpu.data import loader as jloader
from ddlpc_tpu_torch.config import DataConfig
from ddlpc_tpu_torch.data import datasets as tdatasets
from ddlpc_tpu_torch.data.loader import DeviceLoader, EpochSampler, eval_batches
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse


@pytest.mark.parametrize(
    "kw",
    [dict(dataset="synthetic", image_size=(32, 48), synthetic_len=11, test_split=3, seed=5),
     dict(dataset="synthetic", image_size=(64, 64), synthetic_len=7, test_split=0)],
)
def test_synthetic_dataset_and_split_byte_identical(kw):
    jtrain, jtest = jdatasets.build_dataset(JDataConfig(**kw))
    ttrain, ttest = tdatasets.build_dataset(DataConfig(**kw))
    for j, t in ((jtrain, ttrain), (jtest, ttest)):
        assert len(j) == len(t)
        for a, b in ((j.images, t.images), (j.labels, t.labels)):
            a = np.asarray(a)
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
    with pytest.raises(ValueError, match="no training tiles"):
        tdatasets.build_dataset(DataConfig(synthetic_len=4, test_split=4, image_size=(32, 32)))


@pytest.mark.parametrize(
    "n,super_batch,shuffle",
    [(97, 512, True), (20, 8, True), (16, 8, True), (20, 8, False)],
)
def test_epoch_order_matches_jax_sampler(n, super_batch, shuffle):
    """The flagship's 97 train tiles against super-batch 512 wrap-fill to
    one step an epoch; a ragged and an even case and no shuffle besides."""
    jds = jdatasets.SyntheticTiles(num_tiles=n, image_size=(4, 4))
    jsampler = jloader._EpochSampler()
    jsampler.ds, jsampler.super_batch = jds, super_batch
    jsampler.shuffle, jsampler.seed, jsampler.tail = shuffle, 3, "wrap"
    tsampler = EpochSampler(
        tdatasets.SyntheticTiles(num_tiles=n, image_size=(4, 4)), super_batch,
        shuffle=shuffle, seed=3,
    )
    assert len(tsampler) == len(jsampler)
    for epoch in (0, 1, 4):
        jsampler.set_epoch(epoch)
        tsampler.set_epoch(epoch)
        np.testing.assert_array_equal(tsampler.epoch_indices(), jsampler._epoch_indices())


def test_device_loader_and_eval_batches_on_cpu():
    ds = tdatasets.SyntheticTiles(num_tiles=10, image_size=(8, 8), seed=2)
    loader = DeviceLoader(ds, micro_batch=2, sync_period=3, device=torch.device("cpu"), seed=1)
    loader.set_epoch(2)
    idx = loader.epoch_indices()
    items = list(loader)
    assert len(items) == len(loader) == 2  # 10 tiles wrap-filled to 2 × 6
    for k, (images, labels) in enumerate(items):
        assert images.shape == (3, 2, 8, 8, 3) and images.dtype == torch.float32
        assert labels.shape == (3, 2, 8, 8) and labels.dtype == torch.int64
        want_x, want_y = ds.gather(idx[6 * k : 6 * k + 6])
        np.testing.assert_array_equal(images.reshape(6, 8, 8, 3).numpy(), want_x)
        np.testing.assert_array_equal(labels.reshape(6, 8, 8).numpy(), want_y)
    sizes = [x.shape[0] for x, _ in eval_batches(ds, 4, torch.device("cpu"))]
    assert sizes == [4, 4, 2]
