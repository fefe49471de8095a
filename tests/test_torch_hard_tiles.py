"""The hard task's tiles in the port against the JAX package's, on the CPU.

``HardTiles`` is numpy on both sides with the same seeded draws in the same
order, so images and labels are held byte for byte, and ``build_dataset``
on ``synthetic_hard`` must give the same train/test split.
"""

import warnings

import numpy as np
import pytest

from ddlpc_tpu.config import DataConfig as JDataConfig
from ddlpc_tpu.data import datasets as jdatasets
from ddlpc_tpu_torch.config import DataConfig
from ddlpc_tpu_torch.data import datasets as tdatasets
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse


def _same(a, b) -> None:
    a = np.asarray(a)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("image_size", [(64, 64), (96, 128)])
def test_hard_tiles_byte_identical(image_size, seed):
    j = jdatasets.HardTiles(num_tiles=3, image_size=image_size, seed=seed)
    t = tdatasets.HardTiles(num_tiles=3, image_size=image_size, seed=seed)
    _same(j.images, t.images)
    _same(j.labels, t.labels)
    # The fine structure (blobs, lines, discs, checkerboard) is drawn.
    assert {2, 3, 4, 5} <= set(np.unique(t.labels).tolist())


def test_hard_tiles_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="6 structural classes"):
        tdatasets.HardTiles(num_tiles=1, image_size=(64, 64), num_classes=5)
    with pytest.raises(ValueError, match=">= 64 px"):
        tdatasets.HardTiles(num_tiles=1, image_size=(32, 64))


def test_build_dataset_synthetic_hard_split_matches_jax():
    kw = dict(dataset="synthetic_hard", image_size=(64, 96), synthetic_len=9, test_split=3, seed=1)
    with warnings.catch_warnings():
        # JAX warns that 64x96 is not the named dataset's 512x512 geometry.
        warnings.simplefilter("ignore")
        jtrain, jtest = jdatasets.build_dataset(JDataConfig(**kw))
    ttrain, ttest = tdatasets.build_dataset(DataConfig(**kw))
    assert (len(ttrain), len(ttest)) == (6, 3)
    for j, t in ((jtrain, ttrain), (jtest, ttest)):
        _same(j.images, t.images)
        _same(j.labels, t.labels)
    assert tdatasets.SYNTHETIC_GENERATORS["synthetic_hard"] is tdatasets.HardTiles
