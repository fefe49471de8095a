"""Tile datasets: the synthetic generator and the last-N split.

Copies of ``ddlpc_tpu/data/datasets.py`` (``TileDataset``,
``SyntheticTiles``, ``last_n_split_point``, ``train_test_split`` and the
synthetic branch of ``build_dataset``).  Everything is numpy with the same
seeded draws in the same order, so the tiles are byte-identical to the
reference's for the same config.  Directory readers, crop mode, lazy tiles
and augmentation are not ported yet and raise.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ddlpc_tpu_torch.config import DataConfig

# Dataset geometries: image size, channels, classes.
DATASET_SPECS = {
    "vaihingen": dict(image_size=(512, 512), channels=3, num_classes=6),
    "potsdam": dict(image_size=(512, 512), channels=3, num_classes=6),
    "cityscapes": dict(image_size=(512, 1024), channels=3, num_classes=19),
    "synthetic": dict(image_size=(512, 512), channels=3, num_classes=6),
}


class TileDataset:
    """In-RAM dataset of images [N,H,W,C] float32 and labels [N,H,W] int32."""

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        if images.ndim != 4:
            raise ValueError(f"images must be [N,H,W,C], got {images.shape}")
        if labels.shape != images.shape[:3]:
            raise ValueError(
                f"labels {labels.shape} do not match images {images.shape[:3]}"
            )
        self.images = np.ascontiguousarray(images, np.float32)
        self.labels = np.ascontiguousarray(labels, np.int32)

    def __len__(self) -> int:
        return self.images.shape[0]

    def gather(self, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        return self.images[indices], self.labels[indices]

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return tuple(self.images.shape[1:])  # type: ignore[return-value]


def last_n_split_point(n: int, test_split: int) -> int:
    """Cut index for the last-N holdout."""
    k = max(test_split, 0)
    if k >= n:
        raise ValueError(
            f"test_split={test_split} would leave no training tiles "
            f"(dataset has {n}); lower DataConfig.test_split or add data"
        )
    return n - k


def train_test_split(
    ds: TileDataset, test_split: int
) -> Tuple[TileDataset, TileDataset]:
    """Last-N holdout."""
    cut = last_n_split_point(len(ds), test_split)
    return (
        TileDataset(ds.images[:cut], ds.labels[:cut]),
        TileDataset(ds.images[cut:], ds.labels[cut:]),
    )


def SyntheticTiles(
    num_tiles: int = 127,
    image_size: Tuple[int, int] = (512, 512),
    channels: int = 3,
    num_classes: int = 6,
    seed: int = 0,
) -> TileDataset:
    """Vaihingen-like synthetic tiles: blocky class regions, class-tinted
    pixels (same draws, in the same order, as the reference generator)."""
    rng = np.random.default_rng(seed)
    h, w = image_size
    gh, gw = max(h // 32, 1), max(w // 32, 1)
    grid = rng.integers(0, num_classes, size=(num_tiles, gh, gw))
    labels = np.repeat(np.repeat(grid, -(-h // gh), axis=1), -(-w // gw), axis=2)
    labels = labels[:, :h, :w].astype(np.int32)
    palette = rng.uniform(0.1, 0.9, size=(num_classes, channels)).astype(np.float32)
    images = palette[labels]  # [N,H,W,C]
    images += rng.normal(0.0, 0.05, size=images.shape).astype(np.float32)
    return TileDataset(np.clip(images, 0.0, 1.0), labels)


def build_dataset(cfg: DataConfig) -> Tuple[TileDataset, TileDataset]:
    """(train, test) for a synthetic-data config (``data_dir`` unset)."""
    if cfg.data_dir:
        raise NotImplementedError(
            "reading tiles from data_dir is not yet ported; leave "
            "data.data_dir unset for synthetic tiles"
        )
    if cfg.dataset == "synthetic_hard":
        raise NotImplementedError("the synthetic_hard generator is not yet ported")
    spec = DATASET_SPECS.get(cfg.dataset, DATASET_SPECS["synthetic"])
    ds = SyntheticTiles(
        num_tiles=cfg.synthetic_len,
        image_size=tuple(cfg.image_size),
        channels=spec["channels"],
        num_classes=cfg.num_classes,
        seed=cfg.seed,
    )
    return train_test_split(ds, cfg.test_split)
