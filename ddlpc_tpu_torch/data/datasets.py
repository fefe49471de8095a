"""Tile datasets: the synthetic generators and the last-N split.

Copies of ``ddlpc_tpu/data/datasets.py`` (``TileDataset``,
``SyntheticTiles``, the hard task ``HardTiles`` with its ``_bilinear_up``,
``SYNTHETIC_GENERATORS``, ``last_n_split_point``, ``train_test_split`` and
the synthetic branch of ``build_dataset``).  Everything is numpy with the same
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
    "synthetic_hard": dict(image_size=(512, 512), channels=3, num_classes=6),
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


def _bilinear_up(a: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear-upsample [N, gh, gw] → [N, H, W] (numpy, no scipy)."""
    n, gh, gw = a.shape
    h, w = out_hw
    y = np.clip((np.arange(h) + 0.5) * gh / h - 0.5, 0, gh - 1)
    x = np.clip((np.arange(w) + 0.5) * gw / w - 0.5, 0, gw - 1)
    y0 = np.floor(y).astype(np.int64)
    x0 = np.floor(x).astype(np.int64)
    y1 = np.minimum(y0 + 1, gh - 1)
    x1 = np.minimum(x0 + 1, gw - 1)
    wy = (y - y0)[None, :, None]
    wx = (x - x0)[None, None, :]
    return (
        a[:, y0][:, :, x0] * (1 - wy) * (1 - wx)
        + a[:, y1][:, :, x0] * wy * (1 - wx)
        + a[:, y0][:, :, x1] * (1 - wy) * wx
        + a[:, y1][:, :, x1] * wy * wx
    ).astype(np.float32)


def HardTiles(
    num_tiles: int = 127,
    image_size: Tuple[int, int] = (512, 512),
    channels: int = 3,
    num_classes: int = 6,
    seed: int = 0,
) -> TileDataset:
    """Non-saturating synthetic segmentation task (the hard task).

    :func:`SyntheticTiles` is block-constant at ≥32 px, so every
    architecture/codec arm converges to mIoU ~1.0 and quality A/Bs lose
    discriminating power.  This generator puts structure *below* the
    granularity of coarse heads and makes classes imbalanced, so converged
    mIoU lands meaningfully under 1.0 and arms separate:

    - classes 0/1: large background blocks (64 px grid) — easy, balanced;
    - class 2: irregular blobs from a thresholded bilinear noise field
      (8 px lattice) — boundary-dense at a scale subpixel heads must track;
    - class 3: thin polylines, width 1–3 px (~1–2 % of pixels) — strictly
      sub-16-px structure, the acknowledged s2d×4 fine-boundary risk
      (docs/QUANTIZATION.md caveat);
    - class 4: small discs, radius 2–6 px (~1 % of pixels) — rare small
      objects, punished per-class by mIoU;
    - class 5: 4 px checkerboard texture patches — boundary density exactly
      at a factor-4 subpixel head's output granularity.

    Pixels get a per-class palette color modulated by a low-frequency
    multiplicative lighting field (×0.75–1.25) plus iid noise, so per-pixel
    color alone is not sufficient — context is required, and a per-pixel
    Bayes classifier would not reach IoU 1.0 either.  The same draws, in
    the same order, as the JAX package's generator.
    """
    if num_classes < 6:
        raise ValueError(
            f"HardTiles defines 6 structural classes; got num_classes={num_classes}"
        )
    h, w = image_size
    if min(h, w) < 64:
        # Structure sizes are ABSOLUTE pixels (that is the point of the
        # task); the checkerboard/disc samplers need room for their patches.
        raise ValueError(
            f"HardTiles needs image_size >= 64 px per side, got {image_size}"
        )
    rng = np.random.default_rng(seed)
    BG_A, BG_B, BLOB, LINE, DISC, CHECKER = 0, 1, 2, 3, 4, 5

    # Backgrounds: 64 px blocks of class 0/1.
    gh, gw = max(h // 64, 1), max(w // 64, 1)
    grid = rng.integers(0, 2, size=(num_tiles, gh, gw))
    labels = np.repeat(np.repeat(grid, -(-h // gh), axis=1), -(-w // gw), axis=2)
    labels = labels[:, :h, :w].astype(np.int32)

    # Irregular blobs: thresholded bilinear noise on an 8 px lattice.
    field = _bilinear_up(
        rng.normal(size=(num_tiles, max(h // 8, 2), max(w // 8, 2))), (h, w)
    )
    labels[field > 0.9] = BLOB

    yy, xx = np.mgrid[0:h, 0:w]
    checker = ((yy // 4) + (xx // 4)) % 2 == 0  # 4 px checkerboard phase
    for i in range(num_tiles):
        # Checkerboard texture patches (before lines/discs so thin structure
        # stays on top).
        for _ in range(rng.integers(1, 3)):
            ph = int(rng.integers(48, min(161, h)))
            pw = int(rng.integers(48, min(161, w)))
            py = int(rng.integers(0, h - ph + 1))
            px = int(rng.integers(0, w - pw + 1))
            patch = labels[i, py : py + ph, px : px + pw]
            patch[checker[py : py + ph, px : px + pw]] = CHECKER
        # Thin polylines, width 1–3 px.
        for _ in range(8):
            p0 = rng.uniform(0, [h, w])
            p1 = rng.uniform(0, [h, w])
            width = int(rng.integers(1, 4))
            t = np.linspace(0.0, 1.0, 2 * max(h, w))[:, None]
            pts = np.round(p0 + t * (p1 - p0)).astype(np.int64)
            r = (width - 1) // 2
            for dy in range(-r, width - r):
                for dx in range(-r, width - r):
                    py = np.clip(pts[:, 0] + dy, 0, h - 1)
                    px = np.clip(pts[:, 1] + dx, 0, w - 1)
                    labels[i, py, px] = LINE
        # Small discs, radius 2–6 px.
        for _ in range(15):
            r = int(rng.integers(2, 7))
            cy = int(rng.integers(r, h - r))
            cx = int(rng.integers(r, w - r))
            dy, dx = np.mgrid[-r : r + 1, -r : r + 1]
            mask = dy * dy + dx * dx <= r * r
            patch = labels[i, cy - r : cy + r + 1, cx - r : cx + r + 1]
            patch[mask] = DISC

    palette = rng.uniform(0.15, 0.85, size=(num_classes, channels)).astype(
        np.float32
    )
    # Confusable class pairs: pull bulk-background B toward A, the
    # checkerboard toward background A, and discs toward lines, so the
    # lighting field + noise genuinely overlap their color distributions and
    # per-pixel color cannot solve the task (context must disambiguate).
    palette[BG_B] = 0.65 * palette[BG_A] + 0.35 * palette[BG_B]
    palette[CHECKER] = 0.6 * palette[BG_A] + 0.4 * palette[CHECKER]
    palette[DISC] = 0.6 * palette[LINE] + 0.4 * palette[DISC]
    images = palette[labels]  # [N,H,W,C]
    lighting = _bilinear_up(
        rng.uniform(0.75, 1.25, size=(num_tiles, max(h // 128, 2), max(w // 128, 2))),
        (h, w),
    )
    images *= lighting[..., None]
    images += rng.normal(0.0, 0.08, size=images.shape).astype(np.float32)
    return TileDataset(np.clip(images, 0.0, 1.0), labels)


SYNTHETIC_GENERATORS = {"synthetic": SyntheticTiles, "synthetic_hard": HardTiles}


def build_dataset(cfg: DataConfig) -> Tuple[TileDataset, TileDataset]:
    """(train, test) for a synthetic-data config (``data_dir`` unset)."""
    if cfg.data_dir:
        raise NotImplementedError(
            "reading tiles from data_dir is not yet ported; leave "
            "data.data_dir unset for synthetic tiles"
        )
    spec = DATASET_SPECS.get(cfg.dataset, DATASET_SPECS["synthetic"])
    generator = SYNTHETIC_GENERATORS.get(cfg.dataset, SyntheticTiles)
    ds = generator(
        num_tiles=cfg.synthetic_len,
        image_size=tuple(cfg.image_size),
        channels=spec["channels"],
        num_classes=cfg.num_classes,
        seed=cfg.seed,
    )
    return train_test_split(ds, cfg.test_split)
