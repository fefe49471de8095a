"""Stage timing and the qualitative image dumps — the port's copy of
``StageTimer``, ``class_palette`` and ``dump_prediction_triples`` from
``ddlpc_tpu/train/observability.py``.

The PNGs are written by a small stdlib encoder (:func:`write_png`: 8-bit
RGB, filter 0 on every row, one zlib stream), so the port needs no image
library; the files decode to the same pixels as the JAX package's
PIL-written ones.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from contextlib import contextmanager
from typing import Dict

import numpy as np

# ISPRS-style 6-class palette (imp surface, building, low veg, tree, car,
# clutter), extended by a seeded draw for datasets with more classes.
_PALETTE = np.array(
    [
        [255, 255, 255],
        [0, 0, 255],
        [0, 255, 255],
        [0, 255, 0],
        [255, 255, 0],
        [255, 0, 0],
    ],
    np.uint8,
)


def class_palette(num_classes: int) -> np.ndarray:
    if num_classes <= len(_PALETTE):
        return _PALETTE[:num_classes]
    rng = np.random.default_rng(0)
    extra = rng.integers(0, 256, size=(num_classes - len(_PALETTE), 3), dtype=np.uint8)
    return np.concatenate([_PALETTE, extra])


class StageTimer:
    """Named wall-clock stage timing: totals and counts a stage, reset each
    epoch.  Thread-safe: the loader's producer thread times its
    ``loader_gather``/``loader_upload`` stages while the training thread
    times ``data`` and ``step``."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] = self.totals.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.totals)

    def means(self) -> Dict[str, float]:
        with self._lock:
            return {k: self.totals[k] / max(self.counts[k], 1) for k in self.totals}

    def reset(self) -> None:
        with self._lock:
            self.totals.clear()
            self.counts.clear()


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def write_png(path: str, rgb: np.ndarray) -> None:
    """``rgb`` ``[H, W, 3]`` uint8 as an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {rgb.shape} {rgb.dtype}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB, no interlace
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def dump_prediction_triples(
    workdir: str,
    images: np.ndarray,
    labels: np.ndarray,
    preds: np.ndarray,
    num_classes: int,
    epoch: int,
    max_samples: int = 5,
) -> None:
    """``images/epoch_XXXX/{Model,Label,Image} i.png``: the prediction and
    the label through the class palette, and the image at ×255."""
    out_dir = os.path.join(workdir, "images", f"epoch_{epoch:04d}")
    os.makedirs(out_dir, exist_ok=True)
    pal = class_palette(num_classes)
    for i in range(min(max_samples, len(images))):
        img_u8 = np.clip(images[i] * 255.0, 0, 255).astype(np.uint8)
        if img_u8.shape[-1] == 1:
            img_u8 = np.repeat(img_u8, 3, axis=-1)
        write_png(os.path.join(out_dir, f"Model {i}.png"), pal[np.clip(preds[i], 0, num_classes - 1)])
        write_png(os.path.join(out_dir, f"Label {i}.png"), pal[np.clip(labels[i], 0, num_classes - 1)])
        write_png(os.path.join(out_dir, f"Image {i}.png"), img_u8)
