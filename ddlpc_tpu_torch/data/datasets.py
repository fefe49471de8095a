"""Tile datasets: the directory readers, the crop and augmentation views,
the synthetic generators and ``build_dataset`` — the port's copy of
``ddlpc_tpu/data/datasets.py``.

Every function here is numpy with the same seeded draws, in the same
order, as the JAX package's, so the tiles, crops, augmentations and splits
are byte-identical to the reference's for the same config and files.

Directories hold images and ``.npy`` masks paired by filename stem
(:func:`file_stem`), or ``<stem>_img.npy`` uint8 array images, the
``prepare_* --format npy`` form.  PNG images decode with the port's own
decoder (``data/png.py``: stdlib zlib and numpy; the card's machine has no
image library).  Any other image format goes through imageio where it is
installed, imported when such a file is read; without it the read raises
and names ``--format npy``.

Fixed-tile mode reads a tile directory eagerly (:func:`load_tile_dir`) or
per gather (:class:`LazyTileDataset`, ``data.lazy_tiles``); crop mode reads
a scene directory eagerly or memory-mapped (:func:`load_scene_dir`,
``data.mmap_scenes``) behind a :class:`CropDataset`, and holds out a grid
tiling of its last scenes (:func:`grid_tiles`).  :class:`DihedralAugment`
(``data.augment``) wraps the training split of either mode.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Tuple

import numpy as np

from ddlpc_tpu_torch.config import DataConfig
from ddlpc_tpu_torch.data import png

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

    def __getitem__(self, idx) -> Tuple[np.ndarray, np.ndarray]:
        return self.images[idx], self.labels[idx]

    def gather(self, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        return self.images[indices], self.labels[indices]

    def gather_into(
        self, indices: np.ndarray, img_out: np.ndarray, lab_out: np.ndarray
    ) -> None:
        """Gather straight into caller-owned fp32/int32 buffers (the
        loader's ring).  Bounds are checked first and ``np.take`` runs with
        ``mode='clip'``: numpy buffers ``mode='raise'`` through a hidden
        temporary, the copy this method exists to avoid."""
        idx = np.asarray(indices)
        if len(idx) and (idx.min() < 0 or idx.max() >= len(self.images)):
            raise IndexError(
                f"gather index out of range for dataset of "
                f"{len(self.images)} tiles"
            )
        np.take(self.images, idx, axis=0, mode="clip", out=img_out.reshape(
            len(idx), *self.images.shape[1:]
        ))
        np.take(self.labels, idx, axis=0, mode="clip", out=lab_out.reshape(
            len(idx), *self.labels.shape[1:]
        ))

    def set_epoch(self, epoch: int) -> None:
        """Fixed tiles: nothing depends on the epoch."""

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return tuple(self.images.shape[1:])  # type: ignore[return-value]


def _finish_image(
    img: np.ndarray,
    image_size: Optional[Tuple[int, int]],
    channels: int,
    normalize: bool,
) -> np.ndarray:
    """Post-decode pipeline shared by every image source (file decode and
    array tiles): ndim fixup, channel repeat/truncate, crop/zero-pad to
    ``image_size``, float32, /255 — one implementation, so that png and
    npy forms of the same source cannot drift."""
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] < channels:
        img = np.repeat(img[..., :1], channels, axis=-1)
    elif img.shape[-1] > channels:
        img = img[..., :channels]
    if image_size is not None:
        h, w = image_size
        img = img[:h, :w]
        if img.shape[0] < h or img.shape[1] < w:
            pad = ((0, h - img.shape[0]), (0, w - img.shape[1]), (0, 0))
            img = np.pad(img, pad)
    img = img.astype(np.float32)
    if normalize:
        img /= 255.0
    return img


def decode_image_file(path: str) -> np.ndarray:
    """One image file's pixels as imageio returns them: a PNG through the
    port's decoder (``data/png.py``), which raises on what it does not
    cover; any other format through imageio, imported here.  Without
    imageio a non-PNG file raises, naming ``--format npy``."""
    if png.is_png(path):
        return png.read_png(path)
    try:
        import imageio.v2 as imageio
    except ImportError:
        raise ValueError(
            f"{path}: not a PNG, and imageio (which would decode it) is not "
            f"installed; convert the data to uint8 arrays with "
            f"python -m ddlpc_tpu_torch.data.prepare_isprs (or "
            f"prepare_cityscapes) --format npy where imageio is, or as PNG"
        ) from None
    return np.asarray(imageio.imread(path))


def load_image_file(
    path: str,
    image_size: Optional[Tuple[int, int]],
    channels: int = 3,
    normalize: bool = True,
) -> np.ndarray:
    """One image file → [H, W, channels] float array.

    ``image_size`` set: crops larger inputs and zero-pads smaller ones to
    exactly that size; ``image_size=None``: native size.  Repeats grayscale
    / drops alpha to reach ``channels``."""
    return _finish_image(decode_image_file(path), image_size, channels, normalize)


class CropDataset:
    """Random-crop view over arbitrarily-sized scenes.

    ``len(ds)`` is ``crops_per_epoch``; crop positions are a pure function
    of (seed, epoch, index), so every process computing the same epoch sees
    the same global crop plan.  Scenes are sampled proportionally to their
    croppable area.

    Scene dtype is the normalization contract: uint8 scenes are raw images
    (the ``load_scene_dir(mmap=True)`` format) and each crop is normalized
    with the eager loader's ``astype(float32)/255``; float scenes are taken
    as already normalized.
    """

    def __init__(
        self,
        scenes: "list[Tuple[np.ndarray, np.ndarray]]",
        crop_size: Tuple[int, int],
        crops_per_epoch: int,
        seed: int = 0,
    ):
        if not scenes:
            raise ValueError("CropDataset needs at least one scene")
        ch, cw = crop_size
        self.scenes = []
        for i, (img, lab) in enumerate(scenes):
            if img.shape[:2] != lab.shape[:2]:
                raise ValueError(
                    f"scene {i}: image {img.shape[:2]} != label {lab.shape[:2]}"
                )
            # int32 before the -1 pad (uint8 would wrap void to 255); on an
            # int32 memory map this is a view, so mmap scenes stay on disk.
            lab = np.asarray(lab, np.int32)
            if img.shape[0] < ch or img.shape[1] < cw:
                # Undersized scenes pad up to one crop; labels with void.
                pad_h, pad_w = max(ch - img.shape[0], 0), max(cw - img.shape[1], 0)
                img = np.pad(img, ((0, pad_h), (0, pad_w), (0, 0)))
                lab = np.pad(lab, ((0, pad_h), (0, pad_w)), constant_values=-1)
            # uint8 images (the mmap format) stay as they are and are
            # normalized per crop; anything else is materialized float32.
            if img.dtype != np.uint8:
                img = np.ascontiguousarray(img, np.float32)
            self.scenes.append((img, lab))
        self.crop_size = (ch, cw)
        self.crops_per_epoch = int(crops_per_epoch)
        if self.crops_per_epoch <= 0:
            raise ValueError(f"crops_per_epoch must be > 0, got {crops_per_epoch}")
        self.seed = seed
        areas = np.array(
            [
                (img.shape[0] - ch + 1) * (img.shape[1] - cw + 1)
                for img, _ in self.scenes
            ],
            np.float64,
        )
        self._scene_probs = areas / areas.sum()
        self._epoch = 0
        self._plan: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return self.crops_per_epoch

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)
        self._plan = None
        # Built here, once: the loader's workers would otherwise each
        # compute it on their first gather.
        self._crop_plan()

    def _crop_plan(self) -> np.ndarray:
        """[crops_per_epoch, 3] (scene, y0, x0), deterministic per epoch."""
        if self._plan is None:
            rng = np.random.default_rng((self.seed, self._epoch))
            ch, cw = self.crop_size
            scene_ids = rng.choice(
                len(self.scenes), size=self.crops_per_epoch, p=self._scene_probs
            )
            ys = np.empty(self.crops_per_epoch, np.int64)
            xs = np.empty(self.crops_per_epoch, np.int64)
            for i, s in enumerate(scene_ids):
                img, _ = self.scenes[s]
                ys[i] = rng.integers(0, img.shape[0] - ch + 1)
                xs[i] = rng.integers(0, img.shape[1] - cw + 1)
            self._plan = np.stack([scene_ids, ys, xs], axis=1)
        return self._plan

    def gather(self, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        ch, cw = self.crop_size
        n = len(indices)
        c = self.scenes[0][0].shape[-1]
        imgs = np.empty((n, ch, cw, c), np.float32)
        labs = np.empty((n, ch, cw), np.int32)
        self.gather_into(indices, imgs, labs)
        return imgs, labs

    def gather_into(
        self, indices: np.ndarray, img_out: np.ndarray, lab_out: np.ndarray
    ) -> None:
        """Crop straight into caller-owned fp32/int32 buffers."""
        plan = self._crop_plan()
        ch, cw = self.crop_size
        imgs = img_out.reshape(len(indices), *self.image_shape)
        labs = lab_out.reshape(len(indices), ch, cw)
        for out, idx in enumerate(np.asarray(indices, np.int64)):
            s, y0, x0 = plan[idx]
            img, lab = self.scenes[s]
            imgs[out] = img[y0 : y0 + ch, x0 : x0 + cw]
            if img.dtype == np.uint8:
                # The eager loader's astype(f32)/255, so eager and mmap
                # crops are bit-identical.
                imgs[out] /= 255.0
            labs[out] = lab[y0 : y0 + ch, x0 : x0 + cw]

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return (*self.crop_size, self.scenes[0][0].shape[-1])


class DihedralAugment:
    """Epoch-deterministic dihedral-group augmentation (4 rotations ×
    optional flip, applied jointly to image and mask).  The transform for
    (epoch, index) is a pure function of the seed, so every process
    computing the same epoch applies the same one."""

    def __init__(self, ds, seed: int = 0):
        self.ds = ds
        self.seed = seed
        self._epoch = 0
        self._ks: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.ds)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)
        self._ks = None
        self.ds.set_epoch(epoch)
        self._epoch_ks()  # built here, as CropDataset.set_epoch does

    @property
    def image_shape(self):
        h, w, c = self.ds.image_shape
        if h != w:
            raise ValueError(
                f"dihedral augmentation needs square tiles, got {(h, w)} "
                f"(90° rotations change the shape otherwise)"
            )
        return (h, w, c)

    def _epoch_ks(self) -> np.ndarray:
        """One transform a dataset index an epoch (not a gather position),
        so a tile gets the same transform wherever it lands in the epoch."""
        if self._ks is None:
            rng = np.random.default_rng((self.seed, self._epoch, 0xD1))
            self._ks = rng.integers(0, 8, size=len(self.ds))
        return self._ks

    def gather(self, indices: np.ndarray):
        self.image_shape  # square-tile validation
        # Both underlying gather()s return new arrays: transforming them in
        # place needs no defensive copy.
        imgs, labs = self.ds.gather(indices)
        ks = self._epoch_ks()
        for out, idx in enumerate(np.asarray(indices, np.int64)):
            k = ks[idx]
            rot, flip = int(k % 4), bool(k >= 4)
            img, lab = imgs[out], labs[out]
            if rot:
                img = np.rot90(img, rot, axes=(0, 1))
                lab = np.rot90(lab, rot, axes=(0, 1))
            if flip:
                img = img[:, ::-1]
                lab = lab[:, ::-1]
            imgs[out] = img
            labs[out] = lab
        return imgs, labs


def gather_into(
    ds, indices: np.ndarray, img_out: np.ndarray, lab_out: np.ndarray
) -> None:
    """Gather ``ds[indices]`` into caller-owned fp32/int32 buffers: the
    dataset's own ``gather_into`` where it has one, else gather-then-copy
    (:class:`DihedralAugment`, which transforms after materializing)."""
    fn = getattr(ds, "gather_into", None)
    if fn is not None:
        fn(indices, img_out, lab_out)
        return
    imgs, labs = ds.gather(indices)
    img_out.reshape(imgs.shape)[...] = imgs
    lab_out.reshape(labs.shape)[...] = labs


def grid_tiles(
    scenes: "list[Tuple[np.ndarray, np.ndarray]]",
    tile_size: Tuple[int, int],
    max_tiles: Optional[int] = None,
) -> TileDataset:
    """Deterministic non-overlapping grid tiling of scenes → TileDataset,
    the fixed eval tiles of crop mode.  Same dtype contract as
    :class:`CropDataset`."""
    th, tw = tile_size
    images, labels = [], []
    for img, lab in scenes:
        for y in range(0, max(img.shape[0] - th, 0) + 1, th):
            for x in range(0, max(img.shape[1] - tw, 0) + 1, tw):
                tile_img = img[y : y + th, x : x + tw]
                tile_lab = lab[y : y + th, x : x + tw]
                if tile_img.shape[:2] != (th, tw):
                    continue
                t = np.asarray(tile_img, np.float32)
                if tile_img.dtype == np.uint8:
                    t /= 255.0  # mmap scenes are raw uint8
                images.append(t)
                labels.append(np.asarray(tile_lab, np.int32))
                if max_tiles is not None and len(images) >= max_tiles:
                    break
            else:
                continue
            break
        if max_tiles is not None and len(images) >= max_tiles:
            break
    if not images:
        raise ValueError(f"no {tile_size} tiles fit in any scene")
    return TileDataset(np.stack(images), np.stack(labels))


def load_scene_dir(
    path: str, channels: int = 3, normalize: bool = True, mmap: bool = False
) -> "list[Tuple[np.ndarray, np.ndarray]]":
    """Directory of images + ``.npy`` masks at native size → scene list.

    Pairing is strict (:func:`_paired_files`).  ``mmap=True`` memory-maps
    every array instead of loading it; it needs ``<stem>_img.npy`` uint8
    images and int32 masks, which stay on disk until a crop touches them
    (consumers normalize per crop, bit-identical to the eager path)."""
    if mmap and not normalize:
        raise ValueError(
            "mmap=True keeps scenes uint8 and consumers normalize per crop "
            "— normalize=False cannot be honored; load eagerly instead"
        )
    img_by_stem, npy_by_stem = _paired_files(path)
    scenes = []
    for s in sorted(img_by_stem):
        img_path = img_by_stem[s]
        if img_path.endswith(".npy"):
            if mmap:
                img = np.load(img_path, mmap_mode="r")
                if img.ndim != 3 or img.shape[-1] != channels:
                    raise ValueError(
                        f"{img_path}: mmap images must be [H, W, "
                        f"{channels}], got shape {img.shape}"
                    )
                if img.dtype != np.uint8:
                    raise ValueError(
                        f"{img_path}: mmap images must be uint8 (the "
                        f"prepare_* converters write uint8; other dtypes "
                        f"would be silently materialized and mis-scaled "
                        f"downstream), got {img.dtype}"
                    )
            else:
                img = np.load(img_path)
                if img.ndim != 3 or img.shape[-1] != channels:
                    raise ValueError(
                        f"{img_path}: array images must be [H, W, "
                        f"{channels}], got shape {img.shape}"
                    )
                if img.dtype != np.uint8:
                    raise ValueError(
                        f"{img_path}: array images must be uint8 (float "
                        f"scenes would be /255-normalized twice), got "
                        f"{img.dtype}"
                    )
                img = _finish_image(img, None, channels, normalize)
        elif mmap:
            raise ValueError(
                f"mmap=True needs array-format images (<stem>_img.npy), "
                f"got {img_path}; re-run scripts/prepare_isprs.py with "
                f"--format npy"
            )
        else:
            img = load_image_file(
                img_path, None, channels=channels, normalize=normalize
            )
        lab = np.load(npy_by_stem[s], mmap_mode="r" if mmap else None)
        if not mmap:
            lab = lab.astype(np.int32)
        elif lab.dtype != np.int32:
            raise ValueError(
                f"{npy_by_stem[s]}: mmap masks must be int32 (the "
                f"prepare_* converters write int32), got {lab.dtype}"
            )
        scenes.append((img, lab))
    return scenes


LABEL_SUFFIXES = ("_mask", "_label", "_labels", "_gt", "_noBoundary", "_RGB")


def file_stem(name: str, suffixes: Tuple[str, ...] = LABEL_SUFFIXES) -> str:
    """Filename → pairing stem: drop the extension, then strip label/image
    suffixes repeatedly (nested forms like ``_label_noBoundary`` too).  The
    converters and the loaders share it, so they cannot disagree about
    which files pair."""
    base = os.path.basename(name)
    base = base[: base.rindex(".")] if "." in base else base
    stripped = True
    while stripped:
        stripped = False
        for suffix in suffixes:
            if base.endswith(suffix):
                base = base.removesuffix(suffix)
                stripped = True
    return base


def _paired_files(path: str) -> Tuple[dict, dict]:
    """{stem: image_path}, {stem: npy_path} with strict 1:1 stem matching."""
    img_by_stem: dict = {}
    npy_by_stem: dict = {}
    for name in sorted(os.listdir(path)):
        full = os.path.join(path, name)
        if not os.path.isfile(full):
            continue
        # <stem>_img.npy is an image stored as an array, not a mask.
        if name.endswith("_img.npy"):
            table = img_by_stem
            # An extension re-attached, so that a dotted stem
            # ("scene.v2_img.npy") is not stripped twice.
            s = file_stem(name[: -len("_img.npy")] + ".npy")
        elif name.endswith(".npy"):
            table = npy_by_stem
            s = file_stem(name)
        else:
            table = img_by_stem
            s = file_stem(name)
        if s in table:
            raise ValueError(
                f"{path}: duplicate stem {s!r} ({table[s]} vs {full}) — "
                f"cannot pair images and masks unambiguously"
            )
        table[s] = full
    unmatched = sorted(set(img_by_stem) ^ set(npy_by_stem))
    if not img_by_stem or unmatched:
        raise ValueError(
            f"{path}: every image needs a .npy mask with the same stem "
            f"(modulo _mask/_label/_gt suffixes; note *_img.npy files are "
            f"treated as ARRAY IMAGES, the prepare_* --format npy "
            f"convention); unmatched stems: "
            f"{unmatched[:10]}"
        )
    return img_by_stem, npy_by_stem


def _read_tile(
    img_path: str,
    npy_path: str,
    image_size: Optional[Tuple[int, int]],
    normalize: bool,
    channels: int = 3,
) -> Tuple[np.ndarray, np.ndarray]:
    """One (image, mask) pair from disk, the read of both the eager and the
    lazy tile datasets."""
    # int32 before padding: on a uint8 mask the -1 void pad would wrap.
    lab = np.load(npy_path).astype(np.int32)
    size = tuple(image_size) if image_size is not None else lab.shape[:2]
    if img_path.endswith(".npy"):
        img = np.load(img_path)
        if img.dtype != np.uint8:
            raise ValueError(
                f"{img_path}: array tiles must be uint8 raw imagery (the "
                f"prepare_* converters write uint8; a float array here "
                f"would be silently re-divided by 255), got {img.dtype}"
            )
        img = _finish_image(img, size, channels, normalize)
    else:
        img = load_image_file(
            img_path, size, channels=channels, normalize=normalize
        )
    lab = lab[: size[0], : size[1]]
    if lab.shape != size:
        # Void (-1), not class 0: padded pixels neither train nor score.
        lab = np.pad(
            lab,
            ((0, size[0] - lab.shape[0]), (0, size[1] - lab.shape[1])),
            constant_values=-1,
        )
    return img, lab


class LazyTileDataset:
    """Fixed-tile dataset that reads its tiles from disk at each
    ``gather()`` instead of stacking the directory resident (~20 GB for
    full Cityscapes at 512×1024); the loader's producer threads overlap
    the reads with the steps.  ``prepare_* --format npy`` tiles read
    without decoding.

    It has no ``.images``/``.labels`` arrays: the paths that need them
    (the device cache, the image dumps) take :meth:`materialize`'s or the
    eager loader's, and reading the attributes raises saying so.
    """

    def __init__(
        self,
        pairs: "list[Tuple[str, str]]",
        image_size: Optional[Tuple[int, int]] = None,
        normalize: bool = True,
        channels: int = 3,
    ):
        if not pairs:
            raise ValueError("LazyTileDataset needs at least one tile")
        self.pairs = list(pairs)
        self.image_size = tuple(image_size) if image_size else None
        self.normalize = normalize
        self.channels = channels
        img0, lab0 = _read_tile(
            *self.pairs[0], self.image_size, normalize, channels
        )
        self._shape = img0.shape

    def __len__(self) -> int:
        return len(self.pairs)

    def gather(self, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        idx = np.asarray(indices, np.int64)
        imgs = np.empty((len(idx), *self._shape), np.float32)
        labs = np.empty((len(idx), *self._shape[:2]), np.int32)
        self.gather_into(idx, imgs, labs)
        return imgs, labs

    def gather_into(
        self, indices: np.ndarray, img_out: np.ndarray, lab_out: np.ndarray
    ) -> None:
        """Read tiles from disk straight into caller-owned fp32/int32
        buffers."""
        idx = np.asarray(indices, np.int64)
        imgs = img_out.reshape(len(idx), *self._shape)
        labs = lab_out.reshape(len(idx), *self._shape[:2])
        for out, i in enumerate(idx):
            img, lab = _read_tile(
                *self.pairs[i], self.image_size, self.normalize, self.channels
            )
            if img.shape != self._shape:
                raise ValueError(
                    f"tile {self.pairs[i][0]}: shape {img.shape} != first "
                    f"tile {self._shape}; pass image_size to unify"
                )
            imgs[out] = img
            labs[out] = lab

    def set_epoch(self, epoch: int) -> None:
        """Fixed tiles: nothing depends on the epoch."""

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return self._shape  # type: ignore[return-value]

    def subset(self, start: int, stop: int) -> "LazyTileDataset":
        """File-list slice (train/test split without touching pixel data)."""
        ds = object.__new__(LazyTileDataset)
        ds.pairs = self.pairs[start:stop]
        if not ds.pairs:
            raise ValueError(f"empty subset [{start}:{stop}]")
        ds.image_size = self.image_size
        ds.normalize = self.normalize
        ds.channels = self.channels
        ds._shape = self._shape
        return ds

    def materialize(self) -> TileDataset:
        """Eager-load every tile (small splits, e.g. the eval holdout)."""
        imgs, labs = self.gather(np.arange(len(self)))
        return TileDataset(imgs, labs)

    def __getattr__(self, name):
        if name in ("images", "labels"):
            raise AttributeError(
                f"LazyTileDataset has no resident '{name}' array; use the "
                f"eager load_tile_dir (or .materialize()) for paths that "
                f"need whole-dataset arrays (device_cache, dumps)"
            )
        raise AttributeError(name)


def tile_dir_pairs(path: str) -> "list[Tuple[str, str]]":
    """Sorted (image_path, mask_path) pairs for a tile directory."""
    img_by_stem, npy_by_stem = _paired_files(path)
    return [(img_by_stem[s], npy_by_stem[s]) for s in sorted(img_by_stem)]


def load_tile_dir(
    path: str,
    image_size: Optional[Tuple[int, int]] = None,
    normalize: bool = True,
    lazy: bool = False,
) -> "TileDataset | LazyTileDataset":
    """Read one directory of images + ``.npy`` masks, paired strictly by
    stem; images crop or zero-pad to ``image_size``.  ``lazy=True`` returns
    a :class:`LazyTileDataset` (``data.lazy_tiles``)."""
    pairs = tile_dir_pairs(path)
    if lazy:
        return LazyTileDataset(pairs, image_size, normalize)
    images, labels = [], []
    for img_path, npy_path in pairs:
        img, lab = _read_tile(img_path, npy_path, image_size, normalize)
        images.append(img)
        labels.append(lab)
    return TileDataset(np.stack(images), np.stack(labels).astype(np.int32))


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


def dataset_defaults(name: str, **overrides) -> DataConfig:
    """A DataConfig pre-filled with a known dataset's geometry."""
    spec = DATASET_SPECS[name]
    kw = dict(
        dataset=name,
        image_size=spec["image_size"],
        num_classes=spec["num_classes"],
    )
    kw.update(overrides)
    return DataConfig(**kw)


def _synthetic_scenes(
    cfg: DataConfig, channels: int
) -> "list[Tuple[np.ndarray, np.ndarray]]":
    """A few large Vaihingen-like scenes (~3 crops on a side each), so that
    crop mode runs without a scene directory."""
    h, w = cfg.image_size
    n_scenes = max(2, cfg.test_split_scenes + 1)
    big = SyntheticTiles(
        num_tiles=n_scenes,
        image_size=(h * 3, w * 3),
        channels=channels,
        num_classes=cfg.num_classes,
        seed=cfg.seed,
    )
    return [(big.images[i], big.labels[i]) for i in range(n_scenes)]


def build_dataset(cfg: DataConfig):
    """(train, test) from a DataConfig; synthetic when ``data_dir`` is unset.

    Fixed-tile mode (``crops_per_epoch == 0``): the directory holds tiles;
    the last ``test_split`` are held out, and with ``lazy_tiles`` the
    training split reads from disk per gather while the holdout is
    materialized.  Crop mode (``crops_per_epoch > 0``): the directory holds
    scenes; train is a :class:`CropDataset`, test a grid tiling of the last
    ``test_split_scenes`` scenes.  ``augment`` wraps the training split in
    :class:`DihedralAugment`.  A config whose geometry differs from the
    named dataset's (``DATASET_SPECS``) wins, with a warning.
    """
    spec = DATASET_SPECS.get(cfg.dataset)
    if spec is not None and cfg.dataset != "synthetic":
        if (
            tuple(cfg.image_size) != spec["image_size"]
            or cfg.num_classes != spec["num_classes"]
        ):
            warnings.warn(
                f"DataConfig({cfg.dataset!r}) has image_size={cfg.image_size}, "
                f"num_classes={cfg.num_classes} but {cfg.dataset} is "
                f"{spec['image_size']}, {spec['num_classes']} classes; the "
                f"config wins — use dataset_defaults({cfg.dataset!r}) if "
                f"this is unintended",
                stacklevel=2,
            )
    channels = (spec or DATASET_SPECS["synthetic"])["channels"]
    if cfg.mmap_scenes and (not cfg.data_dir or cfg.crops_per_epoch <= 0):
        raise ValueError(
            "mmap_scenes needs crop mode over a scene directory "
            "(data_dir set and crops_per_epoch > 0); fixed-tile and "
            "synthetic datasets are loaded eagerly"
        )
    if cfg.lazy_tiles and cfg.crops_per_epoch > 0:
        raise ValueError(
            "lazy_tiles is a fixed-tile-mode option; crop mode over large "
            "scenes wants mmap_scenes instead"
        )
    if cfg.crops_per_epoch > 0:
        scenes = (
            load_scene_dir(cfg.data_dir, mmap=cfg.mmap_scenes)
            if cfg.data_dir
            else _synthetic_scenes(cfg, channels)
        )
        k = cfg.test_split_scenes
        if k < 0 or (k > 0 and k >= len(scenes)):
            raise ValueError(
                f"test_split_scenes={k} must leave at least one training "
                f"scene (directory has {len(scenes)})"
            )
        train_scenes = scenes[: len(scenes) - k] if k else scenes
        train = CropDataset(
            train_scenes,
            crop_size=tuple(cfg.image_size),
            crops_per_epoch=cfg.crops_per_epoch,
            seed=cfg.seed,
        )
        if cfg.augment:
            train = DihedralAugment(train, seed=cfg.seed)
        if k:
            test = grid_tiles(
                scenes[len(scenes) - k :],
                tuple(cfg.image_size),
                max_tiles=cfg.test_split or None,
            )
        else:
            test = TileDataset(
                np.zeros((0, *cfg.image_size, channels), np.float32),
                np.zeros((0, *cfg.image_size), np.int32),
            )
        return train, test
    if cfg.lazy_tiles:
        if not cfg.data_dir:
            raise ValueError(
                "lazy_tiles reads tiles from disk per gather — it needs "
                "data_dir (synthetic datasets are generated resident)"
            )
        lazy = load_tile_dir(
            cfg.data_dir, image_size=tuple(cfg.image_size), lazy=True
        )
        cut = last_n_split_point(len(lazy), cfg.test_split)
        train = lazy.subset(0, cut)
        # The holdout is small by design and the eval and dump paths need
        # resident arrays: materialize it.
        test = (
            lazy.subset(cut, len(lazy)).materialize()
            if cut < len(lazy) else
            TileDataset(
                np.zeros((0, *lazy.image_shape), np.float32),
                np.zeros((0, *lazy.image_shape[:2]), np.int32),
            )
        )
        if cfg.augment:
            train = DihedralAugment(train, seed=cfg.seed)
        return train, test
    if cfg.data_dir:
        ds = load_tile_dir(cfg.data_dir, image_size=tuple(cfg.image_size))
    else:
        generator = SYNTHETIC_GENERATORS.get(cfg.dataset, SyntheticTiles)
        ds = generator(
            num_tiles=cfg.synthetic_len,
            image_size=tuple(cfg.image_size),
            channels=channels,
            num_classes=cfg.num_classes,
            seed=cfg.seed,
        )
    train, test = train_test_split(ds, cfg.test_split)
    if cfg.augment:
        train = DihedralAugment(train, seed=cfg.seed)
    return train, test
