"""Convert an ISPRS Vaihingen/Potsdam checkout into the scene-directory
format — the port's copy of ``scripts/prepare_isprs.py``, which imports
the JAX package.

The benchmarks ship orthophoto scenes (``top_mosaic_*.tif`` /
``top_potsdam_*_RGB.tif``) with colour-coded ground truth; each pair
becomes ``<stem>.png`` (or, with ``--format npy``, the mmap-able uint8
``<stem>_img.npy``) and a ``<stem>.npy`` int32 index mask, which
``load_scene_dir`` (crop mode) and ``load_tile_dir`` read::

    python -m ddlpc_tpu_torch.data.prepare_isprs --images /data/vaihingen/top \\
        --labels /data/vaihingen/gts --out /data/vaihingen_scenes --format npy

PNG inputs decode with the port's decoder (``data/png.py``); TIFF and other
formats need imageio, imported only for such a file.  The files written
hold the same arrays as the script's: the ``.npy`` files byte for byte,
the PNGs the same pixels (the port's encoder compresses them otherwise).

Standard ISPRS class colours (both datasets):
  0 impervious surface (255,255,255)   3 tree       (0,255,0)
  1 building           (0,0,255)       4 car        (255,255,0)
  2 low vegetation     (0,255,255)     5 clutter    (255,0,0)
Pixels whose colour matches no class map to void (-1), which the loss and
the metrics ignore.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ddlpc_tpu_torch.data import png
from ddlpc_tpu_torch.data.datasets import decode_image_file, file_stem

ISPRS_COLORS = np.array(
    [
        [255, 255, 255],  # impervious surface
        [0, 0, 255],  # building
        [0, 255, 255],  # low vegetation
        [0, 255, 0],  # tree
        [255, 255, 0],  # car
        [255, 0, 0],  # clutter
    ],
    np.uint8,
)
VOID = -1
_IMAGE_EXTS = (".tif", ".tiff", ".png", ".jpg", ".jpeg", ".bmp")


def colors_to_indices(rgb: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 colour-coded mask → [H, W] int32 class ids, void=-1,
    as one lookup in a 24-bit table."""
    lut = np.full(1 << 24, VOID, np.int32)
    keys = (
        (ISPRS_COLORS[:, 0].astype(np.int64) << 16)
        | (ISPRS_COLORS[:, 1].astype(np.int64) << 8)
        | ISPRS_COLORS[:, 2].astype(np.int64)
    )
    lut[keys] = np.arange(len(ISPRS_COLORS), dtype=np.int32)
    rgb = rgb[..., :3].astype(np.int64)
    packed = (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]
    return lut[packed]


def convert(
    images_dir: str,
    labels_dir: str,
    out_dir: str,
    limit: int = 0,
    fmt: str = "png",
) -> int:
    def is_image(name: str) -> bool:
        # The downloads ship sidecars beside the rasters (Potsdam's .tfw
        # world files): filter by extension.
        return name.lower().endswith(_IMAGE_EXTS)

    label_by_stem = {}
    for name in sorted(os.listdir(labels_dir)):
        path = os.path.join(labels_dir, name)
        if os.path.isfile(path) and is_image(name):
            label_by_stem[file_stem(name)] = path
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(images_dir)):
        path = os.path.join(images_dir, name)
        if not os.path.isfile(path) or not is_image(name):
            continue
        stem = file_stem(name)
        if stem not in label_by_stem:
            raise FileNotFoundError(
                f"no label for image {name} (stem {stem!r}) in {labels_dir}"
            )
        img = decode_image_file(path)[..., :3]
        mask = colors_to_indices(decode_image_file(label_by_stem[stem]))
        if img.shape[:2] != mask.shape:
            raise ValueError(
                f"{stem}: image {img.shape[:2]} != label {mask.shape}"
            )
        if fmt == "npy":
            if img.dtype != np.uint8:
                raise ValueError(
                    f"{name}: --format npy requires uint8 source imagery, "
                    f"got {img.dtype} — an astype would wrap values mod 256 "
                    f"(300 → 44); rescale 16-bit sources first or use "
                    f"--format png"
                )
            np.save(
                os.path.join(out_dir, f"{stem}_img.npy"),
                np.ascontiguousarray(img),
            )
        else:
            png.write_png(os.path.join(out_dir, f"{stem}.png"), img)
        np.save(os.path.join(out_dir, f"{stem}.npy"), mask)
        n += 1
        if limit and n >= limit:
            break
    if n == 0:
        raise FileNotFoundError(f"no images found in {images_dir}")
    return n


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--images", required=True, help="dir of orthophoto scenes")
    p.add_argument("--labels", required=True, help="dir of colour-coded ground truth")
    p.add_argument("--out", required=True)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument(
        "--format", default="png", choices=["png", "npy"], dest="fmt",
        help="npy writes mmap-able uint8 <stem>_img.npy images for "
             "load_scene_dir(mmap=True) / data.mmap_scenes",
    )
    args = p.parse_args(argv)
    n = convert(args.images, args.labels, args.out, args.limit, fmt=args.fmt)
    print(f"wrote {n} (image, index-mask) scene pairs to {args.out}")


if __name__ == "__main__":
    main()
