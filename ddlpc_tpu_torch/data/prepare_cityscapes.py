"""Convert a Cityscapes checkout into the tile-directory format — the
port's copy of ``scripts/prepare_cityscapes.py``, without PIL.

Cityscapes ships ``leftImg8bit/<split>/<city>/*_leftImg8bit.png`` images
and ``gtFine/<split>/<city>/*_gtFine_labelIds.png`` masks of the 33 raw
label ids; training uses the 19 "trainId" classes with everything else
void (-1, which the loss, the metrics and the confusion matrix ignore).
Each frame is downscaled (bilinear for the image, nearest for the mask;
the committed Cityscapes config trains 1024×512 halves of the 2048×1024
frames) and written as ``<stem>.png`` (or the uint8 ``<stem>_img.npy``
with ``--format npy``) and a ``<stem>.npy`` int32 trainId mask::

    python -m ddlpc_tpu_torch.data.prepare_cityscapes --root /data/cityscapes \\
        --split train --out /data/cs_train --downscale 2 --format npy

The frames decode with the port's PNG decoder, and the resizes are
Pillow's arithmetic reproduced in numpy (:func:`resize_bilinear`,
:func:`resize_nearest`), so the arrays written are the script's: the
``.npy`` files byte for byte, the PNGs the same pixels (the port's encoder
compresses them otherwise).
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np

from ddlpc_tpu_torch.data import png

# labelId -> trainId for the standard 19-class Cityscapes benchmark
# (Cordts et al. 2016, the 'trainId' column of the official label table);
# every labelId not listed is void.
_TRAIN_IDS = {
    7: 0,  # road
    8: 1,  # sidewalk
    11: 2,  # building
    12: 3,  # wall
    13: 4,  # fence
    17: 5,  # pole
    19: 6,  # traffic light
    20: 7,  # traffic sign
    21: 8,  # vegetation
    22: 9,  # terrain
    23: 10,  # sky
    24: 11,  # person
    25: 12,  # rider
    26: 13,  # car
    27: 14,  # truck
    28: 15,  # bus
    31: 16,  # train
    32: 17,  # motorcycle
    33: 18,  # bicycle
}
VOID = -1
_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed point for 8-bit resampling


def labelids_to_trainids(label_ids: np.ndarray) -> np.ndarray:
    """[H, W] raw labelIds → int32 trainIds with void = -1."""
    lut = np.full(256, VOID, np.int32)
    for label_id, train_id in _TRAIN_IDS.items():
        lut[label_id] = train_id
    return lut[label_ids.astype(np.uint8)]


def _bilinear_coeffs(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` for the triangle filter over the
    whole input, then its 8-bit fixed-point rounding: ``(first input
    index, int64 weights [out, taps])``."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss)) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        for x in range(xmax):
            kk[xx, x] = w[x] / ww if ww != 0.0 else w[x]
        first[xx] = xmin
    one = float(1 << _PRECISION_BITS)
    fixed = np.where(kk < 0, np.trunc(-0.5 + kk * one), np.trunc(0.5 + kk * one)).astype(np.int64)
    return first, fixed


def _resample_axis(a: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One of Pillow's two 8-bit passes along ``axis`` of uint8 ``a``:
    each output sample is the fixed-point weighted sum of its taps, plus a
    half, shifted and clipped to 0..255."""
    in_size = a.shape[axis]
    first, fixed = _bilinear_coeffs(in_size, out_size)
    src = np.moveaxis(a, axis, 0).astype(np.int64)
    acc = np.full((out_size, *src.shape[1:]), 1 << (_PRECISION_BITS - 1), np.int64)
    for t in range(fixed.shape[1]):
        idx = np.minimum(first + t, in_size - 1)  # a zero weight past the end
        k = fixed[:, t].reshape(-1, *([1] * (src.ndim - 1)))
        acc += src[idx] * k
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bilinear(img: np.ndarray, size) -> np.ndarray:
    """uint8 ``[H, W]`` or ``[H, W, C]`` → ``size = (width, height)``, as
    Pillow's ``Image.resize(size, Image.BILINEAR)`` computes it for an 8-bit
    image without alpha: a horizontal pass, then a vertical one, each
    rounded to 8 bits."""
    w, h = size
    out = img
    if w != img.shape[1]:
        out = _resample_axis(out, w, 1)
    if h != img.shape[0]:
        out = _resample_axis(out, h, 0)
    return np.array(out, order="C")


def _nearest_taps(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's nearest-neighbour source indices: ``int(v)`` of
    ``v = s/2`` advanced by ``s = in/out`` an output sample (accumulated,
    as Pillow does, not multiplied)."""
    s = in_size / out_size
    taps = np.empty(out_size, np.int64)
    v = s * 0.5
    for i in range(out_size):
        taps[i] = int(v)
        v += s
    return taps


def resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """``size = (width, height)`` as Pillow's ``Image.resize(size,
    Image.NEAREST)``."""
    w, h = size
    in_h, in_w = img.shape[:2]
    if (w, h) == (in_w, in_h):
        return img.copy()
    return np.ascontiguousarray(img[_nearest_taps(in_h, h)][:, _nearest_taps(in_w, w)])


def _to_rgb(pixels: np.ndarray) -> np.ndarray:
    """Pillow's ``convert("RGB")`` of a decoded 8-bit image: gray (and
    gray+alpha) repeated, alpha dropped."""
    if pixels.ndim == 2:
        pixels = pixels[..., None]
    if pixels.shape[-1] in (1, 2):
        return np.repeat(pixels[..., :1], 3, axis=-1)
    return np.ascontiguousarray(pixels[..., :3])


def convert_split(
    root: str, split: str, out_dir: str, downscale: int = 1, limit: int = 0,
    fmt: str = "png",
) -> int:
    img_root = os.path.join(root, "leftImg8bit", split)
    gt_root = os.path.join(root, "gtFine", split)
    if not os.path.isdir(img_root):
        raise FileNotFoundError(f"no such split: {img_root}")
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for city in sorted(os.listdir(img_root)):
        city_dir = os.path.join(img_root, city)
        if not os.path.isdir(city_dir):
            continue
        for name in sorted(os.listdir(city_dir)):
            if not name.endswith("_leftImg8bit.png"):
                continue
            stem = name[: -len("_leftImg8bit.png")]
            gt_path = os.path.join(gt_root, city, f"{stem}_gtFine_labelIds.png")
            if not os.path.exists(gt_path):
                raise FileNotFoundError(f"missing mask for {stem}: {gt_path}")
            img = _to_rgb(png.read_png(os.path.join(city_dir, name)))
            mask = png.read_png(gt_path)
            if mask.ndim != 2:
                raise ValueError(f"{gt_path}: labelIds must be a gray image, got {mask.shape}")
            if downscale > 1:
                h, w = img.shape[:2]
                img = resize_bilinear(img, (w // downscale, h // downscale))
                # Nearest for masks: interpolating label ids invents classes.
                mask = resize_nearest(mask, (w // downscale, h // downscale))
            if fmt == "npy":
                np.save(os.path.join(out_dir, f"{stem}_img.npy"), np.ascontiguousarray(img))
            else:
                png.write_png(os.path.join(out_dir, f"{stem}.png"), img)
            np.save(os.path.join(out_dir, f"{stem}.npy"), labelids_to_trainids(mask))
            n += 1
            if limit and n >= limit:
                return n
    return n


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True, help="Cityscapes checkout root")
    p.add_argument("--split", default="train", choices=["train", "val", "test"])
    p.add_argument("--out", required=True, help="output tile directory")
    p.add_argument("--downscale", type=int, default=2)
    p.add_argument("--limit", type=int, default=0, help="stop after N frames")
    p.add_argument(
        "--format", default="png", choices=["png", "npy"], dest="fmt",
        help="npy writes uint8 <stem>_img.npy tiles for decode-free "
             "load_tile_dir(lazy=True) reads",
    )
    args = p.parse_args(argv)
    n = convert_split(args.root, args.split, args.out, args.downscale, args.limit, fmt=args.fmt)
    print(f"wrote {n} (image, trainId-mask) pairs to {args.out}")


if __name__ == "__main__":
    main()
