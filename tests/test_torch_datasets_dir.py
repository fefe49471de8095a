"""The port's directory readers, crop and augmentation views and every
branch of ``build_dataset`` against the JAX package's, on fixtures that
the tests write under ``tmp_path`` with numpy and imageio.

Tolerance: none.  Both sides are numpy with the same seeded draws, so
every image is compared as float32 bytes and every label as int32 bytes;
the crop plans and dihedral transforms over three epochs (``set_epoch`` is
eager in both); the pairing and the refusals by exception type and message
(the same words).  The PNG decoder (``data/png.py``) is held against
imageio's decode of the same file, byte for byte, for every colour type
the decoder covers and all five row filters.
"""

import io
import os
import struct
import sys
import warnings
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest

from ddlpc_tpu.config import DataConfig as JDataConfig
from ddlpc_tpu.data import datasets as jd
from ddlpc_tpu_torch.config import DataConfig
from ddlpc_tpu_torch.data import datasets as td
from ddlpc_tpu_torch.data import png
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

EPOCHS = 3


def _same(a, b) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, a.shape, b.dtype, b.shape)
    assert a.tobytes() == b.tobytes()


def _both(fn_name: str, *args, **kwargs):
    """Run ``fn_name`` on both packages: (jax result, port result), or the
    two exceptions' (type, message) when both raise."""
    out = []
    for mod in (jd, td):
        try:
            out.append(getattr(mod, fn_name)(*args, **kwargs))
        except Exception as e:  # noqa: BLE001 - compared below
            out.append((type(e).__name__, str(e)))
    return out


# ---------------------------------------------------------------- fixtures


def write_tiles(path, n=9, hw=(16, 16), fmt="png", seed=11, ragged=False, mask_dtype=np.int32):
    """``n`` tiles of random uint8 imagery and masks with void pixels;
    ``ragged`` makes every third tile 4 px larger and every fourth 3 px
    smaller, so that crop and pad both run."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        h, w = hw
        if ragged and i % 3 == 0:
            h, w = h + 4, w + 4
        elif ragged and i % 4 == 1:
            h, w = h - 3, w - 3
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        lab = rng.integers(-1, 6, (h, w)).astype(mask_dtype)
        if fmt == "npy":
            np.save(os.path.join(path, f"tile_{i:02d}_img.npy"), img)
        else:
            imageio.imwrite(os.path.join(path, f"tile_{i:02d}.png"), img)
        np.save(os.path.join(path, f"tile_{i:02d}_label.npy"), lab)
    return str(path)


def write_scenes(path, sizes=((40, 52), (12, 30), (48, 40), (33, 47)), fmt="npy", seed=3):
    """Scenes of the given sizes (the second smaller than a 16 px crop, so
    that its padding runs), uint8 imagery and int32 masks with void."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(sizes):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        lab = rng.integers(-1, 6, (h, w)).astype(np.int32)
        if fmt == "npy":
            np.save(os.path.join(path, f"scene{i}_img.npy"), img)
        else:
            imageio.imwrite(os.path.join(path, f"scene{i}.png"), img)
        np.save(os.path.join(path, f"scene{i}_mask.npy"), lab)
    return str(path)


# ---------------------------------------------------------------- PNG decoder


def _filtered_png(pixels: np.ndarray, kinds, color: int) -> bytes:
    """An 8-bit PNG whose row ``y`` carries filter ``kinds[y]`` (the
    reference filters of the PNG specification, written out here)."""
    h, w = pixels.shape[:2]
    bpp = 1 if pixels.ndim == 2 else pixels.shape[2]
    rows = pixels.reshape(h, w * bpp).astype(np.int32)
    out, prev = [], np.zeros(w * bpp, np.int32)
    for y in range(h):
        cur = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        k = kinds[y]
        if k == 0:
            p = 0
        elif k == 1:
            p = left
        elif k == 2:
            p = prev
        elif k == 3:
            p = (left + prev) >> 1
        else:
            pa, pb, pc = np.abs(prev - ul), np.abs(left - ul), np.abs(left + prev - 2 * ul)
            p = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))
        out.append(np.concatenate([[k], (cur - p) & 255]).astype(np.uint8))
        prev = cur
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(np.stack(out).tobytes())) + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2), (0, 1, 2, 3, 4)])
@pytest.mark.parametrize("channels,color", [(1, 0), (2, 4), (3, 2), (4, 6)])
def test_png_decoder_matches_imageio_every_colour_type_and_filter(channels, color, filters):
    rng = np.random.default_rng(channels * 10 + len(filters))
    shape = (23, 19) if channels == 1 else (23, 19, channels)
    pixels = rng.integers(0, 256, shape, dtype=np.uint8)
    data = _filtered_png(pixels, rng.choice(filters, 23), color)
    got = png.decode_png(data)
    _same(got, np.asarray(imageio.imread(io.BytesIO(data))))
    _same(got, pixels)


@pytest.mark.parametrize("shape", [(64, 48, 3), (40, 56), (17, 33, 4), (21, 15, 2)])
def test_png_decoder_matches_imageio_on_imageio_written_files(shape, tmp_path):
    """Pillow (imageio's writer) chooses a filter a row; smooth and noisy
    content make it choose several."""
    rng = np.random.default_rng(sum(shape))
    smooth = np.cumsum(np.cumsum(rng.integers(0, 3, shape), 0), 1).astype(np.uint8)
    for k, pixels in enumerate((rng.integers(0, 256, shape, dtype=np.uint8), smooth)):
        path = str(tmp_path / f"{k}.png")
        imageio.imwrite(path, pixels)
        _same(png.read_png(path), imageio.imread(path))


def test_png_decoder_palette_and_own_encoder(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    path = str(tmp_path / "p.png")
    Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE).save(path)
    _same(png.read_png(path), imageio.imread(path))
    for pixels in (rgb, rgb[..., 0], rgb[..., :2], np.concatenate([rgb, rgb[..., :1]], -1)):
        png.write_png(path, pixels)
        _same(imageio.imread(path), pixels)
        _same(png.read_png(path), pixels)


def test_png_decoder_refuses_what_it_does_not_cover(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(2)
    cases = {}
    path = str(tmp_path / "16.png")
    imageio.imwrite(path, rng.integers(0, 65535, (8, 8), dtype=np.uint16))
    cases["bit depth 16"] = open(path, "rb").read()
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 1)
    cases["interlaced"] = (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
                           + png._chunk(b"IDAT", zlib.compress(bytes(4 * 13))) + png._chunk(b"IEND", b""))
    p = Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).convert("P")
    buf = io.BytesIO()
    p.save(buf, format="PNG", transparency=0)
    cases["tRNS"] = buf.getvalue()
    good = png.encode_png(np.zeros((4, 4, 3), np.uint8))
    cases["CRC"] = good[:40] + bytes([good[40] ^ 1]) + good[41:]
    cases["not a PNG"] = b"GIF89a" + good[6:]
    for what, data in cases.items():
        with pytest.raises(png.PNGError, match=what):
            png.decode_png(data)


def test_other_formats_need_imageio_and_decode_as_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)
    path = str(tmp_path / "a.tif")
    imageio.imwrite(path, img)
    _same(td.load_image_file(path, (16, 8)), jd.load_image_file(path, (16, 8)))
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(ValueError, match="--format npy"):
        td.load_image_file(path, None)
    # A PNG never needs imageio.
    imageio_free = str(tmp_path / "b.png")
    png.write_png(imageio_free, img)
    _same(td.load_image_file(imageio_free, None), img.astype(np.float32) / np.float32(255.0))


# ---------------------------------------------------------------- readers


@pytest.mark.parametrize("image_size", [None, (16, 16), (12, 20)])
@pytest.mark.parametrize("fmt", ["png", "npy"])
def test_load_tile_dir_eager_and_lazy_equal_jax(tmp_path, fmt, image_size):
    ragged = image_size is not None
    d = write_tiles(tmp_path / "t", fmt=fmt, ragged=ragged, mask_dtype=np.uint8 if ragged else np.int32)
    if ragged:  # uint8 masks: the void pad must not wrap to 255
        for name in os.listdir(d):
            if name.endswith("_label.npy"):
                lab = np.load(os.path.join(d, name))
                np.save(os.path.join(d, name), np.where(lab == 255, 0, lab).astype(np.uint8))
    assert td.tile_dir_pairs(d) == jd.tile_dir_pairs(d)
    j = jd.load_tile_dir(d, image_size=image_size)
    t = td.load_tile_dir(d, image_size=image_size)
    _same(t.images, j.images)
    _same(t.labels, j.labels)
    if ragged:
        assert (t.labels == -1).any()
    jl = jd.load_tile_dir(d, image_size=image_size, lazy=True)
    tl = td.load_tile_dir(d, image_size=image_size, lazy=True)
    assert isinstance(tl, td.LazyTileDataset) and tl.image_shape == jl.image_shape
    idx = np.array([4, 0, 8, 2, 4])
    for a, b in zip(tl.gather(idx), jl.gather(idx)):
        _same(a, b)
    _same(tl.gather(idx)[0], t.images[idx])
    sub = tl.subset(2, 6)
    _same(sub.materialize().images, jl.subset(2, 6).materialize().images)
    _same(sub.materialize().labels, t.labels[2:6])
    for name in ("images", "labels"):
        msgs = []
        for lazy in (jl, tl):
            with pytest.raises(AttributeError) as e:
                getattr(lazy, name)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1] and "materialize" in msgs[0]
    with pytest.raises(AttributeError):
        tl.no_such_attribute


@pytest.mark.parametrize("mode", ["eager_png", "eager_npy", "mmap_npy"])
def test_load_scene_dir_equal_jax(tmp_path, mode):
    fmt = mode.split("_")[1]
    d = write_scenes(tmp_path / "s", fmt=fmt)
    mmap = mode.startswith("mmap")
    j = jd.load_scene_dir(d, mmap=mmap)
    t = td.load_scene_dir(d, mmap=mmap)
    assert len(t) == len(j) == 4
    for (ti, tl), (ji, jl) in zip(t, j):
        _same(ti, ji)
        _same(tl, jl)
        if mmap:
            assert isinstance(ti, np.memmap) and isinstance(tl, np.memmap)


def _refusal_dirs(tmp_path):
    """{case: (function, args, kwargs)} over directories that each break
    one rule of the readers."""
    rng = np.random.default_rng(8)
    u8 = lambda *s: rng.integers(0, 256, s, dtype=np.uint8)  # noqa: E731
    lab = lambda *s: rng.integers(0, 6, s).astype(np.int32)  # noqa: E731

    def mk(name, files):
        d = tmp_path / name
        d.mkdir()
        for fname, arr in files.items():
            if fname.endswith(".png"):
                imageio.imwrite(d / fname, arr)
            else:
                np.save(d / fname, arr)
        return str(d)

    return {
        "unmatched": ("load_tile_dir", (mk("unmatched", {"a.png": u8(8, 8, 3), "b.npy": lab(8, 8)}),), {}),
        "duplicate": ("load_tile_dir", (mk("duplicate", {"a.png": u8(8, 8, 3), "a_gt.png": u8(8, 8, 3),
                                                          "a.npy": lab(8, 8)}),), {}),
        "empty": ("load_scene_dir", (mk("empty", {}),), {}),
        "mmap_png": ("load_scene_dir", (mk("mmap_png", {"a.png": u8(8, 8, 3), "a.npy": lab(8, 8)}),),
                     {"mmap": True}),
        "mmap_float": ("load_scene_dir", (mk("mmap_float", {"a_img.npy": u8(8, 8, 3).astype(np.float32),
                                                             "a.npy": lab(8, 8)}),), {"mmap": True}),
        "mmap_shape": ("load_scene_dir", (mk("mmap_shape", {"a_img.npy": u8(8, 8), "a.npy": lab(8, 8)}),),
                       {"mmap": True}),
        "mmap_mask": ("load_scene_dir", (mk("mmap_mask", {"a_img.npy": u8(8, 8, 3),
                                                           "a.npy": lab(8, 8).astype(np.int64)}),),
                      {"mmap": True}),
        "mmap_unnormalized": ("load_scene_dir", (str(tmp_path / "mmap_mask"),),
                              {"mmap": True, "normalize": False}),
        "eager_float": ("load_scene_dir", (mk("eager_float", {"a_img.npy": u8(8, 8, 3).astype(np.float32),
                                                               "a.npy": lab(8, 8)}),), {}),
        "eager_shape": ("load_scene_dir", (mk("eager_shape", {"a_img.npy": u8(8, 8, 4),
                                                               "a.npy": lab(8, 8)}),), {}),
        "tile_float": ("load_tile_dir", (str(tmp_path / "eager_float"),), {}),
        "lazy_shape": ("load_tile_dir", (mk("lazy_shape", {"a_img.npy": u8(8, 8, 3), "a.npy": lab(8, 8),
                                                            "b_img.npy": u8(9, 8, 3), "b.npy": lab(9, 8)}),),
                       {"lazy": True}),
    }


def test_reader_refusals_are_jax_words(tmp_path):
    for case, (fn, args, kwargs) in _refusal_dirs(tmp_path).items():
        if case == "lazy_shape":  # raises at its gather (the next test)
            continue
        j, t = _both(fn, *args, **kwargs)
        assert isinstance(j, tuple) and j == t, (case, j, t)
        assert j[0] == "ValueError", case


def test_lazy_tile_of_another_shape_is_refused_in_jax_words(tmp_path):
    fn, args, kwargs = _refusal_dirs(tmp_path)["lazy_shape"]
    msgs = []
    for mod in (jd, td):
        lazy = getattr(mod, fn)(*args, **kwargs)
        with pytest.raises(ValueError) as e:
            lazy.gather(np.arange(2))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "pass image_size" in msgs[0]


def test_dotted_stems_and_file_stem():
    for name in ("top_mosaic_09cm_area1_label_noBoundary.tif", "scene.v2_img.npy", "a_RGB.png",
                 "no_extension", "x_mask.npy"):
        assert td.file_stem(name) == jd.file_stem(name)
    assert td.LABEL_SUFFIXES == jd.LABEL_SUFFIXES


# ---------------------------------------------------------------- views and build_dataset


def _dirs(tmp_path):
    return {
        "tiles_png": write_tiles(tmp_path / "tiles_png", n=14, fmt="png"),
        "tiles_npy": write_tiles(tmp_path / "tiles_npy", n=14, fmt="npy"),
        "scenes_png": write_scenes(tmp_path / "scenes_png", fmt="png"),
        "scenes_npy": write_scenes(tmp_path / "scenes_npy", fmt="npy"),
    }


BASE = dict(dataset="synthetic", image_size=(16, 16), num_classes=6, test_split=4, seed=7)
MODES = {
    "eager_png": dict(data_dir="tiles_png"),
    "eager_npy_augment": dict(data_dir="tiles_npy", augment=True),
    "lazy_npy": dict(data_dir="tiles_npy", lazy_tiles=True),
    "lazy_png_augment": dict(data_dir="tiles_png", lazy_tiles=True, augment=True),
    "lazy_no_holdout": dict(data_dir="tiles_npy", lazy_tiles=True, test_split=0),
    "crop_png": dict(data_dir="scenes_png", crops_per_epoch=11),
    "crop_npy_augment": dict(data_dir="scenes_npy", crops_per_epoch=11, augment=True),
    "crop_mmap": dict(data_dir="scenes_npy", crops_per_epoch=11, mmap_scenes=True),
    "crop_mmap_augment": dict(data_dir="scenes_npy", crops_per_epoch=13, mmap_scenes=True, augment=True,
                              test_split_scenes=2, test_split=3),
    "crop_no_holdout": dict(data_dir="scenes_npy", crops_per_epoch=5, test_split_scenes=0),
    "crop_synthetic": dict(crops_per_epoch=9, test_split_scenes=1),
    "synthetic_augment": dict(synthetic_len=10, augment=True),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_build_dataset_every_mode_equal_jax_over_three_epochs(tmp_path, mode):
    dirs = _dirs(tmp_path) if MODES[mode].get("data_dir") else {}
    kw = {**BASE, **MODES[mode]}
    if "data_dir" in kw:
        kw["data_dir"] = dirs[kw["data_dir"]]
    jtrain, jtest = jd.build_dataset(JDataConfig(**kw))
    ttrain, ttest = td.build_dataset(DataConfig(**kw))
    assert type(ttrain).__name__ == type(jtrain).__name__
    assert type(ttest).__name__ == type(jtest).__name__ == "TileDataset"
    assert len(ttrain) == len(jtrain) and len(ttest) == len(jtest)
    _same(ttest.images, jtest.images)
    _same(ttest.labels, jtest.labels)
    assert ttrain.image_shape == jtrain.image_shape
    n = len(ttrain)
    order = np.random.default_rng(0).permutation(n)
    for e in range(EPOCHS):
        jtrain.set_epoch(e)
        ttrain.set_epoch(e)
        ji, jl = jtrain.gather(order)
        ti, tl = ttrain.gather(order)
        _same(ti, ji)
        _same(tl, jl)
        # gather_into, the loader's path, serves the same bytes.
        img_out = np.empty_like(ti)
        lab_out = np.empty_like(tl)
        td.gather_into(ttrain, order, img_out, lab_out)
        _same(img_out, ji)
        _same(lab_out, jl)
        if e == 0:
            first = ti
    if kw.get("crops_per_epoch") or kw.get("augment"):
        assert not np.array_equal(first, ti)  # the epochs really differ


def test_build_dataset_refusals_and_warning_are_jax_words(tmp_path):
    dirs = _dirs(tmp_path)
    cases = [
        dict(BASE, mmap_scenes=True),
        dict(BASE, mmap_scenes=True, crops_per_epoch=4),
        dict(BASE, data_dir=dirs["tiles_npy"], mmap_scenes=True),
        dict(BASE, lazy_tiles=True),
        dict(BASE, data_dir=dirs["tiles_npy"], lazy_tiles=True, crops_per_epoch=4),
        dict(BASE, data_dir=dirs["scenes_npy"], crops_per_epoch=4, test_split_scenes=4),
        dict(BASE, data_dir=dirs["scenes_npy"], crops_per_epoch=4, test_split_scenes=-1),
        dict(BASE, data_dir=dirs["tiles_npy"], lazy_tiles=True, test_split=14),
        dict(BASE, data_dir=dirs["tiles_npy"], test_split=20),
        dict(BASE, synthetic_len=4, test_split=4),
    ]
    for kw in cases:
        msgs = []
        for mod, cfg in ((jd, JDataConfig(**kw)), (td, DataConfig(**kw))):
            with pytest.raises(ValueError) as e:
                mod.build_dataset(cfg)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], kw
    # A crop mode over non-square tiles refuses augmentation at first use.
    kw = dict(BASE, image_size=(16, 12), data_dir=dirs["scenes_npy"], crops_per_epoch=4, augment=True)
    msgs = []
    for mod, cfg in ((jd, JDataConfig(**kw)), (td, DataConfig(**kw))):
        train, _ = mod.build_dataset(cfg)
        with pytest.raises(ValueError) as e:
            train.gather(np.arange(2))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "square tiles" in msgs[0]
    # The geometry warning, word for word.
    kw = dict(dataset="cityscapes", image_size=(32, 64), num_classes=19, synthetic_len=6, test_split=2)
    caught = []
    for mod, cfg in ((jd, JDataConfig(**kw)), (td, DataConfig(**kw))):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            mod.build_dataset(cfg)
        caught.append([str(x.message) for x in w])
    assert caught[0] == caught[1] and len(caught[0]) == 1 and "the config wins" in caught[0][0]


def test_crop_dataset_and_views_refuse_in_jax_words():
    rng = np.random.default_rng(0)
    scene = (rng.integers(0, 256, (20, 20, 3), dtype=np.uint8), np.zeros((20, 20), np.int32))
    bad = (scene[0], np.zeros((20, 19), np.int32))
    for args, kwargs in (
        (([], (8, 8), 4), {}),
        (([scene], (8, 8), 0), {}),
        (([scene, bad], (8, 8), 4), {}),
    ):
        j, t = _both("CropDataset", *args, **kwargs)
        assert isinstance(j, tuple) and j == t
    j, t = _both("grid_tiles", [scene], (32, 32))
    assert isinstance(j, tuple) and j == t


def test_grid_tiles_and_dataset_defaults_equal_jax():
    rng = np.random.default_rng(5)
    u8 = rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)
    lab = rng.integers(-1, 6, (40, 36)).astype(np.int32)
    f32 = u8.astype(np.float32) / np.float32(255.0)
    for scenes, cap in (([(u8, lab)], None), ([(f32, lab), (u8, lab)], 5), ([(u8, lab)], 2)):
        j, t = _both("grid_tiles", scenes, (16, 16), max_tiles=cap)
        _same(t.images, j.images)
        _same(t.labels, j.labels)
    for name in ("vaihingen", "potsdam", "cityscapes"):
        j, t = jd.dataset_defaults(name, seed=3), td.dataset_defaults(name, seed=3)
        assert (t.dataset, tuple(t.image_size), t.num_classes, t.seed) == (
            j.dataset, tuple(j.image_size), j.num_classes, j.seed)
