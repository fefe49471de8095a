"""The port's converters (``python -m ddlpc_tpu_torch.data.prepare_isprs``
and ``prepare_cityscapes``) against the scripts they copy, on fixtures
written here with imageio and PIL; Cityscapes' void labels through the
port's loss and confusion matrix against JAX's; the committed Cityscapes
config's model and conv FLOPs against JAX's; and the trainer on a
converted Cityscapes directory on the CPU.

Tolerances: the converters' ``.npy`` files byte for byte and their PNGs
pixel for pixel (the port's PNG encoder compresses with Python's zlib and
filter 0, Pillow with its own zlib build and per-row filters, so the
compressed bytes differ; the pixels do not).  The loss sums at rtol 1e-6
(both reduce in float32, in another order); the confusion matrices,
valid-pixel counts, parameter counts and FLOP counts exactly.
"""

import json
import os
import sys

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import prepare_cityscapes as jcs  # noqa: E402
import prepare_isprs as jisprs  # noqa: E402

from ddlpc_tpu.config import ExperimentConfig as JExperimentConfig  # noqa: E402
from ddlpc_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from ddlpc_tpu.models import build_model as jbuild_model  # noqa: E402
from ddlpc_tpu.obs import flops as jflops  # noqa: E402
from ddlpc_tpu.ops import losses as jlosses  # noqa: E402
from ddlpc_tpu.ops import metrics as jmetrics  # noqa: E402
from ddlpc_tpu_torch.config import ExperimentConfig  # noqa: E402
from ddlpc_tpu_torch.data import prepare_cityscapes as tcs  # noqa: E402
from ddlpc_tpu_torch.data import prepare_isprs as tisprs  # noqa: E402
from ddlpc_tpu_torch.models import build_model  # noqa: E402
from ddlpc_tpu_torch.obs import flops as obs_flops  # noqa: E402
from ddlpc_tpu_torch.ops import losses as tlosses  # noqa: E402
from ddlpc_tpu_torch.ops import metrics as tmetrics  # noqa: E402
from ddlpc_tpu_torch.train.__main__ import main as cli_main  # noqa: E402
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

CITYSCAPES = os.path.join(REPO, "configs", "cityscapes_unet_v5e64.json")


def _same_dirs(a: str, b: str) -> None:
    """The same file names; ``.npy`` byte for byte, PNGs pixel for pixel."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".npy"):
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), name
        else:
            x, y = imageio.imread(pa), imageio.imread(pb)
            assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), name


def _fake_isprs(root, ext: str) -> tuple:
    rng = np.random.default_rng(7)
    images, labels = root / "top", root / "gts"
    images.mkdir(parents=True)
    labels.mkdir()
    for i, (h, w) in enumerate(((24, 40), (31, 17), (20, 20))):
        stem = f"top_mosaic_09cm_area{i + 1}"
        imageio.imwrite(images / f"{stem}.{ext}", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        colours = np.concatenate([jisprs.ISPRS_COLORS, [[10, 20, 30]]])  # one colour is void
        imageio.imwrite(labels / f"{stem}_label_noBoundary.png",
                        colours[rng.integers(0, len(colours), (h, w))].astype(np.uint8))
    (images / "top_mosaic_09cm_area1.tfw").write_text("sidecar")
    return str(images), str(labels)


@pytest.mark.parametrize("fmt", ["png", "npy"])
@pytest.mark.parametrize("ext", ["png", "tif"])
def test_prepare_isprs_writes_the_scripts_files(tmp_path, fmt, ext):
    images, labels = _fake_isprs(tmp_path / "src", ext)
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jisprs.convert(images, labels, a, fmt=fmt) == 3
    tisprs.main(["--images", images, "--labels", labels, "--out", b, "--format", fmt])
    _same_dirs(a, b)
    np.testing.assert_array_equal(tisprs.ISPRS_COLORS, jisprs.ISPRS_COLORS)
    with pytest.raises(FileNotFoundError) as je:
        jisprs.convert(images, str(tmp_path / "src"), str(tmp_path / "x"), fmt=fmt)
    with pytest.raises(FileNotFoundError) as te:
        tisprs.convert(images, str(tmp_path / "src"), str(tmp_path / "y"), fmt=fmt)
    assert str(te.value) == str(je.value)


def _fake_cityscapes(root, size, frames=3, mode="RGB"):
    from PIL import Image

    rng = np.random.default_rng(0)
    h, w = size
    for i in range(frames):
        city = "aachen" if i < 2 else "bonn"
        img_dir = os.path.join(root, "leftImg8bit", "train", city)
        gt_dir = os.path.join(root, "gtFine", "train", city)
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(gt_dir, exist_ok=True)
        stem = f"{city}_{i:06d}_000019"
        smooth = np.cumsum(rng.integers(0, 9, (h, w, 3)), 1).astype(np.uint8)
        Image.fromarray(smooth).convert(mode).save(os.path.join(img_dir, f"{stem}_leftImg8bit.png"))
        label_ids = rng.choice([0, 1, 7, 8, 11, 21, 23, 26, 33], size=(h, w)).astype(np.uint8)
        Image.fromarray(label_ids, mode="L").save(os.path.join(gt_dir, f"{stem}_gtFine_labelIds.png"))


@pytest.mark.parametrize("fmt", ["png", "npy"])
@pytest.mark.parametrize("size,downscale,mode", [((64, 128), 2, "RGB"), ((35, 67), 2, "RGBA"),
                                                 ((40, 64), 3, "L"), ((16, 24), 1, "RGB")])
def test_prepare_cityscapes_writes_the_scripts_files(tmp_path, size, downscale, mode, fmt):
    root = str(tmp_path / "cs")
    _fake_cityscapes(root, size, mode=mode)
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jcs.convert_split(root, "train", a, downscale=downscale, fmt=fmt) == 3
    tcs.main(["--root", root, "--split", "train", "--out", b, "--downscale", str(downscale),
              "--format", fmt])
    _same_dirs(a, b)
    assert tcs.convert_split(root, "train", str(tmp_path / "lim"), downscale, limit=2, fmt=fmt) == 2
    ids = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(tcs.labelids_to_trainids(ids), jcs.labelids_to_trainids(ids))
    assert tcs._TRAIN_IDS == jcs._TRAIN_IDS


def test_void_labels_through_loss_and_confusion_equal_jax():
    """Cityscapes trainIds with void (-1, what ``prepare_cityscapes``
    writes for every unlisted labelId): the loss sum and the valid-pixel
    count ignore the void pixels, and so does the confusion matrix; an
    all-void batch gives zero pixels and a zero gradient, as in JAX."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 8, 8, 19)).astype(np.float32)
    label_ids = rng.choice([0, 4, 7, 8, 11, 21, 23, 26, 33, 255], size=(2, 8, 8)).astype(np.uint8)
    labels = tcs.labelids_to_trainids(label_ids)
    assert (labels == -1).any() and labels.max() <= 18
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    jy, ty = jnp.asarray(labels), torch.from_numpy(labels.astype(np.int64))
    j_nll, j_count = jlosses.softmax_cross_entropy_sum(jl, jy, ignore_index=-1)
    t_nll, t_count = tlosses.softmax_cross_entropy_sum(tl, ty, ignore_index=-1)
    assert float(t_count) == float(j_count) == float((labels != -1).sum())
    np.testing.assert_allclose(float(t_nll), float(j_nll), rtol=1e-6)
    jcm = jmetrics.confusion_from_logits(jl, jy, 19)
    tcm = tmetrics.confusion_from_logits(tl, ty, 19)
    np.testing.assert_array_equal(tcm.numpy(), np.asarray(jcm))
    assert tcm.sum() == (labels != -1).sum()
    void = torch.full((2, 8, 8), -1)
    tl.requires_grad_(True)
    nll, count = tlosses.softmax_cross_entropy_sum(tl, void, ignore_index=-1)
    nll.backward()
    assert float(count) == 0 and not tl.grad.any()


def test_cityscapes_config_model_equals_jax_and_counts_its_parameters():
    """The committed config's full-width U-Net (s2d ×4, bf16 head, 19
    classes): the port's parameter count equals JAX's (``eval_shape``, no
    compute) and is four times the flagship's 8,372,422; its conv FLOPs a
    step at micro 16 × sync 1 equal the JAX package's count, the integer
    ``chip_smoke.py`` holds the card's perf records to."""
    with open(CITYSCAPES) as f:
        text = f.read()
    cfg = ExperimentConfig.from_json(text)
    want = 2_588_254_666_752
    assert obs_flops.conv_step_flops(cfg, 16, 1) == want
    assert jflops.conv_step_flops(JExperimentConfig.from_json(text), 16, 1) == want
    n = sum(p.numel() for p in build_model(cfg.model).parameters())
    raw = json.load(open(CITYSCAPES))["model"]
    jmodel = jbuild_model(JModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                                          for k, v in raw.items()}))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 128, 256, 3)),
                                                train=False))
    jn = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert n == jn == 33_445_104
    assert 3.9 < n / 8_372_422 < 4.1


def test_trainer_on_a_converted_cityscapes_directory(tmp_path):
    """Converted frames with void pixels, a tiny 19-class U-Net, lazy npy
    tiles with the compact wire and two workers, two epochs on the CPU:
    finite losses, and the PNG dumps of void-labelled tiles written."""
    root = str(tmp_path / "cs")
    _fake_cityscapes(root, (64, 128), frames=6)
    tiles = str(tmp_path / "tiles")
    tcs.convert_split(root, "train", tiles, downscale=2, fmt="npy")
    cfg = {
        "model": {"features": [8, 16], "bottleneck_features": 16, "num_classes": 19,
                  "stem": "s2d", "stem_factor": 2, "compute_dtype": "float32"},
        "data": {"data_dir": tiles, "dataset": "cityscapes", "image_size": [32, 64],
                 "num_classes": 19, "test_split": 2, "lazy_tiles": True, "compact_upload": True,
                 "loader_workers": 2},
        "train": {"epochs": 2, "micro_batch_size": 2, "sync_period": 1,
                  "checkpoint_every_epochs": 0, "dump_images_per_epoch": 2},
        "compression": {"mode": "float16"},
    }
    path = tmp_path / "cs.json"
    path.write_text(json.dumps(cfg))
    with pytest.warns(UserWarning, match="the config wins"):
        cli_main(["--config", str(path), "--device", "cpu", "--no-resume",
                  "--workdir", str(tmp_path / "run")])
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        records = [r for r in map(json.loads, f) if "kind" not in r]
    assert [r["epoch"] for r in records] == [0, 1]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["val_loss"]) for r in records)
    assert len(records[-1]["val_iou_per_class"]) == 19
    assert sorted(os.listdir(tmp_path / "run" / "images" / "epoch_0001")) == [
        "Image 0.png", "Image 1.png", "Label 0.png", "Label 1.png", "Model 0.png", "Model 1.png"]
    with pytest.raises(ValueError, match=r"int8 labels, which cannot hold num_classes=128"):
        cfg["model"]["num_classes"] = cfg["data"]["num_classes"] = 128
        path.write_text(json.dumps(cfg))
        cli_main(["--config", str(path), "--device", "cpu", "--no-resume",
                  "--workdir", str(tmp_path / "run2")])
