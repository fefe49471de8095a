"""U-Net++ and bilinear up-sampling under the port's space axis, against
the JAX package's GSPMD step (``make_train_step_gspmd``).

Three tiny fp32 models train two optimizer steps (no codec, as the
committed U-Net++ configs run) on a (data 1 × space 2) grid of two gloo
processes (``tests/test_torch_grid_worker.py``), every rank from the same
seeded weights in the flax layout (carried over by ``convert.py``) and
taking its rows of the same numpy batches, whose void labels lie in the
top shard only; JAX runs ``make_train_step_gspmd`` on a (1, 2) slice of
the 8-device CPU mesh:

- ``unetpp``: U-Net++ (8, 16, 32) with deep supervision, no stem, no
  detail head, transposed convs, on 24 rows: 12 a shard, a whole number
  of U-Net++'s row unit (2**2, two pools) but not of the U-Net's (2**3);
- ``unetpp_s2d_bilinear``: the same with the s2d ×2 stem, the stem-grid
  detail head and bilinear up-sampling;
- ``unet_bilinear``: the tiny U-Net of ``tests/test_torch_spatial.py``
  (s2d ×2, full-resolution DetailHead) with bilinear up-sampling.

Tolerances, those of ``tests/test_torch_spatial.py``: the losses at rtol
1e-4, the BatchNorm statistics at rtol 1e-4 / atol 1e-6, the params at
rtol 1e-4 / atol 1e-6 but for at most 2 % of them, each within ``2·lr``
a step; every rank holds the same state bit for bit.  U-Net++'s
statistics after the second step are chaotic in fp32: JAX's own GSPMD
step and its one-device step on the same batches differ by 182× (plain)
and 262× (s2d, bilinear) that element-wise bound, deep in the net where a
mean is near zero.  They are held, as ``tests/test_torch_train_step_zoo.py``
holds U-Net++'s fp32 statistics against JAX, within 1e-4 of each leaf's
largest value (JAX's two programs differ by 29× that; the port's sharded
step and JAX's GSPMD step by at most 0.53×).

The clamped halo alone: the sharded ``layers.upsample_2x`` at space 2
and 4, odd and even local rows, both pass orders, against the unsharded
resize.  In bf16 the forward is bit for bit (each output is one rounding
of an exact float sum); in fp32 PyTorch's CPU resize rounds its taps'
products in an order that depends on the array's extent.  The gradient
adds a halo's cotangent into its row after the shard's own sum, rounded
apart, where the unsharded backward sums in one pass: in bf16 bit for bit
off the rows next to a shard edge.  Where they differ, by at most four
roundings of the magnitude of the terms summed.

The trainer: a tiny U-Net++ through ``Trainer`` at space 2 counts half
the unsharded step's FLOPs, and its checkpoint restores into an unsharded
trainer bit for bit.
"""

import json

import numpy as np
import pytest
import torch

from ddlpc_tpu.config import ModelConfig as JModelConfig
from ddlpc_tpu.data import datasets as jdatasets
from ddlpc_tpu.models import build_model as jbuild_model
from ddlpc_tpu_torch.config import ModelConfig
from ddlpc_tpu_torch.convert import gather_canonical, torch_state_from_flax
from ddlpc_tpu_torch.models import (
    build_model,
    check_space_rows,
    shard_space,
    space_off,
    space_pools,
)
from ddlpc_tpu_torch.models.layers import Conv, UpBlock, upsample_2x
from ddlpc_tpu_torch.obs import flops as obs_flops
from ddlpc_tpu_torch.parallel.halo import halo_exchange
from ddlpc_tpu_torch.train.__main__ import parse_args
from ddlpc_tpu_torch.train.trainer import Trainer
from test_torch_grid_worker import run_grid
from test_torch_model import flax_like_variables
from test_torch_spatial import _jax_gspmd, _port_part
from test_torch_train_step import LR, TINY, _tiny_cli_config

A, B, STEPS = 2, 2, 2  # micro-batches a step, micro-batch, steps
F32 = dict(compute_dtype="float32", head_dtype="float32")
PP = dict(name="unetpp", features=(8, 16, 32), deep_supervision=True, num_classes=6, **F32)
MODELS = {  # name: (model, tile rows and columns)
    "unetpp": (PP, 24),
    "unetpp_s2d_bilinear": (dict(PP, stem="s2d", stem_factor=2, detail_head=True,
                                 detail_head_kind="s2d", up_sample_mode="bilinear"), 32),
    "unet_bilinear": (dict(TINY, up_sample_mode="bilinear"), 32),
}
CODEC = {"mode": "none"}


def _batches(h: int, seed: int):
    ds = jdatasets.SyntheticTiles(num_tiles=STEPS * A * B, image_size=(h, h), seed=seed,
                                  num_classes=6)
    labels = ds.labels.copy()
    labels[:, :5, :7] = -1  # void pixels, all in the top space shard
    return ds.images.reshape(STEPS, A, B, h, h, 3), labels.reshape(STEPS, A, B, h, h)


def _listed(kw: dict) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v for k, v in kw.items()}


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """Each model through JAX's GSPMD step and through the port's ranks,
    the port's three in one world: ``{name: (jax, [rank outputs])}``, a
    rank's keys ``<run>:<key>`` in ``MODELS``' order."""
    inputs, runs, want = {}, [], {}
    for i, (name, (kw, h)) in enumerate(MODELS.items()):
        images, labels = _batches(h, seed=4 + i)
        variables = flax_like_variables(jbuild_model(JModelConfig(**kw)))
        params0, stats0 = variables["params"], variables.get("batch_stats", {})
        sd, _ = torch_state_from_flax(params0, stats0)
        inputs.update({f"{name}/sd/{k}": v.numpy() for k, v in sd.items()})
        inputs.update({f"{name}/images": images, f"{name}/labels": labels})
        runs.append({"level": "off", "model": _listed(kw), "prefix": f"{name}/"})
        want[name] = _jax_gspmd(params0, stats0, images, labels, kw, CODEC, grid=(1, 2))
    outs = run_grid("spatial", (1, 1, 2), str(tmp_path_factory.mktemp("zoo")),
                    {"lr": LR, "compression": CODEC, "runs": runs}, inputs)
    return {name: (want[name], i, outs) for i, name in enumerate(MODELS)}


@pytest.mark.parametrize("name", list(MODELS))
def test_losses_and_batch_stats_match_jax_gspmd(name, zoo):
    jout, run, outs = zoo[name]
    for r, out in enumerate(outs):
        np.testing.assert_allclose([float(out[f"{run}:loss{s}"]) for s in range(STEPS)],
                                   jout["losses"], rtol=1e-4, err_msg=f"rank {r}")
        got = _port_part(out, "batch_stats", run)
        assert got.keys() == jout["batch_stats"].keys()
        for k, want in jout["batch_stats"].items():
            if MODELS[name][0].get("name") == "unetpp":
                assert np.abs(got[k] - want).max() <= 1e-4 * np.abs(want).max(), k
            else:
                np.testing.assert_allclose(got[k], want, rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", list(MODELS))
def test_params_match_jax_gspmd_and_every_rank_agrees(name, zoo):
    jout, run, outs = zoo[name]
    got = _port_part(outs[0], "params", run)
    assert got.keys() == jout["params"].keys()
    total = off = 0
    for k, want in jout["params"].items():
        diff = np.abs(got[k] - want)
        off += int((diff > 1e-4 * np.abs(want) + 1e-6).sum())
        total += want.size
        assert diff.max() <= STEPS * 2 * LR, (k, diff.max())
    assert off <= 2e-2 * total, (off, total)
    for k in outs[0]:
        if k.startswith(f"{run}:"):
            np.testing.assert_array_equal(outs[1][k], outs[0][k], err_msg=k)


# ---- the clamped halo alone ------------------------------------------------------

# (local rows, columns): odd and even rows; 7 columns resize the rows
# first at every global height here, 40 the columns first.
UPSAMPLE_SHAPES = ((5, 7), (8, 40))
DTYPES = ("float32", "bfloat16")


@pytest.fixture(scope="module")
def upsampled(tmp_path_factory):
    """``{space: (inputs, [rank outputs])}`` of every case at space 2 and 4."""
    worlds = {}
    for space in (2, 4):
        rng = np.random.default_rng(space)
        cases, inputs = [], {}
        for h, w in UPSAMPLE_SHAPES:
            x = rng.normal(size=(2, space * h, w, 3)).astype(np.float32)
            g = rng.normal(size=(2, 2 * space * h, 2 * w, 3)).astype(np.float32)
            for dtype in DTYPES:
                name = f"{h}x{w}_{dtype}"
                cases.append({"name": name, "upsample": True, "dtype": dtype})
                inputs.update({f"{name}/x": x, f"{name}/w": g})
        outs = run_grid("halo", (1, 1, space), str(tmp_path_factory.mktemp(f"up{space}")),
                        {"cases": cases}, inputs)
        worlds[space] = (inputs, outs)
    return worlds


ROUNDING = {"float32": 2.0**-24, "bfloat16": 2.0**-8}  # a rounding's relative error


def _upsampled(x: np.ndarray, w: np.ndarray, dtype: str):
    """The unsharded ``upsample_2x`` of NHWC ``x`` in ``dtype`` and its
    gradient against ``w``, as fp32 NHWC."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(getattr(torch, dtype)).requires_grad_(True)
    y = upsample_2x(xt)
    y.backward(torch.from_numpy(w).permute(0, 3, 1, 2).to(y.dtype))
    return y.detach().permute(0, 2, 3, 1).float().numpy(), xt.grad.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", UPSAMPLE_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("space", [2, 4])
def test_clamped_halo_upsample_equals_the_unsharded(space, shape, dtype, upsampled):
    """Where the sides differ, by at most four roundings of the magnitude
    of the terms summed (the resize and its gradient of ``|x|`` and
    ``|w|``): the sums cancel, so a bound on the result's own ulp would
    not hold."""
    inputs, outs = upsampled[space]
    h, _ = shape
    name = f"{h}x{shape[1]}_{dtype}"
    x, w = inputs[f"{name}/x"], inputs[f"{name}/w"]
    want_y, want_g = _upsampled(x, w, dtype)
    terms_y, terms_g = _upsampled(np.abs(x), np.abs(w), "float32")
    got_y = np.concatenate([o[f"{name}/y"] for o in outs], axis=1)
    got_g = np.concatenate([o[f"{name}/gx"] for o in outs], axis=1)
    edge = np.zeros(space * h, bool)  # the rows next to a shard edge
    edge[::h] = edge[h - 1 :: h] = True
    bound = 4 * ROUNDING[dtype]
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got_y, want_y)
        np.testing.assert_array_equal(got_g[:, ~edge], want_g[:, ~edge])
    assert (np.abs(got_y - want_y) <= bound * terms_y).all()
    assert (np.abs(got_g - want_g) <= bound * terms_g).all()


@pytest.mark.parametrize("axis", [1, 2])
def test_clamped_halo_of_a_single_shard_repeats_its_edge_rows(axis):
    """Without a space group the clamped halo is replicate padding, and its
    gradient sums the copies' cotangents into the edge rows."""
    x = torch.arange(2 * 3 * 4 * 5, dtype=torch.float64).reshape(2, 3, 4, 5).requires_grad_(True)
    y = halo_exchange(x, 2, spatial_axis=axis, edge="clamp")
    idx = torch.tensor([0, 0, *range(x.shape[axis]), x.shape[axis] - 1, x.shape[axis] - 1])
    torch.testing.assert_close(y, x.index_select(axis, idx), rtol=0, atol=0)
    g = torch.randint(-8, 8, y.shape, generator=torch.Generator().manual_seed(0)).double()
    y.backward(g)  # integer cotangents: every order of summing them is exact
    want = torch.zeros_like(x).index_add_(axis, idx, g)
    torch.testing.assert_close(x.grad, want, rtol=0, atol=0)


# ---- the row unit, the refusals and space_off ------------------------------------


def test_unetpp_accepts_a_height_the_unet_refuses():
    """24 rows over 2: 12 a shard.  U-Net++ (8, 16, 32) pools twice
    (unit 4), the U-Net of the same features three times (unit 8)."""
    pp = ModelConfig(name="unetpp", features=(8, 16, 32))
    unet = ModelConfig(features=(8, 16, 32), bottleneck_features=32)
    assert (space_pools(pp), space_pools(unet)) == (2, 3)
    assert MODELS["unetpp"][1] == 24  # the world above trains U-Net++ at this height
    check_space_rows(24, 2, 1, space_pools(pp))
    with pytest.raises(ValueError, match="deviation"):
        check_space_rows(24, 2, 1, space_pools(unet))
    sharded = shard_space(build_model(unet), 1, 2)
    with pytest.raises(ValueError, match=r"1·2\*\*3 = 8"):
        sharded(torch.zeros(1, 12, 24, 3))


@pytest.mark.parametrize("kind", ["deeplabv3p", "strided_conv"])
def test_shard_space_refuses_deeplab_and_strided_convs_naming_a6_3(kind):
    """Both were refused until ROADMAP A6.3 ported them: DeepLabV3+ now
    shards, and a 3×3 stride-2 conv takes the one row from below that
    flax's (0, 1) pad reads; what stays refused is a shard whose rows are
    off the model's row unit, naming A6.4 (uneven shards)."""
    if kind == "deeplabv3p":
        model = shard_space(build_model(ModelConfig(
            name="deeplabv3p", features=(64, 128, 256, 512), width_divisor=16)), 1, 2)
        assert model.space == 2 and model.ConvNormAct_0.Conv_0.halo == (0, 1)
        with pytest.raises(ValueError, match="ROADMAP A6.4"):
            model(torch.zeros(1, 8, 32, 3))  # 8 rows a shard, not a multiple of 16
    else:
        model = build_model(ModelConfig(name="unetpp", features=(8, 16)))
        conv = next(m for m in model.modules() if isinstance(m, Conv) and m.kernel > 1)
        conv.stride = 2
        shard_space(model, 1, 2)
        assert conv.halo == (0, 1)
        with pytest.raises(ValueError, match="ROADMAP A6.4"):
            check_space_rows(24, 2, 1, space_pools(ModelConfig(features=(8, 16, 32))))


def test_space_off_resets_unetpp_and_the_upsampling():
    model = shard_space(build_model(ModelConfig(**MODELS["unetpp_s2d_bilinear"][0])), 1, 2)
    ups = [m for m in model.modules() if isinstance(m, UpBlock)]
    assert model.space == 2 and ups and all(m.space == 2 for m in ups)
    with space_off(model):
        assert model.space == 1 and all(m.space == 1 for m in ups)
        assert all(m.halo == 0 for m in model.modules() if isinstance(m, Conv))
        model.eval()
        assert model(torch.zeros(1, 32, 32, 3)).shape == (1, 32, 32, 6)
    assert model.space == 2 and all(m.space == 2 for m in ups)


# ---- the trainer -----------------------------------------------------------------


def _trainer_argv(tmp_path, workdir, space: int) -> list:
    sets = ["model.name=unetpp", "model.features=[8,16,32]", "model.deep_supervision=True",
            "compression.mode=none", "train.epochs=2", "data.native_gather=False",
            "train.dump_images_per_epoch=0", f"parallel.space_axis_size={space}"]
    argv = ["--config", _tiny_cli_config(tmp_path), "--device", "cpu", "--workdir",
            str(workdir)]
    for s in sets:
        argv += ["--set", s]
    return argv


def test_trainer_shards_unetpp_halves_its_flops_and_restores_unsharded(tmp_path):
    """A tiny U-Net++ (s2d ×2, DetailHead) through ``Trainer`` at (data 1 ×
    space 2): sharded, finite, every rank the same bits, each perf record
    half the unsharded step's FLOPs; an unsharded trainer restores its
    last checkpoint bit for bit."""
    workdir = tmp_path / "run"
    argv = _trainer_argv(tmp_path, workdir, 2)
    outs = run_grid("trainer", (1, 1, 2), str(tmp_path / "w"), {"argv": argv}, {})
    assert all(bool(o["spatial"]) and int(o["epoch"]) == 1 for o in outs)
    assert [list(o["space"]) for o in outs] == [[0, 2], [1, 2]]
    for k in outs[0]:
        if k != "space":
            np.testing.assert_array_equal(outs[1][k], outs[0][k], err_msg=k)
    lines = [json.loads(x) for x in (workdir / "metrics.jsonl").read_text().splitlines()]
    records = [r for r in lines if "epoch" in r and "kind" not in r]
    assert [r["epoch"] for r in records] == [0, 1]
    assert all(np.isfinite(r["loss"]) and 0.0 <= r["val_miou"] <= 1.0 for r in records)
    cfg, _, device, _ = parse_args(_trainer_argv(tmp_path, workdir, 1))
    full = obs_flops.conv_step_flops(cfg, cfg.train.micro_batch_size, cfg.train.sync_period,
                                     channels=3)
    perf = [r for r in lines if r.get("kind") == "perf"]
    assert len(perf) == 2 and full > 0
    assert all(r["flops_per_step"] == full // 2 for r in perf)
    plain = Trainer(cfg, resume=True, device=device)
    try:
        assert not plain.spatial and plain.start_epoch == 2
        sd, opt = gather_canonical(plain.state)
        for k, v in sd.items():
            np.testing.assert_array_equal(v.numpy(), outs[0][f"sd/{k}"], err_msg=k)
        for key in plain.state.opt_state.buffers():
            for k, v in opt[key].items():
                np.testing.assert_array_equal(v.numpy(), outs[0][f"{key}/{k}"], err_msg=k)
    finally:
        plain.close()
