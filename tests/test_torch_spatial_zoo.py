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
  (s2d ×2, full-resolution DetailHead) with bilinear up-sampling;
- the same models at heights the space axis splits unevenly (ROADMAP
  A6.4): ``unetpp_h20`` (10 rows a shard, 2.5 of U-Net++'s unit of 4: the
  5-row level is resharded to 4 and 6 before its pool),
  ``unet_bilinear_h24`` (12 a shard, 1.5 of the U-Net's 8), and, holding
  half a unit a shard so that a rank of the deepest level holds no row,
  ``unetpp_s2d_bilinear_h8`` and ``unet_bilinear_h8``.  These compute in
  float64 (JAX in x64 mode; params, gradients and Adam in float32), as
  ``tests/test_torch_spatial_deeplab.py`` does: in float32 U-Net++'s
  statistics after the second step are chaotic (below), at 20 rows JAX's
  own GSPMD and one-device steps differ by 54× the bound below, so
  float32 could not tell a fault of the uneven layout from rounding.

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

Uneven layouts alone, in the same worlds (``LAYOUTS``): ``halo.reshard``
between layouts with empty ranges moves rows and cotangents bit for bit;
the layout-aware halo (``zeros``, ``-inf``, ``clamp``, across empty
ranks and several shards) equals the whole array padded, with integer
cotangents so that its adjoint is exact; ``layers.upsample`` given the
global rows equals the unsharded resize as the even case does; and
BatchNorm, GroupNorm and a sharded ASPP (its image pool) weigh each rank
by its rows, equal to the unsharded functions in float64 at rtol 1e-12
(float32 parameter gradients at 1e-6).

The trainer: a tiny U-Net++ through ``Trainer`` at space 2 counts half
the unsharded step's FLOPs, and its checkpoint restores into an unsharded
trainer bit for bit.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import jax
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
from ddlpc_tpu_torch.models import layers
from ddlpc_tpu_torch.models.deeplabv3p import ASPP
from ddlpc_tpu_torch.models.layers import Conv, UpBlock, upsample_2x
from ddlpc_tpu_torch.obs import flops as obs_flops
from ddlpc_tpu_torch.parallel.halo import halo_exchange, row_layout
from ddlpc_tpu_torch.train.__main__ import parse_args
from ddlpc_tpu_torch.train.trainer import Trainer
from test_torch_grid_worker import run_grid, start_grid
from test_torch_model import flax_like_variables
from test_torch_spatial import _jax_gspmd, _port_part
from test_torch_train_step import LR, TINY, _tiny_cli_config
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

A, B, STEPS = 2, 2, 2  # micro-batches a step, micro-batch, steps
F32 = dict(compute_dtype="float32", head_dtype="float32")
F64 = dict(compute_dtype="float64", head_dtype="float64")
PP = dict(name="unetpp", features=(8, 16, 32), deep_supervision=True, num_classes=6, **F32)
MODELS = {  # name: (model, tile rows and columns)
    "unetpp": (PP, 24),
    "unetpp_s2d_bilinear": (dict(PP, stem="s2d", stem_factor=2, detail_head=True,
                                 detail_head_kind="s2d", up_sample_mode="bilinear"), 32),
    "unet_bilinear": (dict(TINY, up_sample_mode="bilinear"), 32),
    "unetpp_h20": (dict(PP, **F64), 20),
    "unet_bilinear_h24": (dict(TINY, up_sample_mode="bilinear", **F64), 24),
    "unetpp_s2d_bilinear_h8": (dict(PP, stem="s2d", stem_factor=2, detail_head=True,
                                    detail_head_kind="s2d", up_sample_mode="bilinear", **F64), 8),
    "unet_bilinear_h8": (dict(TINY, up_sample_mode="bilinear", **F64), 8),
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
    rank's keys ``<run>:<key>`` in ``MODELS``' order.  The world starts
    first and runs while JAX's steps are computed."""
    inputs, runs, models = {}, [], {}
    for i, (name, (kw, h)) in enumerate(MODELS.items()):
        images, labels = _batches(h, seed=4 + i)
        variables = flax_like_variables(jbuild_model(JModelConfig(**kw)))
        params0, stats0 = variables["params"], variables.get("batch_stats", {})
        sd, _ = torch_state_from_flax(params0, stats0)
        inputs.update({f"{name}/sd/{k}": v.numpy() for k, v in sd.items()})
        inputs.update({f"{name}/images": images, f"{name}/labels": labels})
        runs.append({"level": "off", "model": _listed(kw), "prefix": f"{name}/"})
        models[name] = (params0, stats0, images, labels, kw)
    world = start_grid("spatial", (1, 1, 2), str(tmp_path_factory.mktemp("zoo")),
                       {"lr": LR, "compression": CODEC, "runs": runs}, inputs)
    def jax_ref(params0, stats0, images, labels, kw):
        if kw["compute_dtype"] != "float64":
            return _jax_gspmd(params0, stats0, images, labels, kw, CODEC, grid=(1, 2))
        with jax.enable_x64(True):  # flax carries the statistics in the compute dtype
            f64 = jax.tree.map(lambda a: np.asarray(a, np.float64), stats0)
            return _jax_gspmd(params0, f64, images, labels, kw, CODEC, grid=(1, 2))

    # One thread a model: JAX traces under the GIL, and compiles and runs
    # outside it (x64 mode is a thread's own setting).
    with ThreadPoolExecutor(len(models)) as pool:
        want = dict(zip(models, pool.map(lambda args: jax_ref(*args), models.values())))
    outs = world.result()
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
        layout_cases, layout_inputs = _layout_inputs(space)
        cases += layout_cases
        inputs.update(layout_inputs)
        outs = run_grid("halo", (1, 1, space), str(tmp_path_factory.mktemp(f"up{space}")),
                        {"cases": cases}, inputs)
        worlds[space] = (inputs, outs)
    return worlds


# Uneven layouts alone: each space's reshards (source, target), halo
# layouts, and global rows of the norm and up-sampling cases (2S − 1 rows:
# every rank holds some; S − 1: the first holds none).
LAYOUTS = {
    2: {"reshard": (((0, 3, 7), (0, 0, 7)), ((0, 0, 7), (0, 5, 7))),
        "halo": ((0, 0, 5), (0, 4, 5))},
    4: {"reshard": (((0, 1, 3, 5, 7), (0, 0, 2, 2, 7)), ((0, 0, 0, 3, 7), (0, 4, 4, 6, 7))),
        "halo": ((0, 1, 1, 4, 5), (0, 0, 2, 2, 5))},
}
HALO_ROWS = (((1, 1), "zeros"), ((0, 1), "-inf"), ((3, 2), "zeros"), ((2, 1), "clamp"))
NORMS = ("batch", "group", "aspp")


def _layout_inputs(space: int) -> tuple:
    """The uneven-layout cases of one world and their inputs."""
    rng = np.random.default_rng(100 + space)
    ints = lambda *shape: rng.integers(-8, 8, size=shape).astype(np.float64)  # noqa: E731
    cases, inputs = [], {}
    for i, (src, dst) in enumerate(LAYOUTS[space]["reshard"]):
        name = f"reshard{i}"
        cases.append({"name": name, "layout": list(src), "dst": list(dst)})
        inputs.update({f"{name}/x": rng.normal(size=(2, src[-1], 3, 2)),
                       f"{name}/w": rng.normal(size=(2, src[-1], 3, 2))})
    for i, lay in enumerate(LAYOUTS[space]["halo"]):
        for (top, bottom), edge in HALO_ROWS:
            name = f"halo{i}_{top}_{bottom}_{edge}"
            blocks = sum(b - a + top + bottom for a, b in zip(lay, lay[1:]) if b > a)
            cases.append({"name": name, "layout": list(lay), "rows": [top, bottom],
                          "edge": edge})
            inputs.update({f"{name}/x": rng.normal(size=(2, lay[-1], 3, 2)),
                           f"{name}/w": ints(2, blocks, 3, 2)})
    for g in (2 * space - 1, space - 1):
        lay = list(row_layout(g, space))
        for norm in NORMS:
            name = f"{norm}{g}"
            extra = {"group": {"groups": 2}, "aspp": {"rates": [1, 2]}}.get(norm, {})
            cases.append({"name": name, "layout": lay, "norm": norm, **extra})
            c, out_c = (4, 4) if norm == "group" else ((3, 4) if norm == "aspp" else (3, 3))
            inputs.update({f"{name}/x": rng.normal(size=(2, c, g, 5)),
                           f"{name}/w": rng.normal(size=(2, out_c, g, 5))})
        for dtype in DTYPES:
            name = f"up{g}_{dtype}"
            cases.append({"name": name, "layout": lay, "up": 2, "dtype": dtype})
            inputs.update({f"{name}/x": rng.normal(size=(2, g, 7, 3)).astype(np.float32),
                           f"{name}/w": rng.normal(size=(2, 2 * g, 14, 3)).astype(np.float32)})
    return cases, inputs


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


def _cat(outs, name: str, key: str, axis: int = 1) -> np.ndarray:
    return np.concatenate([o[f"{name}/{key}"] for o in outs], axis=axis)


@pytest.mark.parametrize("space", [2, 4])
def test_reshard_moves_rows_and_their_cotangents_exactly(space, upsampled):
    """Each rank ends with the target layout's rows of the array, and the
    backward hands each rank the cotangent of the rows it held, bit for
    bit, through empty ranges on either side."""
    inputs, outs = upsampled[space]
    for i, (src, dst) in enumerate(LAYOUTS[space]["reshard"]):
        name = f"reshard{i}"
        x, w = inputs[f"{name}/x"], inputs[f"{name}/w"]
        for s, out in enumerate(outs):
            np.testing.assert_array_equal(out[f"{name}/y"], x[:, dst[s]:dst[s + 1]])
            np.testing.assert_array_equal(out[f"{name}/gx"], w[:, src[s]:src[s + 1]])


def _halo_reference(x: np.ndarray, lay: tuple, top: int, bottom: int, edge: str):
    """Each non-empty rank's rows padded as the whole array is, and the
    map from each of its rows to a global row (None: the fill)."""
    n = x.shape[1]
    fill = -np.inf if edge == "-inf" else 0.0
    blocks, index = [], []
    for a, b in zip(lay, lay[1:]):
        if a == b:
            continue
        rows = list(range(a - top, b + bottom))
        if edge == "clamp":
            rows = [min(max(r, 0), n - 1) for r in rows]
        else:
            rows = [r if 0 <= r < n else None for r in rows]
        blocks.append(np.stack([x[:, r] if r is not None else np.full_like(x[:, 0], fill)
                                for r in rows], axis=1))
        index += rows
    return np.concatenate(blocks, axis=1), index


@pytest.mark.parametrize("space", [2, 4])
@pytest.mark.parametrize("rows,edge", HALO_ROWS, ids=[f"{r[0]}_{r[1]}_{e}" for r, e in HALO_ROWS])
def test_layout_halo_equals_the_padded_array_and_its_adjoint(space, rows, edge, upsampled):
    """Each halo row is the whole array's row, past empty ranks and across
    several shards, the fill or the repeated edge row past the global
    edges; an empty rank takes none.  The cotangents are integers, so the
    adjoint (each halo row's back to its owner, a repeated edge row's
    summed) is exact."""
    inputs, outs = upsampled[space]
    top, bottom = rows
    for i, lay in enumerate(LAYOUTS[space]["halo"]):
        name = f"halo{i}_{top}_{bottom}_{edge}"
        x, w = inputs[f"{name}/x"], inputs[f"{name}/w"]
        want_y, index = _halo_reference(x, lay, top, bottom, edge)
        np.testing.assert_array_equal(_cat(outs, name, "y"), want_y, err_msg=name)
        want_g = np.zeros_like(x)
        for j, r in enumerate(index):
            if r is not None:
                want_g[:, r] += w[:, j]
        np.testing.assert_array_equal(_cat(outs, name, "gx"), want_g, err_msg=name)


def _norm_reference(name: str, norm: str, x: np.ndarray, w: np.ndarray) -> dict:
    xt = torch.from_numpy(x).requires_grad_(True)
    out = {}
    if norm == "aspp":
        mod = ASPP(x.shape[1], 4, (1, 2), torch.float64, norm_groups=2,
                   generator=torch.Generator().manual_seed(3))
        y, params = mod(xt), list(mod.parameters())
    else:
        c = x.shape[1]
        params = [torch.linspace(0.5, 1.5, c, dtype=torch.float64).requires_grad_(True),
                  torch.linspace(-0.2, 0.3, c, dtype=torch.float64).requires_grad_(True)]
        if norm == "batch":
            rm, rv = torch.zeros(c, dtype=torch.float64), torch.ones(c, dtype=torch.float64)
            y = layers.batch_norm(xt, *params, rm, rv, True)
            out.update(mean=rm.numpy(), var=rv.numpy())
        else:
            y = layers.group_norm(xt, 2, *params)
    y.backward(torch.from_numpy(w))
    out.update(y=y.detach().numpy(), gx=xt.grad.numpy())
    out.update({f"gp{i}": p.grad.numpy() for i, p in enumerate(params)})
    return out


@pytest.mark.parametrize("space", [2, 4])
@pytest.mark.parametrize("norm", NORMS)
def test_count_weighted_norms_and_image_pool_equal_the_unsharded(space, norm, upsampled):
    """BatchNorm over the space group, GroupNorm and a sharded ASPP (dilated
    halos, BatchNorm and the image pool) on rows split unevenly, with an
    empty rank at S − 1 rows: the statistics are each rank's sums over
    the group's elements, so output, gradients, parameter gradients and
    running statistics equal the unsharded functions' at 1e-12 (the
    ASPP's float32 parameter gradients, whose shares a rank rounds to
    float32 before the group sums them, at 1e-6)."""
    inputs, outs = upsampled[space]
    for g in (2 * space - 1, space - 1):
        name = f"{norm}{g}"
        want = _norm_reference(name, norm, inputs[f"{name}/x"], inputs[f"{name}/w"])
        got = {"y": _cat(outs, name, "y", 2), "gx": _cat(outs, name, "gx", 2)}
        got.update({k: outs[0][f"{name}/{k}"] for k in want if k not in got})
        for out in outs[1:]:
            for k in want:
                if k not in ("y", "gx"):
                    np.testing.assert_array_equal(out[f"{name}/{k}"], got[k], err_msg=k)
        for k, v in want.items():
            tol = 1e-12 if v.dtype == np.float64 else 1e-6
            np.testing.assert_allclose(got[k], v, rtol=tol, atol=tol, err_msg=f"{name} {k}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("space", [2, 4])
def test_uneven_upsample_equals_the_unsharded(space, dtype, upsampled):
    """``layers.upsample`` given the global rows of an uneven layout (and
    one with an empty rank): its clamped halo comes from the ranks that
    hold the rows and its output is resharded to the layout of twice the
    rows.  As the even case: in bf16 the forward bit for bit, everywhere
    within four roundings of the magnitude of the terms summed."""
    inputs, outs = upsampled[space]
    for g in (2 * space - 1, space - 1):
        name = f"up{g}_{dtype}"
        x, w = inputs[f"{name}/x"], inputs[f"{name}/w"]
        want_y, want_g = _upsampled(x, w, dtype)
        terms_y, terms_g = _upsampled(np.abs(x), np.abs(w), "float32")
        got_y, got_g = _cat(outs, name, "y"), _cat(outs, name, "gx")
        bound = 4 * ROUNDING[dtype]
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got_y, want_y)
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
    """U-Net++ (8, 16, 32) pools twice (unit 4), the U-Net of the same
    features three times (unit 8).  Since uneven shards (ROADMAP A6.4) a
    sharded model takes every height its unsharded self takes, whatever a
    shard holds: both take 24 rows over 2 (12 a shard, 1.5 of the U-Net's
    unit); 20 (10 a shard) is a height U-Net++ takes and the U-Net refuses,
    sharded or not."""
    pp = ModelConfig(name="unetpp", features=(8, 16, 32))
    unet = ModelConfig(features=(8, 16, 32), bottleneck_features=32)
    assert (space_pools(pp), space_pools(unet)) == (2, 3)
    assert MODELS["unetpp"][1] == 24  # the world above trains U-Net++ at this height
    for cfg in (pp, unet):
        check_space_rows(24, 2, 1, space_pools(cfg))
    check_space_rows(20, 2, 1, space_pools(pp))
    with pytest.raises(ValueError, match=r"1·2\*\*3 = 8"):
        check_space_rows(20, 2, 1, space_pools(unet))
    sharded = shard_space(build_model(unet), 1, 2)
    with pytest.raises(ValueError, match=r"1·2\*\*3 = 8"):
        sharded(torch.zeros(1, 10, 24, 3))


@pytest.mark.parametrize("kind", ["deeplabv3p", "strided_conv"])
def test_shard_space_refuses_deeplab_and_strided_convs_naming_a6_3(kind):
    """Both were refused until ROADMAP A6.3 ported them: DeepLabV3+ now
    shards, and a 3×3 stride-2 conv takes the one row from below that
    flax's (0, 1) pad reads.  Since A6.4 a shard may hold any rows (16
    over 2 is 8 a shard, half DeepLabV3+'s output stride; 24 over 2 is 12,
    1.5 of the U-Net's unit of 8); what stays refused is a height the
    unsharded model refuses, before any exchange."""
    if kind == "deeplabv3p":
        model = shard_space(build_model(ModelConfig(
            name="deeplabv3p", features=(64, 128, 256, 512), width_divisor=16)), 1, 2)
        assert model.space == 2 and model.ConvNormAct_0.Conv_0.halo == (0, 1)
        check_space_rows(16, 2, 1, space_pools(ModelConfig(name="deeplabv3p")))
        with pytest.raises(ValueError, match=r"1·2\*\*4 = 16"):
            model(torch.zeros(1, 12, 32, 3))  # 24 rows, not a multiple of 16
    else:
        model = build_model(ModelConfig(name="unetpp", features=(8, 16)))
        conv = next(m for m in model.modules() if isinstance(m, Conv) and m.kernel > 1)
        conv.stride = 2
        shard_space(model, 1, 2)
        assert conv.halo == (0, 1)
        unet = ModelConfig(features=(8, 16, 32))
        check_space_rows(24, 2, 1, space_pools(unet))
        with pytest.raises(ValueError, match=r"1·2\*\*3 = 8"):
            check_space_rows(20, 2, 1, space_pools(unet))


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
