"""DeepLabV3+ under the port's space axis, against the JAX package's GSPMD
step (``make_train_step_gspmd``), and the general halo it needs.

Tiny DeepLabV3+s (features (64, 128, 256, 512) at ``width_divisor`` 8, as
``tests/test_torch_models_zoo.py``) train two optimizer steps of 2
micro-batches of 4 tiles (no codec, as the committed Potsdam config runs)
on a (data 1 × space S) grid of gloo processes
(``tests/test_torch_grid_worker.py``), every rank from the same seeded
weights in the flax layout (carried over by ``convert.py``) and taking
its rows of the same numpy batches, whose void labels lie in the top
shard only; JAX runs ``make_train_step_gspmd`` on a (1, S) slice of the
8-device CPU mesh:

- ``os16``: output stride 16 with the committed config's rates (6, 12,
  18) on 512 × 32 tiles, at space 2 and 4: the ASPP sees 16 and 8 rows a
  shard, so the rate-18 conv's halo spans two and three shards, and past
  the global edges it is zeros;
- ``os8``: output stride 8 with rates (2, 4, 6) on 64 × 64 at space 4
  (×2 then ×4 resizes);
- ``group``: ``norm="group"`` at output stride 16 on 64 × 64 at space 2;
- each of the three at two heights the space axis splits unevenly
  (ROADMAP A6.4), 32 columns: ``os16_h80`` (20 rows a shard at space 4,
  1.25 output strides), ``os8_h40`` (10 a shard at space 4),
  ``group_h48`` (24 a shard at space 2), and half an output stride a
  shard, so that ranks of the deepest levels hold no row:
  ``os16_h32`` and ``os8_h16`` at space 4, ``group_h16`` at space 2.

They compute in float64 (JAX in x64 mode; params, gradients and Adam in
float32 on both sides).  In float32 the tiny DeepLabV3+'s second step is
chaotic in JAX alone: its one-device and GSPMD steps on these batches
disagree beyond the tolerances below, so float32 could not tell a fault
of the sharding from rounding; in float64 they agree.  Tolerances,
those of ``tests/test_torch_spatial.py``: the losses at rtol 1e-4, the
BatchNorm statistics at rtol 1e-4 / atol 1e-6, the params at rtol 1e-4 /
atol 1e-6 but for at most 2 % of them, each within ``2·lr`` a step;
every rank holds the same state bit for bit.  The params are held so
after the first step against JAX's GSPMD step, and after the second
against the port's own unsharded step; after the second they stay within
``2·lr`` a step of JAX's.  (After the second step the port's unsharded
step and the sharded one are equally far from JAX's: the first step's
params differ from JAX's in float32's last bits, which the second step's
Adam update magnifies where a gradient nearly vanishes.)

The halo alone, at space 2 and 4, against the unsharded array padded as
'SAME' pads it: one-sided ``(0, 1)`` (a stride-2 window), counts larger
than a shard's rows (multi-hop), the ``-inf`` fill: the rows bit for bit
(a copy moves them), the adjoint within four roundings of the magnitude
of the terms summed (a halo row's cotangent is added into its owner's row
after the owner's own, where the float64 reference sums in one pass).
The sharded 3×3/2 max pool on post-ReLU input full of ties, and the ×4
bilinear resize, as ``tests/test_torch_spatial_zoo.py`` tests the ×2:
bf16 forwards bit for bit, gradients within four roundings and, in bf16,
bit for bit off the rows next to a shard edge.

The trainer: a tiny DeepLabV3+ through ``Trainer`` at space 2 counts half
the unsharded step's FLOPs, and its checkpoint restores into an unsharded
trainer bit for bit.
"""

import json
import math
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddlpc_tpu.config import ModelConfig as JModelConfig
from ddlpc_tpu.data import datasets as jdatasets
from ddlpc_tpu.models import build_model as jbuild_model
from ddlpc_tpu.config import CompressionConfig as JCompression
from ddlpc_tpu.config import ParallelConfig as JParallel
from ddlpc_tpu.parallel import train_step as jts
from ddlpc_tpu.parallel.mesh import make_mesh
from ddlpc_tpu_torch.config import CompressionConfig, ModelConfig, TrainConfig
from ddlpc_tpu_torch.convert import flax_from_torch, gather_canonical, torch_state_from_flax
from ddlpc_tpu_torch.models import (
    build_model,
    check_space_rows,
    shard_space,
    space_off,
    space_pools,
    space_stem_factor,
)
from ddlpc_tpu_torch.models.deeplabv3p import ASPP, DeepLabV3Plus
from ddlpc_tpu_torch.models.layers import Conv, max_pool_same, upsample
from ddlpc_tpu_torch.obs import flops as obs_flops
from ddlpc_tpu_torch.parallel.halo import _hop_counts, halo_exchange
from ddlpc_tpu_torch.parallel.train_step import create_train_state, make_train_step
from jax.sharding import NamedSharding, PartitionSpec as P

from ddlpc_tpu_torch.train.__main__ import parse_args
from ddlpc_tpu_torch.train.optim import build_optimizer
from ddlpc_tpu_torch.train.trainer import Trainer
from test_torch_grid_worker import run_grid, start_grid
from test_torch_model import flax_like_variables
from test_torch_spatial import _port_part
from test_torch_train_step import LR, _flat, _tiny_cli_config
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

A, B, STEPS = 2, 4, 2  # micro-batches a step, global micro-batch, steps
F64 = dict(compute_dtype="float64", head_dtype="float64")
DL = dict(name="deeplabv3p", features=(64, 128, 256, 512), width_divisor=8, num_classes=6,
          **F64)
MODELS = {  # name: (model, tile rows and columns)
    "os16": (dict(DL, output_stride=16, aspp_rates=(6, 12, 18)), (512, 32)),
    "os8": (dict(DL, output_stride=8, aspp_rates=(2, 4, 6)), (64, 64)),
    "group": (dict(DL, norm="group"), (64, 64)),
    "os16_h80": (dict(DL, output_stride=16, aspp_rates=(6, 12, 18)), (80, 32)),
    "os16_h32": (dict(DL, output_stride=16, aspp_rates=(6, 12, 18)), (32, 32)),
    "os8_h40": (dict(DL, output_stride=8, aspp_rates=(2, 4, 6)), (40, 32)),
    "os8_h16": (dict(DL, output_stride=8, aspp_rates=(2, 4, 6)), (16, 32)),
    "group_h48": (dict(DL, norm="group"), (48, 32)),
    "group_h16": (dict(DL, norm="group"), (16, 32)),
}
WORLDS = {  # space: the models trained there
    2: ("os16", "group", "group_h48", "group_h16"),
    4: ("os16", "os8", "os16_h80", "os16_h32", "os8_h40", "os8_h16"),
}
RUNS = [(space, name) for space, names in WORLDS.items() for name in names]
CODEC = {"mode": "none"}

# The halo alone: (name, local rows, (top, bottom), edge).  5 rows a shard
# and counts up to 12 reach three shards away.
HALOS = (("one_sided", 6, (0, 1), "zeros"), ("one_sided_inf", 6, (0, 1), "-inf"),
         ("multi_hop", 5, (12, 7), "zeros"), ("multi_hop_inf", 5, (6, 11), "-inf"))
POOL_ROWS = (4, 6)  # local rows of the pool cases (even: a stride-2 window)
RESIZE_SHAPES = ((5, 7), (8, 40))  # rows first and columns first, as the ×2 test
DTYPES = ("float32", "bfloat16")
ROUNDING = {"float32": 2.0**-24, "bfloat16": 2.0**-8}  # a rounding's relative error


def _batches(h: int, w: int, seed: int):
    ds = jdatasets.SyntheticTiles(num_tiles=STEPS * A * B, image_size=(h, w), seed=seed,
                                  num_classes=6)
    labels = ds.labels.copy()
    labels[:, :5, :7] = -1  # void pixels, all in the top space shard
    return ds.images.reshape(STEPS, A, B, h, w, 3), labels.reshape(STEPS, A, B, h, w)


def _listed(kw: dict) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v for k, v in kw.items()}


def _jax_gspmd(params0, stats0, images, labels, model_kw, space: int) -> dict:
    """JAX's ``make_train_step_gspmd`` on a (1, ``space``) slice of the CPU
    mesh in x64 mode: the losses, the final statistics, and the params
    after every step."""
    with jax.enable_x64(True):
        jmodel = jbuild_model(JModelConfig(**model_kw))
        tx = optax.adam(LR)
        mesh = make_mesh(JParallel(data_axis_size=1, space_axis_size=space),
                         jax.devices()[:space])
        params = jax.tree.map(jnp.asarray, params0)
        # flax carries the statistics in the compute dtype.
        stats = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), stats0)
        state = jts.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                               opt_state=tx.init(params))
        state = jax.device_put(state, NamedSharding(mesh, P()))
        step = jts.make_train_step_gspmd(jmodel, tx, mesh, JCompression(**CODEC),
                                         donate_state=False)
        sh = NamedSharding(mesh, P(None, "data", "space"))
        losses, params = [], []
        for x, y in zip(images, labels):
            state, m = step(state, jax.device_put(x, sh), jax.device_put(y, sh))
            losses.append(float(m["loss"]))
            params.append(_flat(jax.device_get(state.params)))
        state = jax.device_get(state)
    return {"params": params, "batch_stats": _flat(state.batch_stats), "losses": losses}


def _port_unsharded(sd: dict, images, labels, model_kw) -> dict:
    """The port's one-process step over the whole tiles: the final params."""
    model = build_model(ModelConfig(**model_kw))
    model.load_state_dict(sd)
    tx = build_optimizer(TrainConfig(learning_rate=LR), total_steps=len(images))
    state = create_train_state(model, tx)
    step = make_train_step(tx, CompressionConfig(**CODEC))
    for x, y in zip(images, labels):
        step(state, torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)))
    return _flat(flax_from_torch(model.state_dict())[0])


def _halo_inputs(space: int, rng) -> tuple:
    """The halo-alone cases of one world and their inputs."""
    cases, inputs = [], {}
    for name, h, (top, bottom), edge in HALOS:
        cases.append({"name": name, "rows": [top, bottom], "edge": edge})
        inputs[f"{name}/x"] = rng.normal(size=(2, space * h, 3, 2)).astype(np.float32)
        inputs[f"{name}/w"] = rng.normal(size=(2, space * (h + top + bottom), 3, 2)).astype(
            np.float32)
    for h in POOL_ROWS:
        # Post-ReLU input of small integers: ties in most windows.
        x = np.maximum(rng.integers(-2, 3, size=(2, space * h, 6, 3)), 0).astype(np.float32)
        w = rng.normal(size=(2, space * h // 2, 3, 3)).astype(np.float32)
        for dtype in DTYPES:
            name = f"pool{h}_{dtype}"
            cases.append({"name": name, "pool": True, "dtype": dtype})
            inputs.update({f"{name}/x": x, f"{name}/w": w})
    for h, w_ in RESIZE_SHAPES:
        x = rng.normal(size=(2, space * h, w_, 3)).astype(np.float32)
        g = rng.normal(size=(2, 4 * space * h, 4 * w_, 3)).astype(np.float32)
        for dtype in DTYPES:
            name = f"x4_{h}x{w_}_{dtype}"
            cases.append({"name": name, "upsample": True, "factor": 4, "dtype": dtype})
            inputs.update({f"{name}/x": x, f"{name}/w": g})
    return cases, inputs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """One gloo world a space size, running its halo cases and training
    its models: ``{space: (inputs, references by model, [rank outputs])}``,
    a rank's training keys ``<run>:<key>`` in ``WORLDS[space]``'s order; a
    model's references are JAX's GSPMD outputs and, under ``"port"``, the
    port's unsharded params.  Both worlds start first and run while the
    references are computed."""
    started = {}
    for space, names in WORLDS.items():
        cases, inputs = _halo_inputs(space, np.random.default_rng(space))
        runs, models = [], {}
        for i, name in enumerate(names):
            kw, (h, w) = MODELS[name]
            images, labels = _batches(h, w, seed=7 + i)
            variables = flax_like_variables(jbuild_model(JModelConfig(**kw)))
            params0, stats0 = variables["params"], variables.get("batch_stats", {})
            sd, _ = torch_state_from_flax(params0, stats0)
            inputs.update({f"{name}/sd/{k}": v.numpy() for k, v in sd.items()})
            inputs.update({f"{name}/images": images, f"{name}/labels": labels})
            runs.append({"level": "off", "model": _listed(kw), "prefix": f"{name}/"})
            models[name] = (params0, stats0, sd, images, labels, kw)
        world = start_grid("spatial", (1, 1, space), str(tmp_path_factory.mktemp(f"dl{space}")),
                           {"lr": LR, "compression": CODEC, "runs": runs, "cases": cases,
                            "every_step": True}, inputs, deadline_s=300.0)
        started[space] = (inputs, models, world)
    # JAX's steps on threads of their own (it traces under the GIL, and
    # compiles and runs outside it; x64 mode is a thread's own setting),
    # the port's unsharded steps meanwhile on this one.
    with ThreadPoolExecutor(4) as pool:
        jax_refs = {
            (space, name): pool.submit(_jax_gspmd, params0, stats0, images, labels, kw, space)
            for space, (_, models, _) in started.items()
            for name, (params0, stats0, _, images, labels, kw) in models.items()
        }
        port_refs = {
            (space, name): _port_unsharded(sd, images, labels, kw)
            for space, (_, models, _) in started.items()
            for name, (_, _, sd, images, labels, kw) in models.items()
        }
        out = {}
        for space, (inputs, models, world) in started.items():
            want = {name: dict(jax_refs[space, name].result(), port=port_refs[space, name])
                    for name in models}
            out[space] = (inputs, want, world.result())
    return out


def _run(worlds, space: int, name: str):
    inputs, want, outs = worlds[space]
    return want[name], WORLDS[space].index(name), outs


@pytest.mark.parametrize("space,name", RUNS, ids=[f"space{s}_{n}" for s, n in RUNS])
def test_losses_and_batch_stats_match_jax_gspmd(space, name, worlds):
    jout, run, outs = _run(worlds, space, name)
    for r, out in enumerate(outs):
        np.testing.assert_allclose([float(out[f"{run}:loss{s}"]) for s in range(STEPS)],
                                   jout["losses"], rtol=1e-4, err_msg=f"rank {r}")
        got = _port_part(out, "batch_stats", run)
        assert got.keys() == jout["batch_stats"].keys()
        for k, want in jout["batch_stats"].items():
            np.testing.assert_allclose(got[k], want, rtol=1e-4, atol=1e-6, err_msg=k)


def _params_agree(got: dict, want: dict, steps: int) -> None:
    assert got.keys() == want.keys()
    total = off = 0
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        off += int((diff > 1e-4 * np.abs(w) + 1e-6).sum())
        total += w.size
        assert diff.max() <= steps * 2 * LR, (k, diff.max())
    assert off <= 2e-2 * total, (off, total)


@pytest.mark.parametrize("space,name", RUNS, ids=[f"space{s}_{n}" for s, n in RUNS])
def test_params_match_jax_gspmd_and_every_rank_agrees(space, name, worlds):
    """After the first step against JAX's GSPMD step; after the second
    against the port's unsharded step, and within ``2·lr`` a step of
    JAX's."""
    jout, run, outs = _run(worlds, space, name)
    _params_agree(_port_part(outs[0], "params", f"{run}:after0"), jout["params"][0], 1)
    got = _port_part(outs[0], "params", run)
    _params_agree(got, jout["port"], STEPS)
    for k, want in jout["params"][-1].items():
        assert np.abs(got[k] - want).max() <= STEPS * 2 * LR, k
    for out in outs[1:]:
        for k in outs[0]:
            if k.startswith(f"{run}:"):
                np.testing.assert_array_equal(out[k], outs[0][k], err_msg=k)


def test_the_first_bits_to_differ_from_jax_are_the_stem_batch_norms_sums():
    """ROADMAP C20, the first tensor of step one whose bits differ from
    JAX's, unsharded, in this file's float64 setting (``os16``, the first
    micro-batch of its first step).  The stem conv's output is bit for bit
    JAX's; the next op, the stem's BatchNorm, differs, because its batch
    sum over 4 × 256 × 16 rows in float64 is summed in another order than
    XLA's: each side's sum is within the float64 bound of a sum of its
    terms (``n·ε·Σ|x|`` of the exact sum) and they differ in some channels.
    The float32 loss adds a second difference of its own: on the same
    float64 logits the port's per-pixel NLL (``exp``, ``log`` and the
    class sum in float32) is within four float32 ulps of its largest term
    of JAX's.  Any new
    difference earlier in the chain fails the first assertion."""
    from ddlpc_tpu.ops.losses import nll_correct_valid as jnll
    from ddlpc_tpu_torch.ops.losses import nll_correct_valid

    kw, (h, w) = MODELS["os16"]
    images, labels = _batches(h, w, seed=7)
    x, y = images[0, 0], labels[0, 0]
    jmodel = jbuild_model(JModelConfig(**kw))
    variables = flax_like_variables(jmodel)
    with jax.enable_x64(True):
        stats = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables["batch_stats"])
        (jlogits, state) = jmodel.apply(
            {"params": variables["params"], "batch_stats": stats}, x, train=True,
            mutable=["batch_stats", "intermediates"], capture_intermediates=True)
        inter = jax.device_get(state["intermediates"])
        jconv = np.asarray(inter["ConvNormAct_0"]["Conv_0"]["__call__"][0])
        jbn = np.asarray(inter["ConvNormAct_0"]["Norm_0"]["BatchNorm_0"]["__call__"][0])
        jsum = np.asarray(jnp.sum(jnp.asarray(jconv), axis=(0, 1, 2)))
        jlogits = np.asarray(jlogits)
        jn = np.asarray(jnll(jnp.asarray(jlogits), y, ignore_index=-1)[0])
    model = build_model(ModelConfig(**kw))
    model.load_state_dict(torch_state_from_flax(variables["params"], variables["batch_stats"])[0])
    model.train()
    seen = {}
    stem = model.ConvNormAct_0
    stem.Conv_0.register_forward_hook(lambda m, i, o: seen.update(conv=o.detach()))
    stem.Norm_0.register_forward_hook(lambda m, i, o: seen.update(bn=o.detach()))
    model(torch.from_numpy(x))
    conv = seen["conv"].permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(conv, jconv)
    assert (seen["bn"].permute(0, 2, 3, 1).numpy() != jbn).any()
    psum = seen["conv"].sum(dim=(0, 2, 3)).numpy()
    terms = conv.reshape(-1, conv.shape[-1])
    exact = np.array([math.fsum(terms[:, c]) for c in range(terms.shape[1])])
    bound = terms.shape[0] * np.finfo(np.float64).eps * np.abs(terms).sum(axis=0)
    assert (np.abs(jsum - exact) <= bound).all() and (np.abs(psum - exact) <= bound).all()
    assert (psum != jsum).any()
    pn = nll_correct_valid(torch.from_numpy(jlogits), torch.from_numpy(y.astype(np.int64)),
                           -1)[0].numpy()
    # nll = lse − m − (l − m): a rounding of lse or of the row max m is an
    # ulp of the larger of them, not of the difference.
    scale = np.float32(np.abs(jlogits).max(axis=-1)) + np.abs(jn)
    assert (np.abs(pn - jn) <= 4 * np.spacing(scale)).all()


@pytest.mark.parametrize("space", list(WORLDS))
def test_the_rate_18_halo_spans_more_than_a_shard(space):
    """At 512 rows and output stride 16 the ASPP sees 512 / 16 / space rows
    a shard: the rate-18 conv's 18 rows a side come from two shards at
    space 2 (the second past the global edge) and three at space 4."""
    rows = MODELS["os16"][1][0] // 16 // space
    assert rows == {2: 16, 4: 8}[space]
    assert _hop_counts(rows, 18) == {2: [16, 2], 4: [8, 8, 2]}[space]
    model = shard_space(build_model(ModelConfig(**MODELS["os16"][0])), 1, space)
    aspp = [m.Conv_0.halo for m in model.ASPP_0.children() if m.Conv_0.dilation > 1]
    assert aspp == [(6, 6), (12, 12), (18, 18)]
    assert model.ConvNormAct_0.Conv_0.halo == (0, 1)  # the stride-2 stem
    assert model.stage1_block0.Conv_2.halo == (0, 0)  # the strided 1×1 shortcut


# ---- the halo alone ----------------------------------------------------------------


def _padded(x: np.ndarray, top: int, bottom: int, edge: str) -> np.ndarray:
    fill = -np.inf if edge == "-inf" else 0.0
    return np.pad(x, ((0, 0), (top, bottom), (0, 0), (0, 0)), constant_values=fill)


@pytest.mark.parametrize("space", list(WORLDS))
@pytest.mark.parametrize("case", HALOS, ids=[c[0] for c in HALOS])
def test_halo_equals_the_padded_array_and_its_adjoint(case, space, worlds):
    """Each shard's rows are its window of the whole array padded with the
    fill, bit for bit; the gradient is that window's adjoint."""
    inputs, _, outs = worlds[space]
    name, h, (top, bottom), edge = case
    x, w = inputs[f"{name}/x"], inputs[f"{name}/w"]
    padded = _padded(x, top, bottom, edge)
    n = h + top + bottom
    want_g = np.zeros(x.shape, np.float64)
    terms = np.zeros(x.shape, np.float64)
    for s, out in enumerate(outs):
        np.testing.assert_array_equal(out[f"{name}/y"], padded[:, s * h : s * h + n],
                                      err_msg=f"shard {s}")
        ws = w[:, s * n : (s + 1) * n].astype(np.float64)
        for i in range(n):
            row = s * h + i - top
            if 0 <= row < space * h:
                want_g[:, row] += ws[:, i]
                terms[:, row] += np.abs(ws[:, i])
    got_g = np.concatenate([o[f"{name}/gx"] for o in outs], axis=1)
    assert (np.abs(got_g - want_g) <= 4 * ROUNDING["float32"] * terms).all()


def _reference(fn, x: np.ndarray, w: np.ndarray, dtype: str):
    """``fn`` of the whole NHWC ``x`` in ``dtype`` and its gradient against
    ``w``, as fp32 NHWC."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(getattr(torch, dtype)).requires_grad_(True)
    y = fn(xt)
    y.backward(torch.from_numpy(w).permute(0, 3, 1, 2).to(y.dtype))
    return y.detach().permute(0, 2, 3, 1).float().numpy(), xt.grad.permute(0, 2, 3, 1).float().numpy()


def _edge_rows(space: int, h: int) -> np.ndarray:
    edge = np.zeros(space * h, bool)  # the rows next to a shard edge
    edge[::h] = edge[h - 1 :: h] = True
    return edge


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h", POOL_ROWS)
@pytest.mark.parametrize("space", list(WORLDS))
def test_sharded_max_pool_equals_the_unsharded(space, h, dtype, worlds):
    """The 3×3/2 'SAME' pool on post-ReLU ties: forward bit for bit (the
    ``-inf`` row past the global bottom never wins, as in the unsharded
    pad); each tie's gradient goes where the unsharded pool sends it,
    within four roundings of the cotangents summed there, bit for bit off
    the rows next to a shard edge."""
    inputs, _, outs = worlds[space]
    name = f"pool{h}_{dtype}"
    x, w = inputs[f"{name}/x"], inputs[f"{name}/w"]
    pool = lambda t: max_pool_same(t, 3, 2)  # noqa: E731
    want_y, want_g = _reference(pool, x, w, dtype)
    _, terms = _reference(pool, x, np.abs(w), "float32")
    got_y = np.concatenate([o[f"{name}/y"] for o in outs], axis=1)
    got_g = np.concatenate([o[f"{name}/gx"] for o in outs], axis=1)
    np.testing.assert_array_equal(got_y, want_y)
    edge = _edge_rows(space, h)
    np.testing.assert_array_equal(got_g[:, ~edge], want_g[:, ~edge])
    assert (np.abs(got_g - want_g) <= 4 * ROUNDING[dtype] * terms).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", RESIZE_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("space", list(WORLDS))
def test_clamped_halo_x4_resize_equals_the_unsharded(space, shape, dtype, worlds):
    """As ``tests/test_torch_spatial_zoo.py`` holds the ×2: in bf16 the
    forward bit for bit and the gradient off the rows next to a shard
    edge; everywhere within four roundings of the magnitude of the terms
    summed."""
    inputs, _, outs = worlds[space]
    h, w_ = shape
    name = f"x4_{h}x{w_}_{dtype}"
    x, w = inputs[f"{name}/x"], inputs[f"{name}/w"]
    x4 = lambda t: upsample(t, 4)  # noqa: E731
    want_y, want_g = _reference(x4, x, w, dtype)
    terms_y, terms_g = _reference(x4, np.abs(x), np.abs(w), "float32")
    got_y = np.concatenate([o[f"{name}/y"] for o in outs], axis=1)
    got_g = np.concatenate([o[f"{name}/gx"] for o in outs], axis=1)
    edge = _edge_rows(space, h)
    bound = 4 * ROUNDING[dtype]
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got_y, want_y)
        np.testing.assert_array_equal(got_g[:, ~edge], want_g[:, ~edge])
    assert (np.abs(got_y - want_y) <= bound * terms_y).all()
    assert (np.abs(got_g - want_g) <= bound * terms_g).all()


@pytest.mark.parametrize("edge", ["zeros", "-inf"])
def test_one_shard_pads_with_the_fill_on_each_side(edge):
    """Without a space group a multi-hop halo is the padding itself."""
    x = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    y = halo_exchange(x, (2, 9), edge=edge, multi_hop=True)
    np.testing.assert_array_equal(y.numpy(), np.pad(
        x.numpy(), ((0, 0), (0, 0), (2, 9), (0, 0)),
        constant_values=-np.inf if edge == "-inf" else 0.0))


def test_a_count_past_the_local_rows_needs_multi_hop_and_no_clamp():
    x = torch.zeros(1, 2, 4, 3)
    for kw in ({}, {"edge": "clamp", "multi_hop": True}):
        with pytest.raises(ValueError, match="smaller than halo"):
            halo_exchange(x, (0, 5), **kw)
    with pytest.raises(ValueError, match="unknown halo edge"):
        halo_exchange(x, 1, edge="reflect")


# ---- the row unit, the refusals and space_off ----------------------------------------


def test_deeplab_row_unit_is_its_output_stride():
    """DeepLabV3+ halves H ``log2(output_stride)`` times (stem conv, pool,
    stages) and has no space-to-depth stem: the height must be a multiple
    of the output stride, as unsharded; since uneven shards (ROADMAP A6.4)
    a shard may hold any part of it (48 over 2: 24 rows a shard, 1.5
    output strides)."""
    for stride, pools in ((16, 4), (8, 3)):
        cfg = ModelConfig(name="deeplabv3p", output_stride=stride, stem="s2d", stem_factor=4)
        assert (space_pools(cfg), space_stem_factor(cfg)) == (pools, 1)
    check_space_rows(512, 2, 1, 4)
    check_space_rows(48, 2, 1, 4)
    with pytest.raises(ValueError, match=r"1·2\*\*4 = 16"):
        check_space_rows(40, 2, 1, 4)
    model = shard_space(build_model(ModelConfig(**MODELS["os16"][0])), 1, 2)
    with pytest.raises(ValueError, match=r"1·2\*\*4 = 16"):
        model(torch.zeros(1, 20, 32, 3))


def test_a_strided_conv_on_odd_local_rows_raises():
    conv = Conv(2, 3, 3, torch.float32, generator=torch.Generator().manual_seed(0), stride=2)
    conv.halo = (0, 1)
    with pytest.raises(ValueError, match="divide by the stride"):
        conv(torch.zeros(1, 2, 5, 4))
    with pytest.raises(ValueError, match="divide by the stride"):
        max_pool_same(torch.zeros(1, 2, 5, 4), 3, 2, space=2)


def test_space_off_resets_deeplab_and_its_aspp():
    model = shard_space(build_model(ModelConfig(**MODELS["os8"][0])), 1, 2)
    spaced = [m for m in model.modules() if isinstance(m, (DeepLabV3Plus, ASPP))]
    assert len(spaced) == 2 and all(m.space == 2 for m in spaced)
    with space_off(model):
        assert all(m.space == 1 for m in spaced)
        assert all(m.halo == 0 for m in model.modules() if isinstance(m, Conv))
        model.eval()
        assert model(torch.zeros(1, 32, 32, 3)).shape == (1, 32, 32, 6)
    assert all(m.space == 2 for m in spaced)


# ---- the trainer -----------------------------------------------------------------


def _trainer_argv(tmp_path, workdir, space: int) -> list:
    sets = ["model.name=deeplabv3p", "model.features=[64,128,256,512]",
            "model.width_divisor=8", "model.detail_head=False", "compression.mode=none",
            "train.epochs=2", "data.native_gather=False", "train.dump_images_per_epoch=1",
            f"parallel.space_axis_size={space}"]
    argv = ["--config", _tiny_cli_config(tmp_path), "--device", "cpu", "--workdir",
            str(workdir)]
    for s in sets:
        argv += ["--set", s]
    return argv


def test_trainer_shards_deeplab_halves_its_flops_and_restores_unsharded(tmp_path):
    """A tiny DeepLabV3+ (the tiny config's s2d stem setting, which
    DeepLabV3+ does not use) through ``Trainer`` at (data 1 × space 2) on
    32-row tiles, 16 a shard: sharded, finite, every rank the same bits,
    each perf record half the unsharded step's FLOPs, a prediction PNG an
    epoch (rank 0, unsharded); an unsharded trainer restores its last
    checkpoint bit for bit."""
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
    assert sorted(p.name for p in (workdir / "images").iterdir()) == ["epoch_0000", "epoch_0001"]
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
