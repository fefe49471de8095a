"""Gradient buckets and the quantized ring transport against the JAX package.

Buckets (``compression.bucket_mb > 0``):

- ``bucketing.py``'s assignment equals the JAX package's on random leaf
  sizes and targets;
- ``FlatParams`` lays its leaves out in ``jax.tree_util.tree_flatten``'s
  order of the converted params for the U-Net, U-Net++ and DeepLabV3+, and
  its bucket regions hold JAX's ``grad_bucket_groups``, each contiguous;
- in gloo worlds of W = 2 and 3 (``tests/test_torch_dist_worker.py``), the
  bucketed sync of a four-leaf tree (several buckets) equals JAX's
  ``sync_gradients`` / ``sync_gradients_scatter`` with the same
  ``bucket_mb`` on a W-device mesh bit for bit, nearest, on the fp16 and
  int8 wires, and one bucket (a target larger than the tree) equals no
  buckets.

The ring (``compression.transport='ring'``):

- in the same worlds it equals ``ring_allreduce_mean_quantized`` bit for
  bit, nearest, on the int8 wire (W·levels ≤ 127) and the int16 wire
  (above: int8 at 127 levels, and the fp16 codec's 100 levels);
- stochastic rounding over 32 keys stays within ±2·scale/levels of the
  exact mean at every element, and its error averages to zero;
- ``ring_wire_report`` gives JAX's integers, and a world and level count
  that need an int32 hop raise JAX's ``ValueError``;
- a world of one applies the two loss points as two fake-quantizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddlpc_tpu.config import CompressionConfig as JCompression
from ddlpc_tpu.parallel import bucketing as jbucketing
from ddlpc_tpu.parallel import compressed_allreduce as jring
from ddlpc_tpu.parallel import grad_sync as jsync
from ddlpc_tpu_torch.config import CompressionConfig, ModelConfig
from ddlpc_tpu_torch.convert import flax_from_torch, flax_param_path
from ddlpc_tpu_torch.models import build_model
from ddlpc_tpu_torch.ops import cuda_quantize as cq
from ddlpc_tpu_torch.ops.philox import step_key
from ddlpc_tpu_torch.parallel import bucketing
from ddlpc_tpu_torch.parallel import compressed_allreduce as tring
from ddlpc_tpu_torch.parallel import grad_sync as tsync
from ddlpc_tpu_torch.parallel.train_step import FlatParams
from test_torch_dist_sync import _flat, _jax_world, _trees
from test_torch_dist_worker import run_world
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

BUCKET_MB = 400 / 2**20  # 400 bytes: three buckets of the int8 tree, four of the fp16 one
CASES = {  # name: (tree mode, config, scatter)
    "bucket_fp16": ("float16", dict(mode="float16", bucket_mb=BUCKET_MB), False),
    "bucket_fp16_scatter": ("float16", dict(mode="float16", bucket_mb=BUCKET_MB), True),
    "bucket_int8": ("int8", dict(mode="int8", bucket_mb=BUCKET_MB), False),
    "bucket_int8_scatter": ("int8", dict(mode="int8", bucket_mb=BUCKET_MB), True),
    "one_bucket_int8": ("int8", dict(mode="int8", bucket_mb=64.0), False),
    "one_bucket_fp16_scatter": ("float16", dict(mode="float16", bucket_mb=64.0), True),
    "ring_int8": ("int8", dict(mode="int8", transport="ring"), False),
    "ring_int16": ("int8", dict(mode="int8", int8_levels=127, transport="ring"), False),
    "ring_fp16": ("float16", dict(mode="float16", transport="ring"), False),
}
NO_BUCKETS = {"one_bucket_int8": "int8_plain", "one_bucket_fp16_scatter": "fp16_scatter_plain"}
PLAIN = {"int8_plain": ("int8", dict(mode="int8"), False),
         "fp16_scatter_plain": ("float16", dict(mode="float16"), True)}
STOCHASTIC = ("int8", dict(mode="int8", transport="ring", rounding="stochastic"), False)
KEYS = [step_key(7, s) for s in range(32)]
WORLDS = (2, 3)
_RESULTS: dict = {}


def _sizes(mode: str) -> list:
    tree = _trees(mode, 1)[0]
    return [tree[k].size for k in sorted(tree)]


def _world(world: int, tmp_path_factory) -> tuple:
    if world not in _RESULTS:
        names = list(CASES) + list(PLAIN) + (["stochastic"] if world == 2 else [])
        table = {**CASES, **PLAIN, "stochastic": STOCHASTIC}
        inputs, cases = {}, []
        for mode in ("float16", "int8"):
            for r, t in enumerate(_trees(mode, world)):
                inputs[f"{mode}/g{r}"] = _flat(t)
        for name in names:
            mode, cfg, scatter = table[name]
            case = {"cfg": cfg, "tree": mode, "noise": False, "scatter": scatter,
                    "sizes": _sizes(mode)}
            if name == "stochastic":
                case["keys"] = KEYS
            cases.append(case)
        work = str(tmp_path_factory.mktemp(f"buckets_w{world}"))
        _RESULTS[world] = (names, run_world("sync", world, work, {"cases": cases}, inputs))
    return _RESULTS[world]


# --- the assignment and the layout ---------------------------------------------


def test_assignment_equals_jax():
    rng = np.random.default_rng(0)
    for _ in range(200):
        sizes = [int(v) for v in rng.integers(1, 5000, rng.integers(0, 30))]
        mb = float(rng.choice([0.0, -1.0, 1e-4, 2e-3, 0.01, 1.0]))
        assert bucketing.assign_buckets(sizes, mb) == jbucketing.assign_buckets(sizes, mb)
        assert bucketing.bucket_index_groups(sizes, mb) == jbucketing.bucket_index_groups(sizes, mb)
        assert bucketing.bucket_count(sizes, mb) == jbucketing.bucket_count(sizes, mb)


MODELS = {
    "unet": dict(features=(8, 16), bottleneck_features=16, stem="s2d", stem_factor=2,
                 detail_head=True),
    "unetpp": dict(name="unetpp", features=(8, 16, 32), deep_supervision=True),
    "deeplabv3p": dict(name="deeplabv3p", features=(64, 128, 256, 512), width_divisor=8),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_flat_layout_is_jax_flatten_order_and_buckets_are_contiguous(name):
    model = build_model(ModelConfig(**MODELS[name]))
    params, _, _ = flax_from_torch(model.state_dict())
    paths = [tuple(k.key for k in path) for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    for mb in (0.0, 0.002, 0.05):
        flat = FlatParams(build_model(ModelConfig(**MODELS[name])), n_shards=3, bucket_mb=mb)
        order = [flax_param_path(n, len(s)) for n, s in zip(flat.names, flat.shapes)]
        assert order == paths
        groups = jsync.grad_bucket_groups(params, mb)
        assert len(flat.regions) == len(groups) >= 1
        for (start, n, rows), idxs in zip(flat.regions, groups):
            # The group's leaves fill the region's head in order, then zeros.
            assert flat.offsets[idxs[0]] == start
            assert n == sum(int(np.prod(flat.shapes[i])) for i in idxs) <= 3 * rows
            assert rows % 32 == 0 or len(groups) == 1
        covered = torch.zeros(flat.data.numel(), dtype=torch.bool)
        for o, s in zip(flat.offsets, flat.shapes):
            covered[o : o + int(np.prod(s))] = True
        assert int(covered.sum()) == flat.numel and not flat.data[~covered].any()


# --- the worlds ----------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_world_sync_matches_jax(world, name, tmp_path_factory):
    names, outs = _world(world, tmp_path_factory)
    i = names.index(name)
    mode, cfg, scatter = CASES[name]
    want = _jax_world(_trees(mode, world), JCompression(**cfg), scatter, None)
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out[f"{i}/mean"], want, err_msg=f"rank {r}")
        assert not out[f"{i}/tail"].any()
    if name in NO_BUCKETS:  # one bucket is the unbucketed sync
        j = names.index(NO_BUCKETS[name])
        for out in outs:
            np.testing.assert_array_equal(out[f"{i}/mean"], out[f"{j}/mean"])
            if scatter:
                np.testing.assert_array_equal(out[f"{i}/shard"], out[f"{j}/shard"])


def test_ring_stochastic_rounding_bound_and_zero_mean(tmp_path_factory):
    names, outs = _world(2, tmp_path_factory)
    i = names.index("stochastic")
    trees = _trees("int8", 2)
    exact = np.mean([_flat(t) for t in trees], axis=0, dtype=np.float64)
    scale = max(np.abs(_flat(t)).max() for t in trees)
    step = scale / 10
    errs = np.stack([outs[0][f"{i}/{d}/mean"] - exact for d in range(len(KEYS))])
    for out in outs[1:]:
        for d in range(len(KEYS)):
            np.testing.assert_array_equal(out[f"{i}/{d}/mean"], outs[0][f"{i}/{d}/mean"])
    assert np.abs(errs).max() <= 2 * step * (1 + 1e-6)
    # 32 draws of ~1,150 elements: the mean error, in steps, has a spread
    # near 0.003; a biased rounding would sit at a sizeable share of 1.
    assert abs(errs.mean() / step) < 0.02
    assert len({outs[0][f"{i}/{d}/mean"].tobytes() for d in range(len(KEYS))}) == len(KEYS)


def test_ring_wire_report_and_int32_refusal_equal_jax():
    for n, world, kw in ((8372422, 4, dict(mode="int8")), (1327, 3, dict(mode="int8")),
                         (1327, 3, dict(mode="float16")), (5, 8, dict(mode="int8", int8_levels=127)),
                         (100, 2, dict(mode="none"))):
        got = tring.ring_wire_report(n, world, CompressionConfig(**kw))
        want = jring.ring_wire_report(n, world, JCompression(**kw))
        assert got == want, (n, world, kw)
    flagship = tring.ring_wire_report(8372422, 4, CompressionConfig(mode="int8"))
    assert (flagship["bytes_per_hop"], flagship["wire_bytes_per_replica"],
            flagship["fp32_bytes_per_replica"]) == (2093106, 12558636, 50234544)
    big = CompressionConfig(mode="int8", int8_levels=127, transport="ring")
    with pytest.raises(ValueError) as want:
        jring.wire_dtype(300, 127)
    with pytest.raises(ValueError) as got:
        tsync.sync_gradients(torch.zeros(600), big, axis_size=300)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
def test_ring_of_one_is_two_fake_quantizes(rounding):
    cfg = CompressionConfig(mode="int8", transport="ring", rounding=rounding)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=1031).astype(np.float32))
    key = step_key(3, 1) if rounding == "stochastic" else None
    got = tsync.sync_gradients(x.clone(), cfg, axis_size=1, key=key)
    local, mean = tsync._stage_draws(cfg, 1, key, None)
    want = cq.fake_quantize_fused(cq.fake_quantize_fused(x, cfg, **local), cfg, **mean)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    if rounding == "nearest":  # and the JAX package's size-1 arm
        jcfg = JCompression(mode="int8", transport="ring")
        mesh_ = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
        from ddlpc_tpu.utils.compat import shard_map
        from jax.sharding import PartitionSpec as P

        fn = shard_map(lambda g: jsync.sync_gradients(g, "data", jcfg, axis_size=1),
                       mesh=mesh_, in_specs=(P(),), out_specs=P(), check=False)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax.jit(fn)(jnp.asarray(x.numpy()))))


def test_ring_refusals_are_jax_words():
    x = torch.zeros(64)
    for kw in (dict(bucket_mb=1.0), dict(quantize_local=False), dict(quantize_mean=False)):
        cfg = dict(mode="int8", transport="ring", **kw)
        with pytest.raises(ValueError) as want:
            jsync.sync_gradients({"a": jnp.zeros(64)}, "data", JCompression(**cfg), axis_size=2)
        with pytest.raises(ValueError) as got:
            tsync.sync_gradients(x.clone(), CompressionConfig(**cfg), axis_size=2)
        assert str(got.value) == str(want.value)
    for cfg in (dict(mode="int8", transport="ring"),
                dict(mode="int8", codec_backend="pallas")):
        with pytest.raises(ValueError) as want:
            jsync.validate_scatter_compression(JCompression(**cfg))
        with pytest.raises(ValueError) as got:
            tsync.validate_scatter_compression(CompressionConfig(**cfg))
        assert str(got.value) == str(want.value)
