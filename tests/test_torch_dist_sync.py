"""The port's gradient sync across processes against the JAX package.

Worlds of W ∈ {2, 3, 8} real processes (gloo, ``file://`` rendezvous in a
temporary directory, ``tests/test_torch_dist_worker.py``, which imports only the
port) each sync their own gradient tree; the result is held against
``sync_gradients`` (``shard_update='off'``) and ``sync_gradients_scatter``
(``zero2``, its shards gathered) in ``shard_map`` on a W-device slice of
JAX's 8-device CPU mesh, fed the same numpy trees.

- The lattice wires bit for bit: fp16 at 100 levels, int8 at 10 (nearest),
  int16 (int8 at 127 levels on 2 replicas, which neither backend can sum
  as int16: the port widens it to int32), and stochastic rounding with
  JAX's own per-replica and mean noise fields handed to the port.
  W = 3 gives a ragged chunk; the port pads its flat buffer to a multiple
  of 32 elements a chunk, which must stay zero.
- ``mode='none'`` (an fp32 sum in another order) within rtol 1e-6 (and
  an ulp of the largest element, for sums that cancel), and
  ``quantize_local=False`` (the same sum, then the mean stage) within one
  lattice step.

Also pinned here, without processes: ``resolve_shard_update`` against the
JAX package's over its whole grid, the loader's and the eval's shards
against ``ShardedLoader`` and ``eval_batches``, the mean stage against a
given max-abs, and the world's set-up rules.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from ddlpc_tpu.config import CompressionConfig as JCompression
from ddlpc_tpu.data import datasets as jdatasets
from ddlpc_tpu.data import loader as jloader
from ddlpc_tpu.parallel import grad_sync as jsync
from ddlpc_tpu.parallel import shard_update as jzero
from ddlpc_tpu.utils.compat import shard_map
from ddlpc_tpu_torch.config import CompressionConfig
from ddlpc_tpu_torch.data import datasets as tdatasets
from ddlpc_tpu_torch.data.loader import DeviceLoader, eval_batches, eval_indices
from ddlpc_tpu_torch.ops import cuda_quantize as cq
from ddlpc_tpu_torch.parallel import mesh
from ddlpc_tpu_torch.parallel import shard_update as tzero
from test_torch_codec import _tree
from test_torch_stochastic import _jax_stage_keys, _leaf_fields
from test_torch_dist_worker import run_world
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

CASES = {  # name: (tree mode, config, noise from JAX's key)
    "fp16": ("float16", dict(mode="float16"), False),
    "int8": ("int8", dict(mode="int8"), False),
    "int16": ("int8", dict(mode="int8", int8_levels=127), False),
    "int8_sr": ("int8", dict(mode="int8", rounding="stochastic"), True),
    "fp16_sr": ("float16", dict(mode="float16", rounding="stochastic"), True),
    "fp16_mean_only": ("float16", dict(mode="float16", quantize_local=False), False),
    "none": ("float16", dict(mode="none"), False),
}
GRID = {  # world: the (case, scatter) pairs its one world runs
    2: [(c, s) for c in ("fp16", "int8", "int16", "int8_sr", "none") for s in (False, True)],
    3: [("fp16", False), ("fp16", True), ("int8", True), ("fp16_sr", True),
        ("fp16_mean_only", True), ("none", True)],
    8: [("fp16", False), ("fp16", True), ("int8", False), ("int8", True),
        ("int8_sr", True), ("none", False)],
}
KEY = 47
_RESULTS: dict = {}


def _trees(mode: str, world: int) -> list:
    """One tree a replica, each with its own values and max-abs."""
    return [{k: v * np.float32(1 + 0.25 * r) for k, v in _tree(mode, seed=10 + r).items()}
            for r in range(world)]


def _flat(tree: dict) -> np.ndarray:
    return np.concatenate([tree[k].reshape(-1) for k in sorted(tree)])


def _jax_world(trees: list, jcfg: JCompression, scatter: bool, key) -> np.ndarray:
    """The JAX sync on a W-device mesh, replica r holding ``trees[r]``;
    the mean laid out flat (replica 0's, after checking all agree)."""
    world = len(trees)
    names = sorted(trees[0])
    mesh_ = Mesh(np.array(jax.devices()[:world]), ("data",))
    stacked = {k: jnp.stack([t[k] for t in trees]) for k in names}
    fn = jsync.sync_gradients_scatter if scatter else jsync.sync_gradients

    def body(g):
        out = fn(jax.tree.map(lambda x: x[0], g), "data", jcfg, axis_size=world, key=key)
        return jax.tree.map(lambda x: x[None], out)

    out = jax.jit(shard_map(body, mesh=mesh_, in_specs=(P("data"),), out_specs=P("data"),
                            check=False))(stacked)
    leaves = []
    for k in names:
        v = np.asarray(out[k])
        if scatter:  # [W, 1, K] chunks of the padded leaf
            leaves.append(v.reshape(-1)[: trees[0][k].size])
        else:
            for r in range(1, world):
                np.testing.assert_array_equal(v[r], v[0])
            leaves.append(v[0].reshape(-1))
    return np.concatenate(leaves)


def _world_results(world: int, tmp_path_factory) -> list:
    if world not in _RESULTS:
        key = jax.random.key(KEY)
        inputs, cases = {}, []
        for mode in ("float16", "int8"):
            trees = _trees(mode, world)
            shapes = [trees[0][k].shape for k in sorted(trees[0])]
            local, mean = _jax_stage_keys(key)
            for r, t in enumerate(trees):
                inputs[f"{mode}/g{r}"] = _flat(t)
                # The local key with replica r folded in, as _sync_tree folds it.
                lk = jax.random.fold_in(jax.random.split(key)[0], r)
                inputs[f"{mode}/local{r}"] = _leaf_fields(lk, shapes).numpy()
            inputs[f"{mode}/mean"] = _leaf_fields(mean, shapes).numpy()
        for name, scatter in GRID[world]:
            mode, cfg, noise = CASES[name]
            cases.append({"cfg": cfg, "tree": mode, "noise": noise, "scatter": scatter})
        work = str(tmp_path_factory.mktemp(f"sync_w{world}"))
        _RESULTS[world] = run_world("sync", world, work, {"cases": cases}, inputs)
    return _RESULTS[world]


@pytest.mark.parametrize(
    "world,name,scatter",
    [(w, c, s) for w, pairs in GRID.items() for c, s in pairs],
)
def test_world_sync_matches_jax(world, name, scatter, tmp_path_factory):
    outs = _world_results(world, tmp_path_factory)
    i = GRID[world].index((name, scatter))
    mode, cfg, noise = CASES[name]
    trees = _trees(mode, world)
    want = _jax_world(trees, JCompression(**cfg), scatter, jax.random.key(KEY) if noise else None)
    for r, out in enumerate(outs):
        got = out[f"{i}/mean"]
        if name == "none":
            # An fp32 sum of W terms in another order: off by an ulp or two
            # of the largest term, which near a cancellation is a large
            # share of the sum.
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
        elif not cfg.get("quantize_local", True):
            # The same sum, then the mean stage: where the two sums differ
            # by an ulp at a half-lattice tie (the tree places values on
            # them), they snap to neighbouring lattice points.
            step = np.abs(want).max() / 100
            assert np.abs(got - want).max() <= step * (1 + 1e-4)
        else:
            np.testing.assert_array_equal(got, want)
        # Every replica holds the same mean, and the padding stays zero.
        np.testing.assert_array_equal(got, outs[0][f"{i}/mean"])
        assert not out[f"{i}/tail"].any()
        if scatter:  # the chunk a replica owns is its slice of the mean
            k = out[f"{i}/shard"].size
            full = np.concatenate([got, out[f"{i}/tail"]])
            np.testing.assert_array_equal(out[f"{i}/shard"], full[r * k : (r + 1) * k])


def test_int16_wire_is_chosen_and_fits():
    from ddlpc_tpu.parallel.compressed_allreduce import wire_dtype as jwire
    from ddlpc_tpu_torch.parallel.compressed_allreduce import wire_dtype
    from ddlpc_tpu_torch.parallel.grad_sync import simulate_wire_dtype

    cfg = CompressionConfig(mode="int8", int8_levels=127)
    assert simulate_wire_dtype(2, cfg) == torch.int16
    for n, levels in itertools.product((1, 2, 3, 8, 300), (1, 10, 127)):
        try:
            want = jnp.dtype(jwire(n, levels)).name
        except ValueError:
            with pytest.raises(ValueError):
                wire_dtype(n, levels)
            continue
        assert str(wire_dtype(n, levels)).replace("torch.", "") == want


# --- resolve_shard_update ----------------------------------------------------


_MODES = ("auto", "on", "off", "zero1", "zero2", "zero3", "bogus")


@pytest.mark.parametrize("world", [1, 2, 8])
@pytest.mark.parametrize("mode", _MODES)
def test_resolve_shard_update_matches_jax(mode, world):
    for cmode, transport, backend, qmean, clip in itertools.product(
        ("none", "int8", "float16"), ("simulate", "ring"), ("xla", "pallas"),
        (True, False), (0.0, 1.0),
    ):
        kw = dict(mode=cmode, transport=transport, codec_backend=backend, quantize_mean=qmean)
        try:
            want = jzero.resolve_shard_update(mode, JCompression(**kw), world, False, clip)
        except ValueError:
            with pytest.raises(ValueError):
                tzero.resolve_shard_update(mode, CompressionConfig(**kw), world, False, clip)
            continue
        got = tzero.resolve_shard_update(mode, CompressionConfig(**kw), world, False, clip)
        assert got == want, (mode, kw, clip)


def test_flagship_v5e8_and_its_stochastic_arm_resolve_as_in_jax():
    """v5e8 is zero2; its int8-stochastic arm (codec_backend=pallas, with
    quantize_mean) is the replicated fused all-reduce."""
    fp16 = CompressionConfig(mode="float16")
    sr = CompressionConfig(mode="int8", rounding="stochastic", codec_backend="pallas")
    assert tzero.resolve_shard_update("auto", fp16, 4, False) == "zero2"
    assert tzero.resolve_shard_update("auto", sr, 2, False) == "off"
    assert tzero.resolve_shard_update("auto", fp16, 1, False) == "off"
    for level in ("off", "zero1", "zero2", "zero3"):  # every level is ported
        assert tzero.normalize_shard_update(level) == jzero.normalize_shard_update(level)
    for bad in ("zero4", "auto"):
        with pytest.raises(ValueError, match="unknown shard_update level"):
            tzero.normalize_shard_update(bad)
        with pytest.raises(ValueError, match="unknown shard_update level"):
            jzero.normalize_shard_update(bad)
    assert tzero.normalize_shard_update(True) == jzero.normalize_shard_update(True)


@pytest.mark.parametrize("n,world", [(8372422, 4), (8372422, 8), (1327, 3), (5, 8), (64, 1)])
def test_flat_chunks_are_aligned_and_cover_the_buffer(n, world):
    k = tzero.flat_chunk_rows(n, world)
    assert world * k >= n and (world == 1 or k % 32 == 0)
    assert k - tzero.chunk_rows(n, world) < 32 or world == 1
    if world == 1:
        assert k == n
    buf = torch.zeros(world * k)
    for r in range(world):
        c = tzero.local_chunk(buf, world, r)
        assert c.data_ptr() - buf.data_ptr() == 4 * r * k and c.numel() == k


# --- the mean stage against a given max-abs ----------------------------------


@pytest.mark.parametrize("mode,rounding", [("float16", "nearest"), ("int8", "nearest"), ("int8", "stochastic")])
def test_fake_quantize_of_a_chunk_against_the_whole_max(mode, rounding):
    """Chunk r of the mean, quantized against the whole mean's max-abs with
    the key's stream from the chunk's offset, equals the same elements of
    the whole mean quantized."""
    cfg = CompressionConfig(mode=mode, rounding=rounding)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=4 * 96).astype(np.float32))
    x[7] = 3.0  # the max lies in chunk 0
    key = (5, 6) if rounding == "stochastic" else None
    whole = cq.fake_quantize_fused(x, cfg, key=key)
    amax = cq.absmax(x)
    for r in range(4):
        chunk = x[r * 96 : (r + 1) * 96]
        got = cq.fake_quantize_fused(chunk, cfg, key=key, offset=r * 96 if key else 0, amax=amax)
        torch.testing.assert_close(got, whole[r * 96 : (r + 1) * 96], rtol=0, atol=0)
    with pytest.raises(ValueError, match="amax"):
        cq.fake_quantize_fused(x, cfg, key=key, amax=torch.ones(2))


# --- the loader's and the eval's shards --------------------------------------


def _fake_processes(monkeypatch, pid: int, world: int) -> None:
    monkeypatch.setattr(jloader.jax, "process_count", lambda: world)
    monkeypatch.setattr(jloader.jax, "process_index", lambda: pid)


@pytest.mark.parametrize("world", [2, 4])
def test_loader_shards_match_sharded_loader(world, monkeypatch):
    jds = jdatasets.SyntheticTiles(num_tiles=37, image_size=(8, 8), seed=1)
    tds = tdatasets.SyntheticTiles(num_tiles=37, image_size=(8, 8), seed=1)
    mesh_ = Mesh(np.array(jax.devices()[:world]), ("data",))
    for pid in range(world):
        _fake_processes(monkeypatch, pid, world)
        jl = jloader.ShardedLoader(jds, mesh_, global_micro_batch=2 * world, sync_period=3,
                                   seed=5, native_gather=False)
        tl = DeviceLoader(tds, micro_batch=2, sync_period=3, device=torch.device("cpu"),
                          seed=5, replica=pid, world=world)
        for epoch in (0, 3):
            jl.set_epoch(epoch)
            tl.set_epoch(epoch)
            want = list(jl._super_batch_index_chunks())
            got = list(tl.index_chunks())
            assert len(got) == len(want) == len(tl) > 0
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        images, labels = next(iter(tl))
        assert images.shape == (3, 2, 8, 8, 3) and labels.shape == (3, 2, 8, 8)
        wx, wy = tds.gather(next(tl.index_chunks()))
        np.testing.assert_array_equal(images.reshape(6, 8, 8, 3).numpy(), wx)


@pytest.mark.parametrize("world", [2, 4])
def test_eval_shards_and_padding_match_jax(world, monkeypatch):
    jds = jdatasets.SyntheticTiles(num_tiles=13, image_size=(8, 8), seed=2)
    tds = tdatasets.SyntheticTiles(num_tiles=13, image_size=(8, 8), seed=2)
    mesh_ = Mesh(np.array(jax.devices()[:world]), ("data",))
    monkeypatch.setattr(jloader, "make_global_array", lambda a, m, s: a)
    for pid in range(world):
        _fake_processes(monkeypatch, pid, world)
        want = list(jloader.eval_batches(jds, mesh_, global_batch=3 * world))
        got = list(eval_batches(tds, 3, torch.device("cpu"), pid, world))
        assert len(got) == len(want)
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx.numpy(), wx)
            np.testing.assert_array_equal(gy.numpy(), wy)
    # Every tile evaluated exactly once over the replicas.
    seen = [i for r in range(world) for idx, valid in eval_indices(13, 3, r, world) for i in idx[valid]]
    assert sorted(seen) == list(range(13))


# --- the world's set-up -------------------------------------------------------


def test_rank_device_follows_local_rank_and_never_picks_on_its_own(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert mesh.rank_device("cuda") == torch.device("cuda", 1)
    assert mesh.rank_device("cuda:0") == torch.device("cuda", 0)
    assert mesh.rank_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="cuda:0"):
        mesh.rank_device("cuda")
    assert mesh.default_backend(torch.device("cuda", 0)) == "nccl"
    assert mesh.default_backend(torch.device("cpu")) == "gloo"


def test_world_of_one_needs_no_group(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    mesh.initialize_distributed("gloo")
    assert (mesh.data_size(), mesh.replica_index()) == (1, 0)
    mesh.check_world(1)
    with pytest.raises(ValueError, match="axis_size=2"):
        mesh.check_world(2)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "2")
    with pytest.raises(ValueError, match="RANK=2"):
        mesh.world_from_env()


def test_a_failing_rank_or_a_hung_world_is_killed(tmp_path):
    import sys
    import time

    t0 = time.monotonic()
    code = "import os, sys, time; r = int(os.environ['RANK']); time.sleep(0.5 if r else 60); sys.exit(3 if r else 0)"
    with pytest.raises(RuntimeError, match="rank 1 exited with 3"):
        mesh.spawn_world([sys.executable, "-c", code], 2, deadline_s=60)
    with pytest.raises(TimeoutError, match="killed"):
        mesh.spawn_world([sys.executable, "-c", "import time; time.sleep(60)"], 2, deadline_s=1)
    assert time.monotonic() - t0 < 30
