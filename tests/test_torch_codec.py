"""The port's gradient codec against the JAX package's, on the CPU.

The same numpy inputs (seeded) go through ``ddlpc_tpu.ops.quantize``,
``ddlpc_tpu.ops.pallas_quantize`` (Pallas interpreter) and
``ddlpc_tpu.parallel.grad_sync.sync_gradients`` (shard_map on a 1-device
mesh) and through their ports.  Tolerances: the plain codec and the sync
are held BIT-EXACT (same IEEE operations in the same order); against the
Pallas fake-quantize kernel, which dequantizes as ``lattice / levels ·
scale`` instead of ``lattice · (scale / levels)``, 1 ulp.

The CUDA kernels themselves cannot run here; they are held against these
same plain versions on the card by ``chip_smoke.py`` and by
``tests/test_torch_kernels_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from ddlpc_tpu.config import CompressionConfig as JCompression
from ddlpc_tpu.ops import pallas_quantize as jpallas
from ddlpc_tpu.ops import quantize as jq
from ddlpc_tpu.parallel import grad_sync as jsync
from ddlpc_tpu.utils.compat import shard_map
from ddlpc_tpu_torch.config import CompressionConfig
from ddlpc_tpu_torch.ops import cuda_quantize as cq
from ddlpc_tpu_torch.ops import quantize as tq
from ddlpc_tpu_torch.parallel import grad_sync as tsync
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

MODES = ["int8", "float16"]


def _tree(mode: str, seed: int = 0) -> dict:
    """A gradient-like tree with a zero leaf, a ragged leaf, and values
    placed exactly on half-lattice points of the pinned scale 2.0."""
    rng = np.random.default_rng(seed)
    levels = 10 if mode == "int8" else 100
    half = (np.arange(-levels, levels) + 0.5) * (2.0 / levels)
    body = rng.normal(size=(7, 13)).astype(np.float32) * 0.3
    body[0, 0] = 2.0  # pins the whole-model scale
    return {
        "a_body": body,
        "b_half": half.astype(np.float32),
        "c_zero": np.zeros((5,), np.float32),
        "d_ragged": rng.normal(size=(1031,)).astype(np.float32) * 0.01,
    }


def _leaves(tree):
    return [tree[k] for k in sorted(tree)]


def _torch_leaves(tree):
    return [torch.from_numpy(v.copy()) for v in _leaves(tree)]


def _exact(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", MODES)
def test_plain_codec_bit_exact_against_jax(mode):
    tree = _tree(mode)
    jcfg, tcfg = JCompression(mode=mode), CompressionConfig(mode=mode)
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    tl = _torch_leaves(tree)

    jenc = jq.encode(jtree, jcfg)
    tenc = tq.encode(tl, tcfg)
    _exact(jenc.scale, tenc.scale.numpy())
    for jl, t in zip(_leaves(jenc.tree), tenc.tree):
        _exact(jl, t.numpy())
    for jl, t in zip(_leaves(jq.decode(jenc, jcfg)), tq.decode(tenc, tcfg)):
        _exact(jl, t.numpy())
    for jl, t in zip(_leaves(jq.fake_quantize(jtree, jcfg)), tq.fake_quantize(tl, tcfg)):
        _exact(jl, t.numpy())

    levels = float(jq.levels_for(jcfg))
    assert levels == tq.levels_for(tcfg)
    for scale in (2.0, 0.0, 3e-3):
        jsafe = jq.safe_divisor(jnp.float32(scale))
        tsafe = tq.safe_divisor(torch.tensor(scale, dtype=torch.float32))
        _exact(jsafe, tsafe.numpy())
        for k in sorted(tree):
            _exact(
                jq.quantize_with_scale(jnp.asarray(tree[k]), jsafe, levels),
                tq.quantize_with_scale(torch.from_numpy(tree[k]), tsafe, levels).numpy(),
            )
    assert jq.quantization_error_bound(jcfg) == tq.quantization_error_bound(tcfg)
    # The half-lattice leaf really does exercise ties (half-to-even).
    scaled = tree["b_half"] / np.float32(2.0) * np.float32(levels)
    assert (np.abs(scaled % 1 - 0.5) == 0).sum() > 0


def test_plain_codec_zero_tree_and_mode_none():
    zeros = [torch.zeros(4), torch.zeros(3, 2)]
    out = tq.fake_quantize(zeros, CompressionConfig(mode="int8"))
    assert all(torch.equal(o, z) for o, z in zip(out, zeros))
    x = [torch.randn(6)]
    assert tq.fake_quantize(x, CompressionConfig(mode="none"))[0] is x[0]
    assert float(tq.global_absmax([])) == 0.0


def _jax_sync(tree: dict, jcfg: JCompression, key=None) -> dict:
    """JAX's ``sync_gradients`` in ``shard_map`` on a 1-device mesh; ``key``
    drives stochastic rounding."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    body = shard_map(
        lambda g: jsync.sync_gradients(g, "data", jcfg, axis_size=1, key=key),
        mesh=mesh, in_specs=(P(),), out_specs=P(), check=False,
    )
    return jax.jit(body)({k: jnp.asarray(v) for k, v in tree.items()})


@pytest.mark.parametrize(
    "mode,local,mean",
    [("float16", True, True), ("int8", True, True), ("float16", False, True),
     ("int8", True, False), ("none", True, True)],
)
def test_sync_n1_bit_exact_against_jax_shard_map(mode, local, mean):
    """The port's sync on the flat buffer (encode → identity sum → decode,
    then fake-quantize of the mean) equals the JAX sync per element."""
    tree = _tree("int8" if mode == "int8" else "float16", seed=3)
    jcfg = JCompression(mode=mode, quantize_local=local, quantize_mean=mean)
    tcfg = CompressionConfig(mode=mode, quantize_local=local, quantize_mean=mean)
    ref = _jax_sync(tree, jcfg)
    flat = torch.cat([t.reshape(-1) for t in _torch_leaves(tree)])
    out = tsync.sync_gradients(flat, tcfg, axis_size=1)
    assert out is flat  # in place
    got = np.split(flat.numpy(), np.cumsum([tree[k].size for k in sorted(tree)])[:-1])
    for k, g in zip(sorted(tree), got):
        _exact(np.asarray(ref[k]).reshape(-1), g)


def test_flagship_wire_is_fp16_at_one_replica():
    cfg = CompressionConfig(mode="float16", fp16_levels=100)
    assert tsync.simulate_wire_dtype(1, cfg) == torch.float16
    assert jsync.simulate_wire_dtype(1, JCompression(mode="float16")) == jnp.float16
    for n, levels in ((1, 10), (12, 10), (13, 10), (4000, 10)):
        j = jsync.simulate_wire_dtype(n, JCompression(mode="int8", int8_levels=levels))
        t = tsync.simulate_wire_dtype(n, CompressionConfig(mode="int8", int8_levels=levels))
        assert (None if j is None else np.dtype(j).name) == (
            None if t is None else str(t).replace("torch.", "")
        )


@pytest.mark.parametrize("mode", MODES)
def test_wrappers_on_cpu_match_pallas_interpret(mode):
    """encode and decode are bit-exact against the Pallas kernels run in the
    interpreter; fake-quantize within 1 ulp (the Pallas kernel's dequant
    order differs, see module docstring)."""
    tree = _tree(mode, seed=5)
    jcfg, tcfg = JCompression(mode=mode), CompressionConfig(mode=mode)
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    flat_np = np.concatenate([tree[k].reshape(-1) for k in sorted(tree)])
    flat = torch.from_numpy(flat_np.copy())
    levels = float(jq.levels_for(jcfg))
    scale = jq.global_absmax(jtree)
    wire = jnp.int8 if mode == "int8" else jnp.float16
    twire = torch.int8 if mode == "int8" else torch.float16

    jq_w = jpallas.encode_to_wire_pallas(jtree, jcfg, jq.safe_divisor(scale), wire, interpret=True)
    tq_w = cq.encode_to_wire(flat, tq.safe_divisor(torch.tensor(np.asarray(scale)).reshape(1)), tcfg, twire)
    _exact(np.concatenate([np.asarray(v).reshape(-1) for v in _leaves(jq_w)]), tq_w.numpy())

    inv = scale / levels
    jdec = jpallas.decode_from_wire_pallas(jq_w, inv, interpret=True)
    tdec = cq.decode_from_wire(tq_w, torch.tensor(np.asarray(inv)).reshape(1))
    _exact(np.concatenate([np.asarray(v).reshape(-1) for v in _leaves(jdec)]), tdec.numpy())

    jfq = jpallas.fake_quantize_pallas(jtree, jcfg, interpret=True)
    tfq = cq.fake_quantize_fused(flat, tcfg)
    np.testing.assert_allclose(
        np.concatenate([np.asarray(v).reshape(-1) for v in _leaves(jfq)]),
        tfq.numpy(), rtol=1.2e-7, atol=0,
    )
    # ... and bit-exact against the XLA codec, the port's target.
    _exact(
        np.concatenate([np.asarray(v).reshape(-1) for v in _leaves(jq.fake_quantize(jtree, jcfg))]),
        tfq.numpy(),
    )
    # In place gives the same bits.
    inplace = flat.clone()
    assert cq.fake_quantize_fused(inplace, tcfg, out=inplace) is inplace
    assert torch.equal(inplace, tfq)


_DECODE_WIRES = {"int8": (np.int8, torch.int8), "int16": (np.int16, torch.int16),
                 "float16": (np.float16, torch.float16)}


# Around the decode kernel's edges: four elements a 16-byte store, a
# warp's pass of 1024 elements on every wire, a few passes and one more.
# On the CPU the wrapper runs the plain version; the card tests
# (test_torch_kernels_gpu.py) hold the kernel itself at these sizes.
@pytest.mark.parametrize("n", [1, 3, 4, 5, 1023, 1024, 1025, 3 * 1024 + 1])
@pytest.mark.parametrize("wire", sorted(_DECODE_WIRES))
def test_decode_at_tile_edges_bit_exact_against_pallas_interpret(wire, n):
    """The decode wrapper equals ``decode_from_wire_pallas`` (interpreter)
    on a one-leaf tree bit for bit, on the whole wire buffer and on the
    slice ``q[1:]`` decoded into the slice ``out[1:]`` of a larger buffer
    (neither 16-byte aligned on the card)."""
    npw, tw = _DECODE_WIRES[wire]
    rng = np.random.default_rng(n)
    q = rng.integers(-127, 128, size=n + 1).astype(npw)
    qt = torch.from_numpy(q.copy())
    assert qt.dtype == tw
    inv = np.float32(0.0371) / np.float32(10)
    inv_t = torch.tensor([inv])
    for lo in (0, 1):
        want = jpallas.decode_from_wire_pallas(
            {"q": jnp.asarray(q[lo : lo + n])}, jnp.float32(inv), interpret=True
        )["q"]
        _exact(want, cq.decode_from_wire(qt[lo : lo + n], inv_t).numpy())
        out = torch.full((n + 1,), float("nan"))
        tail = out[1:]
        assert cq.decode_from_wire(qt[lo : lo + n], inv_t, out=tail) is tail
        _exact(want, tail.numpy())
        assert np.isnan(out[0].item())


def test_wrappers_raise_on_unsupported_input():
    x = torch.randn(64)
    safe = torch.ones(1)
    f16 = CompressionConfig(mode="float16")
    sto = CompressionConfig(mode="float16", rounding="stochastic")
    # A stochastic config with neither a key nor a noise field raises.
    with pytest.raises(ValueError, match="stochastic"):
        cq.encode_to_wire(x, safe, sto, torch.float16)
    with pytest.raises(ValueError, match="stochastic"):
        cq.fake_quantize_fused(x, sto)
    with pytest.raises(TypeError, match="float32"):
        cq.encode_to_wire(x.double(), safe, f16, torch.float16)
    with pytest.raises(TypeError, match="float32"):
        cq.fake_quantize_fused(x.half(), f16)
    with pytest.raises(ValueError, match="contiguous"):
        cq.encode_to_wire(x[::2], safe, f16, torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        cq.fake_quantize_fused(x[::2], f16)
    with pytest.raises(ValueError, match="contiguous"):
        cq.decode_from_wire(x.half()[::2], safe)
    with pytest.raises(TypeError, match="wire dtype"):
        cq.encode_to_wire(x, safe, f16, torch.int32)
    with pytest.raises(TypeError, match="wire dtype"):
        cq.decode_from_wire(x, safe)
    with pytest.raises(ValueError, match="1-element"):
        cq.encode_to_wire(x, torch.ones(2), f16, torch.float16)
    with pytest.raises(ValueError, match="unsupported device"):
        cq.encode_to_wire(x.to("meta"), torch.ones(1, device="meta"), f16, torch.float16)
    with pytest.raises(ValueError, match="stochastic"):
        tsync.sync_gradients(x.clone(), sto)
    with pytest.raises(ValueError, match="bucket_mb composes only with transport='simulate'"):
        tsync.sync_gradients(x.clone(), CompressionConfig(mode="int8", transport="ring", bucket_mb=1.0))
    with pytest.raises(ValueError, match="codec_backend"):
        tsync.sync_gradients(x.clone(), CompressionConfig(mode="int8", codec_backend="cuda"))
    # The CPU path launches nothing: no kernel count moves.
    cq.reset_launch_counts()
    cq.fake_quantize_fused(x, f16)
    assert cq.LAUNCHES == {k: 0 for k in cq.LAUNCHES}

