"""The gradient-codec CUDA kernels against their plain versions, on a card.

These tests need a CUDA card and ``nvcc`` (the kernels have no CPU mode)
and skip without one.  The file imports nothing of JAX, so it runs on a
machine that has only PyTorch; ``tests/conftest.py`` sets up JAX, so pass
``--noconftest`` there::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_gpu.py

Tolerance: none.  Each kernel does the plain version's IEEE operations in
the same order, and the stochastic kernels draw the plain Philox stream
(``ops/philox.py``) bit for bit, so the outputs are compared with
``torch.equal``.
"""

import numpy as np
import pytest
import torch

from ddlpc_tpu_torch.config import CompressionConfig
from ddlpc_tpu_torch.ops import cuda_quantize as cq
from ddlpc_tpu_torch.ops import philox
from ddlpc_tpu_torch.ops import quantize as tq
from ddlpc_tpu_torch.parallel import grad_sync
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

WIRES = [("float16", torch.float16), ("int8", torch.int8), ("int8", torch.int16)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _grads(n: int, device) -> torch.Tensor:
    """Gradient-like values with a zero tail and half-lattice ties."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n,)).astype(np.float32) * 0.05
    if n > 8:
        x[0] = 1.0
        x[-(n // 8):] = 0.0
        k = np.arange(-100, 100)[: n // 4]
        x[1 : 1 + k.size] = (k + 0.5) / 100
    return torch.from_numpy(x).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 7, 15, 17, 100_003])
def test_kernels_equal_plain_versions_on_card(card, n):
    """Each kernel is bit-identical to its plain version on every wire, at
    sizes below, at and past one 16-byte vector; one launch per call."""
    x = _grads(n, card)
    scale = x.abs().amax().reshape(1)
    safe = tq.safe_divisor(scale)
    cq.reset_launch_counts()
    for mode, wire in WIRES:
        cfg = CompressionConfig(mode=mode)
        levels = float(tq.levels_for(cfg))
        inv = tq.true_div(scale, levels)
        q = cq.encode_to_wire(x, safe, cfg, wire)
        assert q.dtype == wire
        assert torch.equal(q, tq.encode_with_scale(x, safe, levels, wire))
        assert torch.equal(cq.decode_from_wire(q, inv), tq.decode_with_inv(q, inv))
        assert torch.equal(cq.fake_quantize_fused(x, cfg), cq.fake_quantize_plain(x, cfg))
        inplace = x.clone()
        cq.fake_quantize_fused(inplace, cfg, out=inplace)
        assert torch.equal(inplace, cq.fake_quantize_plain(x, cfg))
    torch.cuda.synchronize()
    assert cq.LAUNCHES == {
        "encode_to_wire": 3, "decode_from_wire": 3, "fake_quantize_fused": 6,
        "encode_sr": 0, "fake_quantize_sr": 0, "encode_noise": 0, "fake_quantize_noise": 0,
        "absmax": 6,
    }


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1, 4, 5])
@pytest.mark.parametrize("n", [1, 7, 15, 17, 100_003])
def test_stochastic_kernels_equal_plain_versions_on_card(card, n, offset):
    """The _sr and _noise kernels against their plain versions on every
    wire; the _noise kernel fed the plain Philox field equals the _sr
    kernel; _sr on the slice ``x[o:]`` at offset ``o`` (unaligned for odd
    ``o``) equals the slice of the full draw."""
    key = (0x0BADC0DE, n)
    big = _grads(n + offset, card)
    x = big[offset:].clone()  # 16-byte aligned
    safe = tq.safe_divisor(x.abs().amax().reshape(1))
    u = philox.uniform(key, offset, n, device=card)
    cq.reset_launch_counts()
    for mode, wire in WIRES:
        cfg = CompressionConfig(mode=mode, rounding="stochastic")
        levels = float(tq.levels_for(cfg))
        q = cq.encode_to_wire(x, safe, cfg, wire, key=key, offset=offset)
        assert q.dtype == wire
        assert torch.equal(q, tq.encode_with_scale(x, safe, levels, wire, key=key, offset=offset))
        assert torch.equal(q, cq.encode_to_wire(x, safe, cfg, wire, noise=u))
        assert torch.equal(q, tq.encode_with_scale(x, safe, levels, wire, noise=u))
        q_big = cq.encode_to_wire(big, safe, cfg, wire, key=key)
        assert torch.equal(q, cq.encode_to_wire(big[offset:], safe, cfg, wire, key=key, offset=offset))
        assert torch.equal(q_big[offset:], q)
        f = cq.fake_quantize_fused(x, cfg, key=key, offset=offset)
        assert torch.equal(f, cq.fake_quantize_plain(x, cfg, key=key, offset=offset))
        assert torch.equal(f, cq.fake_quantize_fused(x, cfg, noise=u))
        assert torch.equal(f, cq.fake_quantize_plain(x, cfg, noise=u))
        inplace = x.clone()
        cq.fake_quantize_fused(inplace, cfg, out=inplace, key=key, offset=offset)
        assert torch.equal(inplace, f)
    torch.cuda.synchronize()
    assert cq.LAUNCHES == {
        "encode_to_wire": 0, "decode_from_wire": 0, "fake_quantize_fused": 0,
        "encode_sr": 9, "fake_quantize_sr": 6, "encode_noise": 3, "fake_quantize_noise": 3,
        "absmax": 9,
    }


# Around the decode and encode_sr kernels' edges.  Decode: a warp's tile
# is 512 wire bytes (512 int8 or 256 16-bit elements), a warp's pass 1024
# elements on every wire, a block's 8192.  encode_sr: four elements a
# counter, a warp's tile of 32 counters (128 elements), a pass of two tiles
# (256), a block's 2048.  And past one pass of the whole resident grid (at
# most 132 SMs x 8 blocks x 8192 elements for decode), so the grid-stride
# loops wrap.
EDGE_SIZES = [1, 3, 4, 5, 127, 128, 129, 255, 256, 257, 511, 512, 513, 1023, 1024, 1025,
              2047, 2048, 2049, 8191, 8192, 8193, 3 * 8192 + 1, 9_000_003]


@pytest.mark.gpu
@pytest.mark.parametrize("n", EDGE_SIZES)
def test_decode_at_tile_edges_and_any_alignment_on_card(card, n):
    """Decode equals its plain version bit for bit on every wire, for the
    wire buffer and the slice ``q[1:]`` (not 16-byte aligned), each into an
    aligned ``out`` and into the slice ``out[1:]``; one launch a call."""
    x = _grads(n + 1, card)
    scale = x.abs().amax().reshape(1)
    safe = tq.safe_divisor(scale)
    cq.reset_launch_counts()
    calls = 0
    for mode, wire in WIRES:
        cfg = CompressionConfig(mode=mode)
        inv = tq.true_div(scale, float(tq.levels_for(cfg)))
        q_all = cq.encode_to_wire(x, safe, cfg, wire)
        for lo in (0, 1):
            q = q_all[lo : lo + n]
            want = tq.decode_with_inv(q, inv)
            for out_lo in (0, 1):
                buf = torch.full((n + out_lo,), float("nan"), device=card)
                out = buf[out_lo:]
                assert cq.decode_from_wire(q, inv, out=out) is out
                calls += 1
                assert cq.LAUNCHES["decode_from_wire"] == calls
                assert torch.equal(out, want), (wire, lo, out_lo)
                if out_lo:
                    assert torch.isnan(buf[0]).item()
    torch.cuda.synchronize()
    assert cq.LAUNCHES["encode_to_wire"] == len(WIRES)


@pytest.mark.gpu
@pytest.mark.parametrize("n", EDGE_SIZES)
def test_encode_sr_at_tile_edges_and_any_offset_on_card(card, n):
    """encode_sr of ``x = big[o:o + n]`` at offset ``o`` (not 16-byte
    aligned for o = 1, 5) equals its plain version bit for bit on every
    wire, and equals the slice of the encode of ``big`` drawn from 0; one
    launch a call."""
    key = (0xC0FFEE, n)
    big = _grads(n + 5, card)
    safe = tq.safe_divisor(big.abs().amax().reshape(1))
    cq.reset_launch_counts()
    calls = 0
    for mode, wire in WIRES:
        cfg = CompressionConfig(mode=mode, rounding="stochastic")
        levels = float(tq.levels_for(cfg))
        full = cq.encode_to_wire(big, safe, cfg, wire, key=key)
        calls += 1
        assert torch.equal(full, tq.encode_with_scale(big, safe, levels, wire, key=key))
        for o in (0, 1, 4, 5):
            x = big[o : o + n]
            q = cq.encode_to_wire(x, safe, cfg, wire, key=key, offset=o)
            calls += 1
            assert cq.LAUNCHES["encode_sr"] == calls
            assert torch.equal(q, full[o : o + n]), (wire, o)
            assert torch.equal(q, tq.encode_with_scale(x, safe, levels, wire, key=key, offset=o))
    torch.cuda.synchronize()


def _plain_absmax(x: torch.Tensor) -> torch.Tensor:
    return x.abs().amax().reshape(1) if x.numel() else torch.zeros(1, device=x.device)


def _same_absmax(got: torch.Tensor, want: torch.Tensor) -> bool:
    """NaN by position (its payload may differ), anything else bit for bit
    (so -0.0 against +0.0 fails)."""
    if torch.isnan(want).item():
        return bool(torch.isnan(got).item())
    return torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [0, 1, 7, 15, 17, 100_003])
def test_absmax_equals_plain_version_on_card(card, n, offset):
    """ddlpc_absmax against ``x.abs().amax()`` on edge inputs: NaN, ±inf,
    -0.0, subnormals, the max in the first or the last element; on an
    aligned buffer and on the 4-byte aligned slice ``x[1:]``."""
    rng = np.random.default_rng(n)
    sub = (rng.integers(1, 0x007FFFFF, size=n + offset, dtype=np.uint32)
           | (rng.integers(0, 2, size=n + offset, dtype=np.uint32) << 31)).view(np.float32)
    variants = {"grads": _grads(n + offset, card),
                "neg_zero": torch.full((n + offset,), -0.0, device=card),
                "subnormals": torch.from_numpy(sub).to(card)}
    if n:
        for name, value, at in (("nan", float("nan"), n // 2), ("inf", float("inf"), n - 1),
                                ("neg_inf", float("-inf"), 0), ("max_first", -2.0, 0),
                                ("max_last", 2.0, n - 1)):
            big = _grads(n + offset, card)
            big[offset + at] = value
            variants[name] = big
    cq.reset_launch_counts()
    for name, big in variants.items():
        x = big[offset:]
        got = cq.absmax(x)
        torch.cuda.synchronize()
        assert got.shape == (1,) and got.dtype == torch.float32
        assert _same_absmax(got, _plain_absmax(x)), (name, got, _plain_absmax(x))
        assert _same_absmax(cq.absmax(x), got), name  # the counter was reset
    assert cq.LAUNCHES["absmax"] == 2 * len(variants)


@pytest.mark.gpu
def test_absmax_on_a_second_stream_on_card(card):
    """Each stream has its own scratch: launches in flight on two streams
    at once do not share a counter."""
    xs = [_grads(1_000_003, card) * (i + 1) for i in range(2)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        on_side = [cq.absmax(xs[1]) for _ in range(8)]
    on_main = [cq.absmax(xs[0]) for _ in range(8)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, _plain_absmax(xs[0])) for a in on_main)
    assert all(torch.equal(a, _plain_absmax(xs[1])) for a in on_side)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1, 4, 5])
@pytest.mark.parametrize("n", [1, 7, 17, 100_003])
def test_fake_quantize_kernels_at_any_alignment_on_card(card, n, offset):
    """Nearest and _sr fake-quantize (max-abs pass, then the kernel) on
    ``x = big[o:]`` (not 16-byte aligned for o = 1, 5; o is the Philox
    offset too) equal their plain versions bit for bit: out of place into a
    new buffer, into an unaligned one, and in place."""
    key = (0x5EED, n)
    big = _grads(n + offset, card)
    x = big[offset:]
    cq.reset_launch_counts()
    for mode in ("float16", "int8"):
        for rounding in ("nearest", "stochastic"):
            cfg = CompressionConfig(mode=mode, rounding=rounding)
            kw = {"key": key, "offset": offset} if rounding == "stochastic" else {}
            want = cq.fake_quantize_plain(x, cfg, **kw)
            assert torch.equal(cq.fake_quantize_fused(x, cfg, **kw), want), (mode, rounding)
            out = torch.empty(n + 3, device=card)[3:]
            cq.fake_quantize_fused(x, cfg, out=out, **kw)
            assert torch.equal(out, want), (mode, rounding)
            inplace = big.clone()[offset:]
            assert cq.fake_quantize_fused(inplace, cfg, out=inplace, **kw) is inplace
            assert torch.equal(inplace, want), (mode, rounding)
    torch.cuda.synchronize()
    assert cq.LAUNCHES == {
        "encode_to_wire": 0, "decode_from_wire": 0, "fake_quantize_fused": 6,
        "encode_sr": 0, "fake_quantize_sr": 6, "encode_noise": 0, "fake_quantize_noise": 0,
        "absmax": 12,
    }


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [3, 4, 8])
def test_fake_quantize_against_a_given_max_on_card(card, shards):
    """The zero2 mean stage: each 128-byte-aligned chunk of a buffer,
    quantized in place against a given max-abs that is not a power of two
    (``amax=``, no max-abs pass), equals the plain version against the same
    max (``step = amax · rn(1/levels)`` on both sides), nearest and
    stochastic from the chunk's offset."""
    n = 32 * 1031 * shards
    x = _grads(n, card)
    amax = (x.abs().amax() * 1.37).reshape(1)
    k = n // shards
    cq.reset_launch_counts()
    for mode, rounding in (("float16", "nearest"), ("int8", "nearest"), ("int8", "stochastic")):
        cfg = CompressionConfig(mode=mode, rounding=rounding)
        for r in range(shards):
            kw = {"key": (7, 9), "offset": r * k} if rounding == "stochastic" else {}
            chunk = x[r * k : (r + 1) * k].clone()
            want = cq.fake_quantize_plain(chunk, cfg, amax=amax, **kw)
            assert cq.fake_quantize_fused(chunk, cfg, out=chunk, amax=amax, **kw) is chunk
            assert torch.equal(chunk, want), (mode, rounding, r)
            assert torch.equal(want.cpu(), cq.fake_quantize_plain(
                x[r * k : (r + 1) * k].cpu(), cfg, amax=amax.cpu(), **kw)), (mode, rounding, r)
    torch.cuda.synchronize()
    assert cq.LAUNCHES["absmax"] == 0
    assert cq.LAUNCHES["fake_quantize_fused"] == 2 * shards
    assert cq.LAUNCHES["fake_quantize_sr"] == shards


@pytest.mark.gpu
@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
@pytest.mark.parametrize(
    "mode,local,mean",
    [("float16", True, True), ("int8", True, True), ("float16", False, True)],
)
def test_sync_on_card_equals_sync_on_cpu(card, mode, local, mean, rounding):
    """The N=1 sync through the kernels equals the CPU sync through the
    plain versions, bit for bit (with a step key when stochastic)."""
    cfg = CompressionConfig(
        mode=mode, quantize_local=local, quantize_mean=mean, rounding=rounding
    )
    key = philox.step_key(3, 17) if rounding == "stochastic" else None
    x = _grads(4099, "cpu")
    want = grad_sync.sync_gradients(x.clone(), cfg, key=key)
    got = grad_sync.sync_gradients(x.to(card), cfg, key=key)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_kernels_refuse_what_they_cannot_take_on_card(card):
    x = _grads(1024, card)
    f16 = CompressionConfig(mode="float16")
    safe = torch.ones(1, device=card)
    with pytest.raises(ValueError, match="aligned"):
        cq.encode_to_wire(x[1:], safe, f16, torch.float16)
    with pytest.raises(ValueError, match="1-element"):
        cq.encode_to_wire(x, torch.ones(1), f16, torch.float16)
    with pytest.raises(ValueError, match="stochastic"):
        cq.fake_quantize_fused(x, CompressionConfig(mode="float16", rounding="stochastic"))
    cq.reset_launch_counts()
    with pytest.raises(ValueError, match="aligned"):  # before the max-abs pass launches
        cq.fake_quantize_fused(x[1:], CompressionConfig(mode="float16", rounding="stochastic"),
                               noise=torch.zeros(1023, device=card))
    assert cq.LAUNCHES == {k: 0 for k in cq.LAUNCHES}
