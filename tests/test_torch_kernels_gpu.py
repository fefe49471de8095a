"""The gradient-codec CUDA kernels against their plain versions, on a card.

These tests need a CUDA card and ``nvcc`` (the kernels have no CPU mode)
and skip without one.  The file imports nothing of JAX, so it runs on a
machine that has only PyTorch; ``tests/conftest.py`` sets up JAX, so pass
``--noconftest`` there::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_gpu.py

Tolerance: none.  Each kernel does the plain version's IEEE operations in
the same order, so the outputs are compared with ``torch.equal``.
"""

import numpy as np
import pytest
import torch

from ddlpc_tpu_torch.config import CompressionConfig
from ddlpc_tpu_torch.ops import cuda_quantize as cq
from ddlpc_tpu_torch.ops import quantize as tq
from ddlpc_tpu_torch.parallel import grad_sync

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
    }


@pytest.mark.gpu
@pytest.mark.parametrize(
    "mode,local,mean",
    [("float16", True, True), ("int8", True, True), ("float16", False, True)],
)
def test_sync_on_card_equals_sync_on_cpu(card, mode, local, mean):
    """The N=1 sync through the kernels equals the CPU sync through the
    plain versions, bit for bit."""
    cfg = CompressionConfig(mode=mode, quantize_local=local, quantize_mean=mean)
    x = _grads(4099, "cpu")
    want = grad_sync.sync_gradients(x.clone(), cfg)
    got = grad_sync.sync_gradients(x.to(card), cfg)
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
    with pytest.raises(NotImplementedError, match="stochastic"):
        cq.fake_quantize_fused(x, CompressionConfig(mode="float16", rounding="stochastic"))
