"""The four public helpers of the JAX package that the port gained last,
held against JAX's on seeded numpy inputs on the CPU:

- ``ops.metrics.pixel_accuracy`` (``ddlpc_tpu/ops/metrics.py:18``): exact
  ties count 1/#tied, ``ignore_index`` honoured.  Tolerance rtol 1e-6: the
  per-pixel values are the same fractions, the mean sums them in another
  order;
- ``ops.losses.softmax_cross_entropy`` and ``softmax_cross_entropy_sum``
  with ``label_smoothing`` (``ddlpc_tpu/ops/losses.py:100``): rtol 1e-6
  (float32 ``logsumexp`` and sums in another order); at smoothing 0 the
  sum is the port's previous formula bit for bit;
- ``utils.wire.pack_message`` / ``unpack_message``
  (``ddlpc_tpu/utils/wire.py:266-280``): bytes equal, truncation raises the
  same ``ValueError``;
- ``models.register`` (``ddlpc_tpu/models/__init__.py:28``): the decorator
  fills the registry, and the three registered names are JAX's.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddlpc_tpu.models import _REGISTRY as JAX_REGISTRY
from ddlpc_tpu.models import register as jax_register
from ddlpc_tpu.ops import losses as jlosses
from ddlpc_tpu.ops import metrics as jmetrics
from ddlpc_tpu.utils import wire as jwire
from ddlpc_tpu_torch import models
from ddlpc_tpu_torch.config import ModelConfig
from ddlpc_tpu_torch.ops import losses, metrics
from ddlpc_tpu_torch.utils import wire
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse


def _inputs(seed: int, void: bool, ties: bool):
    """Logits [2, 16, 16, 6] and labels in [0, 6) (−1 for some pixels
    where ``void``); ``ties`` rounds the logits onto a coarse grid, so that
    many rows hold exact ties at their max."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(2, 16, 16, 6)).astype(np.float32)
    if ties:
        logits = np.round(logits * 2) / 2
    labels = rng.integers(0, 6, (2, 16, 16)).astype(np.int32)
    if void:
        labels[rng.uniform(size=labels.shape) < 0.2] = -1
    return logits, labels


CASES = [(0, False, False), (1, True, False), (2, False, True), (3, True, True)]


@pytest.mark.parametrize("seed,void,ties", CASES)
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_pixel_accuracy_matches_jax(seed, void, ties, ignore_index):
    logits, labels = _inputs(seed, void, ties)
    want = float(jmetrics.pixel_accuracy(jnp.asarray(logits), jnp.asarray(labels), ignore_index))
    got = metrics.pixel_accuracy(torch.from_numpy(logits), torch.from_numpy(labels), ignore_index)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    if ties:  # the case the 1/#tied rule exists for
        assert (logits == logits.max(-1, keepdims=True)).sum(-1).max() > 1


def test_pixel_accuracy_counts_a_tie_as_its_share():
    logits = torch.tensor([[[1.0, 1.0, 0.0], [2.0, 0.0, 2.0], [0.0, 3.0, 1.0]]])
    labels = torch.tensor([[0, 1, 1]])
    assert float(metrics.pixel_accuracy(logits, labels)) == pytest.approx((0.5 + 0 + 1) / 3)
    assert float(metrics.pixel_accuracy(logits, torch.tensor([[0, -1, -1]]), -1)) == 0.5


@pytest.mark.parametrize("seed,void,ties", CASES)
@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_softmax_cross_entropy_matches_jax(seed, void, ties, label_smoothing, ignore_index):
    logits, labels = _inputs(seed, void, ties)
    jl, jy = jnp.asarray(logits), jnp.asarray(labels)
    tl, ty = torch.from_numpy(logits), torch.from_numpy(labels)
    want = float(jlosses.softmax_cross_entropy(jl, jy, ignore_index, label_smoothing))
    got = losses.softmax_cross_entropy(tl, ty, ignore_index, label_smoothing)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    want_sum, want_count = jlosses.softmax_cross_entropy_sum(jl, jy, ignore_index, label_smoothing)
    got_sum, got_count = losses.softmax_cross_entropy_sum(tl, ty, ignore_index, label_smoothing)
    np.testing.assert_allclose(float(got_sum), float(want_sum), rtol=1e-6)
    assert float(got_count) == float(want_count)


def test_softmax_cross_entropy_sum_without_smoothing_is_unchanged():
    """The eval path's sum: the formula the port had before the argument,
    bit for bit."""
    logits, labels = _inputs(5, True, False)
    tl, ty = torch.from_numpy(logits), torch.from_numpy(labels)
    lf = tl.float()
    picked = lf.gather(-1, ty.clamp(0, 5).long().unsqueeze(-1)).squeeze(-1)
    nll = torch.logsumexp(lf, dim=-1) - picked
    valid = (ty != -1).float()
    got_sum, got_count = losses.softmax_cross_entropy_sum(tl, ty, -1)
    assert torch.equal(got_sum, (nll * valid).sum()) and torch.equal(got_count, valid.sum())


@pytest.mark.parametrize("size", [0, 1, 5, 4096, 70_001])
def test_pack_message_bytes_equal_jax_and_round_trip(size):
    payload = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    framed = wire.pack_message(payload)
    assert framed == jwire.pack_message(payload)
    rest = b"\x07tail"
    assert wire.unpack_message(framed + rest) == jwire.unpack_message(framed + rest) == (
        payload, rest)


@pytest.mark.parametrize("cut", [0, 3, 4, 9])
def test_unpack_message_raises_on_truncation_as_jax(cut):
    framed = wire.pack_message(b"0123456789")[:cut]
    with pytest.raises(ValueError) as want:
        jwire.unpack_message(framed)
    with pytest.raises(ValueError) as got:
        wire.unpack_message(framed)
    assert str(got.value) == str(want.value)


def test_register_fills_the_registry_as_jax():
    assert set(models._REGISTRY) == set(JAX_REGISTRY) == {"unet", "unetpp", "deeplabv3p"}

    def toy(cfg, *common):
        return models._REGISTRY["unet"](cfg, *common)

    for reg, registry in ((models.register, models._REGISTRY), (jax_register, JAX_REGISTRY)):
        assert reg("toy_unet")(toy) is toy
        try:
            assert registry["toy_unet"] is toy
        finally:
            del registry["toy_unet"]
    # A registered builder is what build_model builds.
    models.register("toy_unet")(toy)
    try:
        cfg = dict(features=(8, 16), bottleneck_features=16)
        a = models.build_model(ModelConfig(name="toy_unet", **cfg), seed=3)
        b = models.build_model(ModelConfig(name="unet", **cfg), seed=3)
        assert [(k, v.shape) for k, v in a.state_dict().items()] == [
            (k, v.shape) for k, v in b.state_dict().items()]
        assert all(torch.equal(a.state_dict()[k], b.state_dict()[k]) for k in b.state_dict())
    finally:
        del models._REGISTRY["toy_unet"]
