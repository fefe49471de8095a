"""The port's U-Net, loss and metrics against the JAX package's, on the CPU.

A tiny U-Net (features (8, 16), width_divisor 1, s2d stem ×2, DetailHead,
32² tiles) gets seeded numpy variables in its flax layout, carried over to
the port with ``ddlpc_tpu_torch.convert``, and both run on the same seeded
numpy images.
Tolerances, each with its reason:

- fp32 compute: logits and BatchNorm statistics at rtol/atol 1e-5 — the
  same operations, summed in another order by XLA and by PyTorch;
- bf16 compute and head (the flagship's dtypes): max |Δlogit| ≤ 5e-2 ·
  max |logit| — bf16 keeps 8 bits of mantissa (relative step 2⁻⁸ ≈ 4e-3)
  and the two frameworks round at different points inside each conv, which
  compounds over the ten conv layers;
- the weight conversion round trip: exact (it only permutes and flips).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddlpc_tpu.config import ModelConfig as JModelConfig
from ddlpc_tpu.models import build_model as jbuild_model
from ddlpc_tpu.ops import losses as jlosses
from ddlpc_tpu.ops import metrics as jmetrics
from ddlpc_tpu_torch.config import ModelConfig
from ddlpc_tpu_torch.convert import flax_from_torch, torch_state_from_flax
from ddlpc_tpu_torch.models import build_model
from ddlpc_tpu_torch.ops import losses as tlosses
from ddlpc_tpu_torch.ops import metrics as tmetrics
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

TINY = dict(
    features=(8, 16), bottleneck_features=16, width_divisor=1, stem="s2d",
    stem_factor=2, detail_head=True, num_classes=6,
)


def flax_like_variables(jmodel, seed: int = 0) -> dict:
    """Variables in the shapes of ``jmodel``'s flax init, with seeded numpy
    values: kernels N(0, 1/fan_in), biases and BatchNorm scales drawn
    around flax's defaults (so the conversion of each is exercised), running
    statistics at mean 0 / var 1.  ``jax.eval_shape`` only traces the init;
    compiling it costs each test file seconds."""
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False)
    )
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        shape, name = leaf.shape, path[-1].key
        if name == "kernel":
            value = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            value = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "bias":
            value = 0.1 * rng.normal(size=shape)
        elif name == "mean":
            value = np.zeros(shape)
        elif name == "var":
            value = np.ones(shape)
        else:
            raise KeyError(name)
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def _flax_variables(dtype: str):
    jmodel = jbuild_model(JModelConfig(**TINY, compute_dtype=dtype, head_dtype=dtype))
    return jmodel, flax_like_variables(jmodel)


def _models(dtype: str):
    kw = dict(TINY, compute_dtype=dtype, head_dtype=dtype)
    jmodel, variables = _flax_variables(dtype)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    # Non-trivial running statistics, so eval mode really tests the mapping.
    rng = np.random.default_rng(7)
    stats = jax.tree.map(
        lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32), stats
    )
    tmodel = build_model(ModelConfig(**kw))
    sd, _ = torch_state_from_flax(params, stats)
    tmodel.load_state_dict(sd, strict=True)
    return jmodel, params, stats, tmodel


def _images(n=3, seed=1):
    return np.random.default_rng(seed).uniform(0, 1, (n, 32, 32, 3)).astype(np.float32)


def _flat_stats(stats):
    return {
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_leaves_with_path(stats)
    }


@pytest.mark.parametrize("train", [False, True])
def test_forward_fp32_matches_flax(train):
    jmodel, params, stats, tmodel = _models("float32")
    x = _images()
    # Under jit, as everywhere here: eager flax apply costs seconds.
    if train:
        ref, upd = jax.jit(lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"]))(
            {"params": params, "batch_stats": stats}, x
        )
    else:
        ref = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
            {"params": params, "batch_stats": stats}, x
        )
    tmodel.train(train)
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x))
    assert out.shape == (3, 32, 32, 6) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    if train:
        # BatchNorm running statistics after one train-mode forward: flax's
        # momentum 0.9 on the old value and the biased batch variance.
        _, jstats, _ = flax_from_torch(tmodel.state_dict())
        want = _flat_stats(upd["batch_stats"])
        got = _flat_stats(jstats)
        assert want.keys() == got.keys() and len(want) == 2 * 10
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_forward_bf16_matches_flax_within_bf16_rounding():
    jmodel, params, stats, tmodel = _models("bfloat16")
    x = _images()
    ref = np.asarray(
        jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
            {"params": params, "batch_stats": stats}, x
        )
    ).astype(np.float32)
    tmodel.eval()
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= 5e-2 * np.abs(ref).max(), (err, np.abs(ref).max())


def test_conversion_round_trip_is_exact():
    _, params, stats, tmodel = _models("float32")
    rng = np.random.default_rng(3)
    opt = {
        "count": np.int32(5),
        "mu": jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), params),
        "nu": jax.tree.map(lambda a: rng.uniform(size=a.shape).astype(np.float32), params),
    }
    sd, adam = torch_state_from_flax(params, stats, opt)
    # Layouts: conv OIHW, transposed conv (in, out, kh, kw) flipped.
    assert tuple(sd["DownBlock_0.DoubleConv_0.ConvNormAct_0.Conv_0.weight"].shape) == (8, 12, 3, 3)
    jt = params["UpBlock_0"]["ConvTranspose_0"]["kernel"]
    tt = sd["UpBlock_0.ConvTranspose_0.weight"].numpy()
    np.testing.assert_array_equal(tt[:, :, 0, 0], jt[1, 1])
    p2, s2, o2 = flax_from_torch(sd, adam)
    for a, b in ((params, p2), (stats, s2), (opt["mu"], o2["mu"]), (opt["nu"], o2["nu"])):
        la, ta = jax.tree_util.tree_flatten(a)
        lb, tb = jax.tree_util.tree_flatten(b)
        assert ta == tb
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
    assert int(o2["count"]) == 5
    # Every torch parameter and buffer is covered by the conversion.
    assert set(sd) == set(tmodel.state_dict())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nll_correct_valid_matches_jax(dtype):
    """Per-pixel NLL, tie-corrected correctness and validity, with voids
    and (in bf16, after coarse rounding) exact ties."""
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 8, 8, 6)) * 2).astype(np.float32)
    logits[0] = np.round(logits[0])  # many exact ties
    labels = rng.integers(-1, 6, (3, 8, 8)).astype(np.int32)
    jl = jnp.asarray(logits).astype(dtype)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    jn, jc, jv = jlosses.nll_correct_valid(jl, jnp.asarray(labels), ignore_index=-1)
    tn, tc, tv = tlosses.nll_correct_valid(tl, torch.from_numpy(labels).long(), ignore_index=-1)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert float(tc.min()) < 1.0 and (0 < tc.numpy()).any() and (tc.numpy() < 1).any()
    js, jcount = jlosses.softmax_cross_entropy_sum(jl, jnp.asarray(labels), ignore_index=-1)
    ts, tcount = tlosses.softmax_cross_entropy_sum(tl, torch.from_numpy(labels).long(), ignore_index=-1)
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
    assert float(tcount) == float(jcount)
    # Everything void.
    _, _, v = tlosses.nll_correct_valid(torch.zeros(2, 4, 4, 3), torch.full((2, 4, 4), -1))
    assert float(v.sum()) == 32.0
    _, _, v = tlosses.nll_correct_valid(
        torch.zeros(2, 4, 4, 3), torch.full((2, 4, 4), -1), ignore_index=-1
    )
    assert float(v.sum()) == 0.0


def test_confusion_and_mean_iou_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 16, 16, 6)).astype(np.float32)
    labels = rng.integers(-1, 5, (2, 16, 16)).astype(np.int32)  # class 5 absent
    jcm = jmetrics.confusion_from_logits(jnp.asarray(logits), jnp.asarray(labels), 6)
    tcm = tmetrics.confusion_from_logits(torch.from_numpy(logits), torch.from_numpy(labels), 6)
    np.testing.assert_array_equal(tcm.numpy(), np.asarray(jcm))
    for present_only in (True, False):
        np.testing.assert_allclose(
            float(tmetrics.mean_iou(tcm, present_only)),
            float(jmetrics.mean_iou(jcm, present_only)), rtol=1e-6,
        )
    np.testing.assert_allclose(
        tmetrics.iou_per_class(tcm).numpy(), np.asarray(jmetrics.iou_per_class(jcm)), rtol=1e-6
    )
    np.testing.assert_allclose(
        float(tmetrics.accuracy_from_confusion(tcm)),
        float(jmetrics.accuracy_from_confusion(jcm)), rtol=1e-6,
    )
    empty = torch.zeros(6, 6)
    assert float(tmetrics.mean_iou(empty)) == 0.0


def test_build_model_validation():
    with pytest.raises(ValueError, match="unknown model"):
        build_model(ModelConfig(name="vgg"))
    with pytest.raises(ValueError, match="requires stem='s2d'"):
        build_model(ModelConfig(detail_head=True, detail_head_kind="s2d", stem="none"))
    # DeepLabV3+ has no detail head: JAX's refusal, word for word.
    with pytest.raises(ValueError) as want:
        jbuild_model(JModelConfig(name="deeplabv3p", detail_head=True))
    with pytest.raises(ValueError) as got:
        build_model(ModelConfig(name="deeplabv3p", detail_head=True))
    assert str(got.value) == str(want.value)
    model = build_model(ModelConfig(**TINY))
    with pytest.raises(ValueError, match="too small"):
        model(torch.zeros(1, 4, 4, 3))
