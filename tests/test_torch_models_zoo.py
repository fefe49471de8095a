"""The port's U-Net++, DeepLabV3+ and the U-Net's other options against the
JAX package's, on the CPU.

The layers first: flax's stride-2 'SAME' conv and 3×3/2 'SAME' max pool
(ROADMAP C3: torch's ``padding=1`` pads the top and left where flax pads
the bottom and right on an even grid), dilated convs, GroupNorm, the
bilinear resize, ``StemGridDetailHead`` and ``group_labels``.  Then every
new model option's forward in train and eval mode from the same seeded
weights (``test_torch_model.flax_like_variables``, carried over with
``convert.py``) on seeded numpy images, the loss on stacked and grouped
logits, the parameter paths and the conversion round trip, and the three
committed configs' conv FLOPs a step as integers.

Tolerances, each with its reason:

- the stride-2 conv, the max pool, bf16 GroupNorm and the bf16 bilinear
  resize at power-of-two scales: exact (the same products, summed in one
  order; the resize contracts one dimension at a time, rounding after
  each, in the order JAX's einsum picks);
- dilated convs, fp32 GroupNorm, ``StemGridDetailHead``: rtol = atol =
  1e-5 (another summation order); the fp32 resize: atol 1e-6 (JAX
  contracts each dimension in a dot, torch interpolates);
- models in fp32: rtol = atol = 1e-5, except where a forward normalizes
  with the batch's own statistics (train mode, and GroupNorm in either
  mode) in many layers: each takes them as E[x²]−E[x]², as flax does, and
  magnifies the convolutions' summation-order differences by its
  cancellation, which compounds over up to 31 normalized layers
  (DeepLabV3+).  The measured need (|Δ| / (1 + |ref|): 2.3e-5 … 9.9e-5)
  and an allowance of about 3× it stand in ``FP32_TOL``.  The same
  models in float64 (``jax.enable_x64``) agree to rtol = atol = 1e-10,
  which holds the arithmetic itself, wherever both packages compute in
  float64; to rtol = atol = 1e-6 where both take a step in float32: the
  heads' ensemble mean (U-Net++'s eval readout, the ensemble-scope
  refinement's input) and, in eval mode, BatchNorm's ``rsqrt(var + ε)``
  of the float32 running variance, which the two round an ulp apart;
- models in bf16, eval mode: max |Δ| ≤ 5e-2 · max |ref|, the rule of
  ``tests/test_torch_model.py``; U-Net++ in train mode too (DeepLabV3+'s
  31 batch-normalized layers reach 0.066 · max |ref| in bf16 train mode,
  outside that rule: it is held in fp32 and float64 instead);
- weights: exact (the conversion permutes and flips).
"""

import functools
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from ddlpc_tpu.config import ExperimentConfig as JExperimentConfig
from ddlpc_tpu.config import ModelConfig as JModelConfig
from ddlpc_tpu.models import build_model as jbuild_model
from ddlpc_tpu.models import layers as jlayers
from ddlpc_tpu.obs import flops as jflops
from ddlpc_tpu.parallel import train_step as jts
from ddlpc_tpu_torch.config import ExperimentConfig, ModelConfig
from ddlpc_tpu_torch.convert import flax_from_torch, torch_state_from_flax
from ddlpc_tpu_torch.models import build_model, layers
from ddlpc_tpu_torch.obs import flops
from ddlpc_tpu_torch.parallel.train_step import loss_from_logits
from test_torch_model import flax_like_variables
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PP = dict(name="unetpp", features=(8, 16, 32))
S2D = dict(stem="s2d", stem_factor=2)
DEEPLAB = dict(name="deeplabv3p", features=(64, 128, 256, 512), width_divisor=8)
# name: (model config, tile size)
VARIANTS = {
    "unetpp_deep_supervision": (dict(PP, deep_supervision=True), 32),
    "unetpp_one_head": (dict(PP, deep_supervision=False), 32),
    "unetpp_s2d": (dict(PP, deep_supervision=True, **S2D), 32),
    "unetpp_fullres_per_head": (dict(PP, deep_supervision=True, detail_head=True, **S2D), 32),
    "unetpp_fullres_ensemble": (dict(PP, deep_supervision=True, detail_head=True,
                                     detail_head_scope="ensemble", **S2D), 32),
    "unetpp_s2d_head_per_head": (dict(PP, deep_supervision=True, detail_head=True,
                                      detail_head_kind="s2d", **S2D), 32),
    "unetpp_s2d_head_ensemble_grouped": (dict(PP, deep_supervision=True, detail_head=True,
                                              detail_head_kind="s2d",
                                              detail_head_scope="ensemble",
                                              train_head_layout="grouped", **S2D), 32),
    "unetpp_grouped": (dict(PP, deep_supervision=True, train_head_layout="grouped", **S2D), 32),
    "unetpp_one_head_grouped_s2d_head": (dict(PP, deep_supervision=False, detail_head=True,
                                              detail_head_kind="s2d",
                                              train_head_layout="grouped", **S2D), 32),
    "unetpp_bilinear_group": (dict(PP, deep_supervision=True, up_sample_mode="bilinear",
                                   norm="group", group_norm_groups=3), 32),
    "unetpp_none": (dict(PP, deep_supervision=True, norm="none"), 32),
    "deeplab_os16": (DEEPLAB, 64),
    "deeplab_os8": (dict(DEEPLAB, output_stride=8, aspp_rates=(2, 4, 6)), 64),
    "deeplab_group": (dict(DEEPLAB, norm="group"), 64),
    "unet_bilinear": (dict(features=(8, 16), bottleneck_features=16,
                           up_sample_mode="bilinear"), 32),
    "unet_group": (dict(features=(8, 16), bottleneck_features=16, norm="group",
                        group_norm_groups=3), 32),
    "unet_none": (dict(features=(8, 16), bottleneck_features=16, norm="none"), 32),
    "unet_grouped_s2d_head": (dict(features=(8, 16), bottleneck_features=16, detail_head=True,
                                   detail_head_kind="s2d", train_head_layout="grouped",
                                   **S2D), 32),
}
# fp32 allowances (rtol = atol) where 1e-5 does not hold, by (variant,
# mode) (module docstring); every other case is held to 1e-5.
FP32_TOL = {
    ("unetpp_deep_supervision", "train"): 1e-4,
    ("unetpp_one_head", "train"): 1e-4,
    ("unet_bilinear", "train"): 1e-4,
    ("deeplab_os16", "train"): 3e-4,
    ("deeplab_os8", "train"): 3e-4,
    ("deeplab_group", "train"): 5e-5,
    ("deeplab_group", "eval"): 5e-5,
}
# float64 variants whose output passes through the float32 ensemble mean.
F32_MEAN = ("unetpp_fullres_ensemble", "unetpp_s2d_head_ensemble_grouped")
CONFIGS = [  # the committed configs and JAX's conv FLOPs a step, exact
    ("vaihingen_unetpp.json", 12_480_638_091_264),
    ("vaihingen_unetpp_s2d.json", 3_246_995_275_776),
    ("potsdam_deeplabv3p.json", 7_940_345_954_304),
]


def _nchw(x: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).to(dtype)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------------------
# layers


@pytest.mark.parametrize("size", [8, 9, 10])
def test_stride2_same_conv_equals_flax_and_padding_1_does_not_on_even_grids(size):
    """C3: flax pads a 3×3 stride-2 'SAME' conv on an even grid at the
    bottom and right only; torch's ``padding=1`` pads the top and left
    too and differs.  On an odd grid both pad one each side."""
    rng = np.random.default_rng(size)
    x = rng.normal(size=(2, size, size, 5)).astype(np.float32)
    k = rng.normal(size=(3, 3, 5, 7)).astype(np.float32)
    ref = np.asarray(fnn.Conv(7, (3, 3), strides=(2, 2), padding="SAME", use_bias=False)
                     .apply({"params": {"kernel": k}}, x))
    conv = layers.Conv(5, 7, 3, torch.float32, use_bias=False, stride=2)
    conv.weight.data = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    with torch.no_grad():
        np.testing.assert_array_equal(_nhwc(conv(_nchw(x))), ref)
        old = _nhwc(F.conv2d(_nchw(x), conv.weight, stride=2, padding=1))
    assert old.shape == ref.shape
    if size % 2:
        np.testing.assert_array_equal(old, ref)
    else:
        assert np.abs(old - ref).max() > 1.0


@pytest.mark.parametrize("size,stride,dilation", [(9, 1, 2), (8, 1, 3), (10, 2, 2), (7, 2, 1)])
def test_dilated_and_strided_same_conv_match_flax(size, stride, dilation):
    rng = np.random.default_rng(size + dilation)
    x = rng.normal(size=(2, size, size, 5)).astype(np.float32)
    k = rng.normal(size=(3, 3, 5, 7)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    ref = np.asarray(fnn.Conv(7, (3, 3), strides=(stride, stride),
                              kernel_dilation=(dilation, dilation), padding="SAME")
                     .apply({"params": {"kernel": k, "bias": b}}, x))
    conv = layers.Conv(5, 7, 3, torch.float32, stride=stride, dilation=dilation)
    conv.weight.data = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    conv.bias.data = torch.from_numpy(b)
    with torch.no_grad():
        np.testing.assert_allclose(_nhwc(conv(_nchw(x))), ref, rtol=1e-5, atol=1e-5)


def test_strided_1x1_conv_trains_on_channels_last_input():
    """DeepLabV3+'s projection shortcut, a 1×1 stride-2 conv, sees a
    channels-last input (the model permutes NHWC images).  PyTorch's CPU
    (oneDNN) backward of that conv corrupted the heap (an abort or a
    segfault within a few hundred steps, torch 2.13): the port convolves
    the subsampled grid instead.  Run apart, so a crash fails this test
    alone, and against flax's strided conv."""
    import subprocess
    import sys
    import textwrap

    script = textwrap.dedent("""
        import torch
        from ddlpc_tpu_torch.models import layers
        conv = layers.Conv(8, 16, 1, torch.float32, use_bias=False, stride=2)
        for _ in range(300):
            x = torch.rand(2, 16, 16, 8, requires_grad=True)
            y = conv(x.permute(0, 3, 1, 2))
            (y * torch.rand_like(y)).sum().backward()
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       timeout=120, cwd=REPO)
    assert r.returncode == 0 and "ok" in r.stdout, (r.returncode, r.stderr[-2000:])
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 10, 8)).astype(np.float32)
    k = rng.normal(size=(1, 1, 8, 16)).astype(np.float32)
    ref = np.asarray(fnn.Conv(16, (1, 1), strides=(2, 2), use_bias=False)
                     .apply({"params": {"kernel": k}}, x))
    conv = layers.Conv(8, 16, 1, torch.float32, use_bias=False, stride=2)
    conv.weight.data = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    with torch.no_grad():
        np.testing.assert_allclose(_nhwc(conv(torch.from_numpy(x).permute(0, 3, 1, 2))), ref,
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_max_pool_same_equals_flax_and_padding_1_does_not_on_even_grids(size, dtype):
    """C3 for the DeepLab stem's 3×3/2 pool: flax pads −inf at the bottom
    and right of an even grid."""
    x = np.random.default_rng(size).normal(size=(2, size, size, 5)).astype(np.float32)
    ref = np.asarray(fnn.max_pool(jnp.asarray(x).astype(dtype), (3, 3), strides=(2, 2),
                                  padding="SAME").astype(jnp.float32))
    tx = _nchw(x, getattr(torch, dtype))
    np.testing.assert_array_equal(_nhwc(layers.max_pool_same(tx, 3, 2)), ref)
    old = _nhwc(F.max_pool2d(tx, 3, 2, padding=1))
    if size % 2:
        np.testing.assert_array_equal(old, ref)
    else:
        assert (old != ref).any()


@pytest.mark.parametrize("channels,groups,want_groups", [(16, 8, 8), (12, 8, 6), (5, 8, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_matches_flax(channels, groups, want_groups, dtype):
    """flax ``GroupNorm`` (ε 1e-6, float32 statistics for bf16 input) with
    the group count lowered until it divides C."""
    rng = np.random.default_rng(channels)
    x = (rng.normal(size=(2, 6, 6, channels)) * 3 + 1).astype(np.float32)
    jnorm = jlayers.Norm(kind="group", groups=groups, dtype=jnp.dtype(dtype))
    scale = (1 + 0.1 * rng.normal(size=channels)).astype(np.float32)
    bias = (0.1 * rng.normal(size=channels)).astype(np.float32)
    ref = np.asarray(jnorm.apply({"params": {"GroupNorm_0": {"scale": scale, "bias": bias}}},
                                 jnp.asarray(x).astype(dtype), train=True).astype(jnp.float32))
    norm = layers.Norm(channels, "group", groups)
    assert norm.GroupNorm_0.groups == want_groups
    norm.GroupNorm_0.weight.data = torch.from_numpy(scale)
    norm.GroupNorm_0.bias.data = torch.from_numpy(bias)
    with torch.no_grad():
        out = norm(_nchw(x, getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_nhwc(out), ref)
    else:
        np.testing.assert_allclose(_nhwc(out), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw,out_hw", [((8, 8), (16, 16)), ((8, 8), (32, 32)),
                                       ((4, 6), (16, 24)), ((6, 4), (24, 16)),
                                       ((4, 6), (8, 24)), ((5, 5), (5, 20))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bilinear_resize_matches_jax_image_resize(hw, out_hw, dtype):
    x = np.random.default_rng(0).normal(size=(2, *hw, 5)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x).astype(dtype), (2, *out_hw, 5),
                                      method="bilinear").astype(jnp.float32))
    out = layers.resize_bilinear(_nchw(x, getattr(torch, dtype)), out_hw)
    assert out.dtype == getattr(torch, dtype)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_nhwc(out), ref)
    else:
        np.testing.assert_allclose(_nhwc(out), ref, rtol=0, atol=1e-6)
    if out_hw == (2 * hw[0], 2 * hw[1]):
        np.testing.assert_array_equal(_nhwc(layers.upsample_2x(_nchw(x, getattr(torch, dtype)))),
                                      _nhwc(out))


def test_bilinear_resize_refuses_to_down_sample():
    with pytest.raises(ValueError, match="down-samples"):
        layers.resize_bilinear(torch.zeros(1, 2, 8, 8), (4, 16))


@pytest.mark.parametrize("r", [2, 4])
def test_stem_grid_detail_head_and_group_labels_match_flax(r):
    rng = np.random.default_rng(r)
    classes, hidden = 3, 8
    z = rng.normal(size=(2, 4, 4, classes * r * r)).astype(np.float32)
    image = rng.uniform(size=(2, 4 * r, 4 * r, 3)).astype(np.float32)
    jhead = jlayers.StemGridDetailHead(classes, r, hidden=hidden, dtype=jnp.float32,
                                       head_dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jhead.init(jax.random.key(r), z, image)["params"])
    params = jax.tree.map(lambda a: (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32),
                          params)
    ref = np.asarray(jhead.apply({"params": params}, z, image))
    head = layers.StemGridDetailHead(classes, 3, r, hidden, torch.float32, torch.float32)
    head.load_state_dict(torch_state_from_flax(params, {})[0], strict=True)
    with torch.no_grad():
        out = head(_nchw(z), _nchw(image))
    np.testing.assert_allclose(_nhwc(out), ref, rtol=1e-5, atol=1e-5)
    labels = rng.integers(-1, classes, (2, 3, 4 * r, 8 * r)).astype(np.int32)
    want = np.asarray(jlayers.group_labels(jnp.asarray(labels), r))
    got = layers.group_labels(torch.from_numpy(labels), r).numpy()
    assert got.shape == want.shape == (2, 3, 4, 8, r * r)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# models


@functools.lru_cache(maxsize=None)
def _flax_variables(name: str, dtype: str):
    kw, _ = VARIANTS[name]
    jmodel = jbuild_model(JModelConfig(**kw, compute_dtype=dtype, head_dtype=dtype))
    variables = flax_like_variables(jmodel)
    params = jax.tree.map(np.asarray, variables["params"])
    # Non-trivial running statistics, so eval mode really tests the mapping.
    rng = np.random.default_rng(7)
    stats = jax.tree.map(lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32),
                         dict(variables.get("batch_stats", {})))
    return jmodel, params, stats


def _port_model(name: str, dtype: str, params, stats):
    kw, _ = VARIANTS[name]
    model = build_model(ModelConfig(**kw, compute_dtype=dtype, head_dtype=dtype))
    model.load_state_dict(torch_state_from_flax(params, stats)[0], strict=True)
    return model


def _images(name: str, n: int = 2, seed: int = 1) -> np.ndarray:
    size = VARIANTS[name][1]
    return np.random.default_rng(seed).uniform(0, 1, (n, size, size, 3)).astype(np.float32)


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _forward_both(name: str, dtype: str, train: bool):
    """(flax out, port out, flax stats after, port stats after) — the
    stats only in train mode."""
    jmodel, params, stats = _flax_variables(name, dtype)
    model = _port_model(name, dtype, params, stats)
    x = _images(name)
    variables = {"params": params, "batch_stats": stats}
    if train:
        ref, upd = jax.jit(lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"]))(
            variables, x)
    else:
        ref, upd = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, x), None
    model.train(train)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    got_stats = _flat(flax_from_torch(model.state_dict())[1]) if train else None
    want_stats = _flat(upd.get("batch_stats", {})) if train else None
    return np.asarray(ref), out, want_stats, got_stats


@pytest.mark.parametrize("name", list(VARIANTS))
def test_param_paths_equal_flax_and_round_trip_exactly(name):
    """The port's own module names are flax's paths (no conversion table),
    so weights and DWC2 checkpoints cross packages."""
    kw, _ = VARIANTS[name]
    jmodel = jbuild_model(JModelConfig(**kw))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                                                 train=False))
    params, stats = flax_from_torch(build_model(ModelConfig(**kw)).state_dict())[:2]
    want_p, want_s = (
        {"/".join(k.key for k in path): leaf.shape
         for path, leaf in jax.tree_util.tree_leaves_with_path(shapes.get(c, {}))}
        for c in ("params", "batch_stats")
    )
    got_p, got_s = _flat(params), _flat(stats)
    assert got_p.keys() == want_p.keys()
    assert got_s.keys() == want_s.keys()
    for k in want_p:
        assert got_p[k].shape == want_p[k], k
    _, jparams, jstats = _flax_variables(name, "float32")
    sd, _ = torch_state_from_flax(jparams, jstats)
    p2, s2, _ = flax_from_torch(sd)
    for a, b in ((_flat(jparams), _flat(p2)), (_flat(jstats), _flat(s2))):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_build_model_refusals_follow_jax():
    cases = [
        dict(name="vgg"),
        dict(name="deeplabv3p", detail_head=True),
        dict(name="deeplabv3p", stem="s2d", train_head_layout="grouped"),
        dict(name="unetpp", train_head_layout="grouped"),
        dict(name="unetpp", stem="s2d", detail_head=True, train_head_layout="grouped"),
        dict(name="unetpp", detail_head_scope="all"),
    ]
    for kw in cases:
        with pytest.raises(ValueError) as want:
            jbuild_model(JModelConfig(**kw))
        with pytest.raises(ValueError) as got:
            build_model(ModelConfig(**kw))
        assert str(got.value) == str(want.value), kw


# ---------------------------------------------------------------------------
# the loss


@pytest.mark.parametrize("shape,layout", [
    ((2, 8, 8, 6), "fullres"),          # one head
    ((3, 2, 8, 8, 6), "fullres"),       # a deep-supervision stack
    ((2, 4, 4, 24), "grouped"),         # pre-d2s, r = 2
    ((3, 2, 2, 2, 96), "grouped"),      # a grouped stack, r = 4
])
def test_loss_from_logits_on_stacked_and_grouped_logits_matches_jax(shape, layout):
    rng = np.random.default_rng(len(shape))
    logits = (rng.normal(size=shape) * 2).astype(np.float32)
    labels = rng.integers(-1, 6, (2, 8, 8)).astype(np.int32)
    model = SimpleNamespace(train_head_layout=layout)
    jloss, jacc = jts.loss_from_logits(model, jnp.asarray(logits), jnp.asarray(labels), True)
    loss, acc = loss_from_logits(torch.from_numpy(logits), torch.from_numpy(labels).long(), layout)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(float(acc), float(jacc), rtol=1e-6)
    assert 0.0 <= float(acc) <= 1.0


def test_loss_from_logits_refuses_undeclared_regrouping():
    logits, labels = torch.zeros(2, 4, 4, 24), torch.zeros(2, 8, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="refusing to reinterpret"):
        loss_from_logits(logits, labels)
    with pytest.raises(ValueError, match="not an integer r×r"):
        loss_from_logits(torch.zeros(2, 3, 3, 24), labels, "grouped")


# ---------------------------------------------------------------------------
# conv FLOPs


@pytest.mark.parametrize("name", ["unetpp_s2d_head_ensemble_grouped", "unetpp_bilinear_group",
                                  "unetpp_fullres_per_head", "deeplab_os16", "deeplab_os8",
                                  "unet_none"])
def test_conv_step_flops_equal_jax_on_tiny_models(name):
    """JAX's FLOP model traces the plain full-resolution loss, which a
    grouped train output does not fit (it raises there, and the JAX
    trainer logs MFU 0): the layout moves no conv, so a grouped model is
    held to JAX's count of the same model with the full-resolution
    layout."""
    kw, size = VARIANTS[name]
    d = {"model": {k: list(v) if isinstance(v, tuple) else v for k, v in kw.items()},
         "data": {"image_size": [size, size]}}
    port = ExperimentConfig.from_dict(d)
    d["model"]["train_head_layout"] = "fullres"
    want = jflops.conv_step_flops(JExperimentConfig.from_dict(d), 2, 3)
    assert flops.conv_step_flops(port, 2, 3) == want


@pytest.mark.parametrize("config,want", CONFIGS)
def test_conv_step_flops_of_the_committed_configs(config, want):
    """From the port's meta-device forward; the integer JAX's jaxpr walk
    gives for the same config (strided, dilated and 1×1-grid convs)."""
    with open(os.path.join(REPO, "configs", config)) as f:
        port = ExperimentConfig.from_dict(json.load(f))
    t = port.train
    assert flops.conv_step_flops(port, t.micro_batch_size, t.sync_period) == want
