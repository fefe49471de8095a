"""The forward of every new model option in the port against the JAX
package's, on the CPU: fp32 in train and eval mode, bf16, and the output
shapes (float64: ``tests/test_torch_models_zoo_x64.py``).  The variants, the weights and the tolerances with
their reasons are those of ``tests/test_torch_models_zoo.py``.
"""

import numpy as np
import pytest
import torch

from ddlpc_tpu_torch.config import ModelConfig
from ddlpc_tpu_torch.models import build_model
from test_torch_models_zoo import FP32_TOL, VARIANTS, _forward_both, _images
from test_torch_threads import intra_op_threads

# Two threads keep PyTorch's 1x1 convolutions on oneDNN, whose rounding the
# fp32 tolerances below were taken on (tests/test_torch_threads.py).
two_intra_op_threads = intra_op_threads(2)  # autouse


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_fp32_matches_flax(name, train):
    ref, out, want_stats, got_stats = _forward_both(name, "float32", train)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    tol = FP32_TOL.get((name, "train" if train else "eval"), 1e-5)
    np.testing.assert_allclose(out.numpy(), ref, rtol=tol, atol=tol)
    if train:
        assert want_stats.keys() == got_stats.keys()
        for k in want_stats:
            np.testing.assert_allclose(got_stats[k], want_stats[k], rtol=tol, atol=tol, err_msg=k)


def test_forward_shapes_follow_the_reference():
    """Deep supervision stacks J heads in train mode (one more under the
    ensemble scope); the grouped layout returns pre-d2s logits."""
    want = {
        "unetpp_deep_supervision": (2, 2, 32, 32, 6),
        "unetpp_one_head": (2, 32, 32, 6),
        "unetpp_fullres_ensemble": (3, 2, 32, 32, 6),
        "unetpp_s2d_head_ensemble_grouped": (3, 2, 16, 16, 24),
        "unetpp_grouped": (2, 2, 16, 16, 24),
        "unetpp_one_head_grouped_s2d_head": (2, 16, 16, 24),
        "unet_grouped_s2d_head": (2, 16, 16, 24),
        "deeplab_os16": (2, 64, 64, 6),
    }
    for name, shape in want.items():
        model = build_model(ModelConfig(**VARIANTS[name][0], compute_dtype="float32"))
        with torch.no_grad():
            model.train()
            assert tuple(model(torch.from_numpy(_images(name))).shape) == shape, name
            model.eval()
            size = VARIANTS[name][1]
            assert tuple(model(torch.from_numpy(_images(name))).shape) == (2, size, size, 6)


@pytest.mark.parametrize("name,train", [
    ("unetpp_s2d", False), ("unetpp_s2d", True), ("unetpp_grouped", True),
    ("deeplab_os16", False), ("deeplab_os8", False),
])
def test_forward_bf16_matches_flax_within_bf16_rounding(name, train):
    ref, out, _, _ = _forward_both(name, "bfloat16", train)
    assert tuple(out.shape) == ref.shape
    ref = ref.astype(np.float32)
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= 5e-2 * np.abs(ref).max(), (err, np.abs(ref).max())
