"""ROADMAP C22, a documented deviation: the fp32 DeepLabV3+ forward's bits
depend on PyTorch's intra-op thread count, within the rounding of one
reordered sum.

On one thread PyTorch sends a non-strided 1×1 convolution of fewer than
16 images to its native path, on two to oneDNN; the two sum a channel
contraction in different orders.  Of the ``deeplab_os8`` variant's
train-mode forward (``tests/test_torch_models_zoo_forward.py``, flax's
weights, the same images), the first tensor whose bits differ between
one thread and two is the output of the ASPP image pool's 1×1 conv
(``ASPP_0.ConvNormAct_4.Conv_0``: 2 pooled images × 64 channels → 32),
whose inputs are equal.  Each of its elements is a sum of 64 products; the
two orders differ by at most 1.66 u·Σ|w·x| (u = 2⁻²⁴), each within
1.26 u·Σ|w·x| of the float64 sum, far inside the 2·63 u·Σ|w·x| that two
orders of a 64-term fp32 sum may differ by.  The image pool's BatchNorm
then normalizes over two samples a channel, which magnifies that
difference to the 7.3e-4 seen at the output: a deviation, not a fault.
So ``test_torch_models_zoo_forward.py`` keeps its tolerance and runs on
two threads, and this module pins the source on one.
"""

from __future__ import annotations

import numpy as np
import torch

from test_torch_models_zoo import _flax_variables, _images, _port_model
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

NAME = "deeplab_os8"
FIRST = "ASPP_0.ConvNormAct_4.Conv_0"
U = 2.0 ** -24


def _outputs(threads: int, params, stats, x):
    """Every named module's (input, output) of one train-mode forward on
    ``threads`` intra-op threads, in execution order."""
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        model = _port_model(NAME, "float32", params, stats)
        model.train(True)
        seen = []
        for n, m in model.named_modules():
            if n:
                m.register_forward_hook(
                    lambda mod, i, o, n=n: seen.append((n, mod, i[0].clone(), o.clone()))
                    if isinstance(o, torch.Tensor) else None)
        with torch.no_grad():
            model(x)
        return seen
    finally:
        torch.set_num_threads(before)


def test_the_first_bits_to_differ_across_thread_counts_are_the_image_pools_conv_sums():
    assert torch.get_num_threads() == 1
    _, params, stats = _flax_variables(NAME, "float32")
    x = torch.from_numpy(_images(NAME))
    one, two = _outputs(1, params, stats, x), _outputs(2, params, stats, x)
    assert [n for n, *_ in one] == [n for n, *_ in two]
    first = next(k for k, (a, b) in enumerate(zip(one, two)) if not torch.equal(a[3], b[3]))
    name, conv, x1, y1 = one[first]
    _, _, x2, y2 = two[first]
    assert name == FIRST and torch.equal(x1, x2)
    assert tuple(conv.weight.shape) == (32, 64, 1, 1) and tuple(x1.shape) == (2, 64, 1, 1)
    terms = x1.double()[:, None, :, 0, 0] * conv.weight.detach().double()[None, :, :, 0, 0]
    exact, mass = terms.sum(-1), terms.abs().sum(-1)
    a, b = y1.double()[..., 0, 0], y2.double()[..., 0, 0]
    cin = terms.shape[-1]
    # Each order within its (Cin − 1)·u·Σ|terms| of the float64 sum, so the
    # two within twice that; measured 1.26 and 1.66 u·Σ|terms|.
    assert ((a - exact).abs() <= (cin - 1) * U * mass).all()
    assert ((b - exact).abs() <= (cin - 1) * U * mass).all()
    assert ((a - b).abs() <= 2 * U * mass).all()
    assert int((y1 != y2).sum()) > 0
    np.testing.assert_array_equal(one[first - 1][3].numpy(), two[first - 1][3].numpy())
