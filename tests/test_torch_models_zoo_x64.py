"""The forward of every new model option in the port against the JAX
package's with float64 compute (JAX in x64 mode), on the CPU, in train and
eval mode: the arithmetic without fp32's cancellation.  The variants, the
weights and the tolerances with their reasons are those of
``tests/test_torch_models_zoo.py``.
"""

import jax
import numpy as np
import pytest

from test_torch_models_zoo import F32_MEAN, VARIANTS, _forward_both
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_float64_matches_flax(name, train):
    """The same arithmetic, without fp32's cancellation: JAX in x64 mode,
    the port with ``compute_dtype='float64'``."""
    with jax.enable_x64(True):
        ref, out, _, _ = _forward_both(name, "float64", train)
    assert tuple(out.shape) == ref.shape and str(out.dtype).endswith(str(ref.dtype))
    batch_norm = VARIANTS[name][0].get("norm", "batch") == "batch"
    float32_part = ref.dtype == np.float32 or (not train and (name in F32_MEAN or batch_norm))
    tol = 1e-6 if float32_part else 1e-10
    np.testing.assert_allclose(out.numpy(), ref, rtol=tol, atol=tol)
