"""The port's max-abs pass (``cuda_quantize.absmax``) against the JAX
package's ``global_absmax`` (``ddlpc_tpu/ops/quantize.py:119``), on the CPU.

The same numpy inputs (seeded) go through JAX's ``global_absmax`` on the
one-leaf tree and through the port's wrapper on a CPU tensor, which runs
the wrapper's plain version (the CUDA kernel ``ddlpc_absmax`` is held
against the same plain version on the card by
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``).

Comparison: a NaN result by position only (a NaN anywhere makes the result
NaN; its payload may differ between implementations), every other result
bit for bit, so ``-0.0`` against ``+0.0`` would fail.  Two inputs have no
JAX answer to compare with, and the test names its reference for each:

- an empty buffer: ``jnp.max`` over no elements raises, so the reference is
  ``global_absmax`` of the empty tree, 0;
- subnormals only: XLA's CPU backend flushes them to zero in the max (as a
  TPU does), while ``torch.amax`` keeps them on both devices; the reference
  is numpy's exact max.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddlpc_tpu.ops import quantize as jq
from ddlpc_tpu_torch.ops import cuda_quantize as cq
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

_TINY = np.float32(np.finfo(np.float32).tiny)  # the smallest normal float32


def _normal(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n,)).astype(np.float32) * 0.05


def _with(x: np.ndarray, seed: int, *values) -> np.ndarray:
    """``x`` with ``values`` at distinct random positions."""
    rng = np.random.default_rng(seed)
    x = x.copy()
    x[rng.choice(x.size, size=len(values), replace=False)] = values
    return x


def _subnormals(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    bits = rng.integers(1, 0x007FFFFF, size=n, dtype=np.uint32)
    bits |= rng.integers(0, 2, size=n, dtype=np.uint32) << 31  # either sign
    return bits.view(np.float32)


CASES = {
    "nan": lambda: _with(_normal(1000, 1), 11, np.nan),
    "nan_and_inf": lambda: _with(_normal(1000, 2), 12, np.nan, np.inf, -np.inf),
    "pos_inf": lambda: _with(_normal(1000, 3), 13, np.inf),
    "neg_inf": lambda: _with(_normal(1000, 4), 14, -np.inf),
    "neg_zero": lambda: np.full(33, -0.0, np.float32),
    "zeros": lambda: np.zeros(33, np.float32),
    "negative_max": lambda: _with(_normal(1000, 5), 15, np.float32(-3.5)),
    "subnormals_beside_normals": lambda: np.concatenate(
        [_subnormals(500, 6), np.float32(2.0) * _TINY * np.ones(1, np.float32), _subnormals(17, 7)]
    ),
    "n1": lambda: np.array([-0.25], np.float32),
    "n7": lambda: _normal(7, 8),
    "n100003": lambda: _normal(100_003, 9),
}


def _assert_same(port: torch.Tensor, ref) -> None:
    assert port.shape == (1,) and port.dtype == torch.float32 and port.device.type == "cpu"
    got = port.numpy()
    want = np.asarray(ref, dtype=np.float32).reshape(1)
    if np.isnan(want[0]):
        assert np.isnan(got[0]), got  # by position: the payload may differ
    else:
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_absmax_on_cpu_equals_jax_global_absmax(case):
    x = CASES[case]()
    ref = jq.global_absmax([jnp.asarray(x)])
    _assert_same(cq.absmax(torch.from_numpy(x.copy())), ref)


def test_absmax_of_an_empty_buffer_is_zero():
    """JAX has no max-abs of one empty leaf (``jnp.max`` over nothing
    raises); the port's is that of the empty tree, +0, as the kernel's is."""
    with pytest.raises(ValueError):
        jq.global_absmax([jnp.zeros((0,), jnp.float32)])
    _assert_same(cq.absmax(torch.zeros(0)), jq.global_absmax([]))


def test_absmax_keeps_subnormals():
    """Only subnormals: the port's max is numpy's exact one, as
    ``torch.amax`` keeps subnormals on the card too; JAX on XLA's CPU
    backend either agrees or has flushed the max to 0."""
    x = _subnormals(1001, 10)
    exact = np.abs(x).max()
    assert 0 < exact < _TINY
    _assert_same(cq.absmax(torch.from_numpy(x.copy())), exact)
    assert float(jq.global_absmax([jnp.asarray(x)])) in (0.0, float(exact))


def test_absmax_refuses_what_the_kernel_cannot_take():
    x = torch.randn(64)
    with pytest.raises(TypeError, match="float32"):
        cq.absmax(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        cq.absmax(x[::2])
    with pytest.raises(ValueError, match="unsupported device"):
        cq.absmax(x.to("meta"))
    cq.reset_launch_counts()
    cq.absmax(x)  # the CPU path launches nothing
    assert cq.LAUNCHES["absmax"] == 0
