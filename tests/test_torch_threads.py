"""The port's CPU tests on few intra-op threads (a helper: it holds no test).

The suite runs in several worker processes at once (``-n 6`` on eight
cores), beside the gloo worlds some tests start and JAX's own thread pool.
PyTorch's default intra-op pool, one OpenMP thread a core, then
oversubscribes the machine: each parallel region waits at its barrier for
all of its threads, so small ops cost milliseconds of waiting: a tiny
U-Net's steps (``tests/test_torch_resume.py``'s config) ran tens of times
slower on eight threads of a loaded host than on one, to the same losses.
Two threads a worker still oversubscribe six workers on eight cores, and
the JAX package's tests beside them slow down.

Each port test module holds ``one_intra_op_thread = intra_op_threads(1)``,
a module-scoped autouse fixture that runs its tests on one thread and
restores the previous count after them; the processes the tests start
are given ``OMP_NUM_THREADS`` for the same reason.  One module keeps two threads:
on one thread PyTorch sends a non-strided 1×1 convolution of fewer than 16
images to its native path instead of oneDNN, which rounds its sums
otherwise, and ``tests/test_torch_models_zoo_forward.py`` holds the fp32
forward to flax's within a tolerance taken on oneDNN's path.
"""

from __future__ import annotations

import pytest
import torch


def intra_op_threads(n: int):
    """A module-scoped autouse fixture: the module's tests on ``n``
    intra-op threads."""

    @pytest.fixture(scope="module", autouse=True)
    def fixture():
        before = torch.get_num_threads()
        torch.set_num_threads(n)
        yield
        torch.set_num_threads(before)

    return fixture
