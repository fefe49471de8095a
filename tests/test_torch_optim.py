"""The port's optimizers and schedules (``ddlpc_tpu_torch/train/optim.py``)
against the JAX package's ``build_optimizer`` and ``build_schedule`` run
as eager optax, on the CPU.

- The schedules' values equal optax's, fp32 bit for bit, at every count of
  several horizons: ``constant`` with warmup, and ``cosine`` with and
  without warmup (its cosine is the C library's ``cosf``, which is what
  XLA's CPU backend computes; numpy's and PyTorch's fp32 cosines are not).
- Adam with weight decay (L2 before Adam), AdamW (decoupled), SGD with
  momentum 0.9 (with and without a ``weight_decay``, which the JAX package
  does not apply to SGD), under either schedule, give the params and every
  state leaf of eager optax bit for bit over 5 steps on a tree of several
  leaves laid out flat in flatten order.
- ``grad_clip_norm``: when the global norm stays under the threshold the
  clip is the identity and the steps are bit for bit.  When it clips, the
  norm is summed per leaf in flatten order as optax sums it, but within a
  leaf PyTorch and XLA add in other orders: the norm is held within 2 ulp
  of optax's, and the params within 2e-6 relative, or 1e-5·lr a step
  absolute, of eager optax's over 5 clipped steps (an ulp of the norm
  scales the clipped gradient by 1 ± 6e-8; Adam's step passes that on to
  the small moments through its ``eps``).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flax import serialization

from ddlpc_tpu.config import TrainConfig as JTrainConfig
from ddlpc_tpu.train.optim import build_optimizer as jbuild_optimizer
from ddlpc_tpu.train.optim import build_schedule as jbuild_schedule
from ddlpc_tpu_torch.config import TrainConfig
from ddlpc_tpu_torch.convert import optax_core, optax_tree
from ddlpc_tpu_torch.train.optim import build_optimizer, build_schedule
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

SHAPES = {"a": (3, 3, 4, 8), "b": (8,), "c": (1031,), "d": (7, 13)}
TOTAL = 10
LR = 2e-2


def _tree(rng, scale=1.0):
    return {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(tree[k]).reshape(-1) for k in sorted(tree)])


def _segments():
    out, o = [], 0
    for k in sorted(SHAPES):
        n = int(np.prod(SHAPES[k]))
        out.append((o, n))
        o += n
    return out


@pytest.mark.parametrize("kw,total", [
    (dict(warmup_steps=3), None),
    (dict(warmup_steps=7), None),
    (dict(lr_schedule="cosine"), 10),
    (dict(lr_schedule="cosine", warmup_steps=1), 3),
    (dict(lr_schedule="cosine", warmup_steps=4), 97),
    (dict(lr_schedule="cosine", warmup_steps=50), 12),
    (dict(lr_schedule="cosine", warmup_steps=2), 1234),
])
def test_schedules_equal_optax_at_every_count(kw, total):
    cfg = dict(learning_rate=3e-3, **kw)
    want = jbuild_schedule(JTrainConfig(**cfg), total)
    got = build_schedule(TrainConfig(**cfg), total)
    for count in range((total or 10) + 3):
        w = np.float32(want(jnp.int32(count)))
        g = np.float32(got(count))
        assert g.tobytes() == w.tobytes(), (count, g, w)


OPTIMIZERS = {
    "adam_l2": dict(weight_decay=1e-2),
    "adamw": dict(optimizer="adamw", weight_decay=1e-2),
    "adamw_cosine": dict(optimizer="adamw", weight_decay=1e-4, lr_schedule="cosine", warmup_steps=1),
    "adam_warmup": dict(warmup_steps=3),
    "adam_l2_cosine": dict(weight_decay=1e-3, lr_schedule="cosine", warmup_steps=2),
    "sgd": dict(optimizer="sgd"),
    "sgd_cosine_wd": dict(optimizer="sgd", lr_schedule="cosine", weight_decay=1e-2),
    "sgd_warmup": dict(optimizer="sgd", warmup_steps=2),
    "adam_clip_idle": dict(grad_clip_norm=1e6),
    "adamw_clip_idle": dict(optimizer="adamw", weight_decay=1e-2, grad_clip_norm=1e6),
}
CLIPPED = {
    "adam_clip": dict(grad_clip_norm=0.5),
    "adamw_cosine_clip": dict(optimizer="adamw", weight_decay=1e-4, lr_schedule="cosine",
                              warmup_steps=1, grad_clip_norm=1.0),
    "sgd_clip": dict(optimizer="sgd", grad_clip_norm=0.5),
}


def _run(kw, steps=5):
    """Eager optax and the port on the same params and gradients: the
    params and the per-param state after each step."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng, 0.1 * (s + 1)) for s in range(steps)]
    cfg = dict(learning_rate=LR, **kw)
    jtx = jbuild_optimizer(JTrainConfig(**cfg), total_steps=TOTAL)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jtx.init(jp)
    ttx = build_optimizer(TrainConfig(**cfg), total_steps=TOTAL)
    tp = torch.from_numpy(_flat(params))
    ts = ttx.init(tp)
    out = []
    for g in grads:
        u, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, u)
        ttx.update(torch.from_numpy(_flat(g)), ts, tp, segments=_segments())
        out.append((jp, js, tp.clone(), ({k: v.clone() for k, v in ts.buffers().items()}, ts.count)))
    return out, ttx


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_equals_eager_optax_bit_for_bit(name):
    steps, ttx = _run(OPTIMIZERS[name])
    for s, (jp, js, tp, (buffers, count)) in enumerate(steps):
        np.testing.assert_array_equal(tp.numpy(), _flat(jp), err_msg=f"{name} step {s}")
        # optax's state read through the port's layout of it.
        core = optax_core(ttx.layout(), serialization.to_state_dict(js))
        assert sorted(k for k in core if k != "count") == sorted(buffers)
        for key, buf in buffers.items():
            np.testing.assert_array_equal(buf.numpy(), _flat(core[key]), err_msg=f"{name} {key}")
        if "count" in core:
            assert int(core["count"]) == count == s + 1


@pytest.mark.parametrize("name", sorted(CLIPPED))
def test_clipped_steps_equal_optax_to_the_norm_bound(name):
    kw = CLIPPED[name]
    rng = np.random.default_rng(0)
    _tree(rng)
    g = _tree(rng, 0.1)
    jnorm = np.float32(optax.global_norm({k: jnp.asarray(v) for k, v in g.items()}))
    ttx = build_optimizer(TrainConfig(learning_rate=LR, **kw), total_steps=TOTAL)
    tnorm = np.float32(ttx.global_norm(torch.from_numpy(_flat(g)), _segments()))
    assert jnorm > kw["grad_clip_norm"]  # it clips
    assert abs(int(tnorm.view(np.int32)) - int(jnorm.view(np.int32))) <= 2
    steps, _ = _run(kw)
    for s, (jp, _, tp, _) in enumerate(steps):
        np.testing.assert_allclose(tp.numpy(), _flat(jp), rtol=2e-6, atol=(s + 1) * 1e-5 * LR)


def test_optax_state_layouts_are_the_jax_chains():
    """``Optimizer.layout`` names the nesting of optax's state that the JAX
    package's ``build_optimizer`` builds, for every combination."""
    params = {"a": jnp.zeros((2, 3))}
    core = {"mu": {"a": 1}, "nu": {"a": 2}, "trace": {"a": 3}}
    for opt, sched, warm, wd, clip in itertools.product(
        ("adam", "adamw", "sgd"), ("constant", "cosine"), (0, 2), (0.0, 1e-4), (0.0, 1.0)
    ):
        cfg = dict(optimizer=opt, lr_schedule=sched, warmup_steps=warm, weight_decay=wd,
                   grad_clip_norm=clip)
        jstate = serialization.to_state_dict(jbuild_optimizer(JTrainConfig(**cfg), 10).init(params))
        got = optax_tree(build_optimizer(TrainConfig(**cfg), 10).layout(), 0, core)

        def shape(t):
            if isinstance(t, dict):
                return {k: shape(v) for k, v in t.items()}
            return "leaf"

        assert shape(got) == shape(jstate), cfg
