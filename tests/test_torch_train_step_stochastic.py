"""Two optimizer steps of the tiny U-Net with int8 stochastic rounding, in
the port against the JAX package (the harness and the tolerances' reasons
are in ``test_torch_train_step.py``; the noise is held bit for bit as set
out in ``test_torch_stochastic.py``).  This case lives in its own file so
that each file's JAX compile stays short.

JAX's step draws from ``_rounding_rng(seed, step)`` → split → ``fold_in``
of the replica → one key per leaf → ``uniform``; the port's one
noise-drawing function, ``philox.uniform``, is made to return those fields
(laid out in the port's parameter order and layout) for the keys the
port's own schedule asks for, so both sides round with the same noise.
The tolerances are the fp16 case's: where the two sides' gradients
straddle a rounding boundary they snap to neighbouring lattice points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from jax.sharding import Mesh

from ddlpc_tpu.config import CompressionConfig as JCompression
from ddlpc_tpu.config import ModelConfig as JModelConfig
from ddlpc_tpu.models import build_model as jbuild_model
from ddlpc_tpu.parallel import train_step as jts
from ddlpc_tpu_torch.config import CompressionConfig, ModelConfig, TrainConfig
from ddlpc_tpu_torch.convert import flax_from_torch, torch_state_from_flax
from ddlpc_tpu_torch.models import build_model
from ddlpc_tpu_torch.ops import philox
from ddlpc_tpu_torch.parallel.train_step import create_train_state, make_train_step
from ddlpc_tpu_torch.train.optim import build_optimizer
from test_torch_model import flax_like_variables
from test_torch_stochastic import _jax_stage_keys
from test_torch_train_step import LR, TINY, _batches, _close, _flat, _params_agree
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

SEED = 5


def test_two_steps_int8_stochastic_match_jax(monkeypatch):
    images, labels = _batches()
    jmodel = jbuild_model(JModelConfig(**TINY))
    tx = optax.adam(LR)
    variables = flax_like_variables(jmodel)
    params0, stats0 = variables["params"], variables["batch_stats"]
    jstate = jts.TrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree.map(jnp.asarray, params0),
        batch_stats=jax.tree.map(jnp.asarray, stats0),
        opt_state=tx.init(jax.tree.map(jnp.asarray, params0)),
    )
    jcomp = JCompression(mode="int8", rounding="stochastic", codec_backend="xla")
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jstep = jts.make_train_step(jmodel, tx, mesh, jcomp, donate_state=False, seed=SEED)
    leaves, treedef = jax.tree_util.tree_flatten(jstate.params)

    tmodel = build_model(ModelConfig(**TINY))
    sd, _ = torch_state_from_flax(params0, stats0)
    tmodel.load_state_dict(sd, strict=True)
    ttx = build_optimizer(TrainConfig(learning_rate=LR))
    state = create_train_state(tmodel, ttx)

    fields = {}
    for step in range(2):
        rng = jts._rounding_rng(jcomp, SEED, jnp.int32(step))
        for stage, k in zip(("local", "mean"), _jax_stage_keys(rng)):
            keys = jax.random.split(k, len(leaves))
            u_tree = jax.tree_util.tree_unflatten(
                treedef, [np.asarray(jax.random.uniform(kk, l.shape)) for kk, l in zip(keys, leaves)]
            )
            usd, _ = torch_state_from_flax(u_tree, {})
            fields[philox.rounding_key(SEED, step, stage)] = torch.cat(
                [usd[name].reshape(-1) for name in state.params.names]
            )
    asked = []

    def jax_fields(key, offset, n, device=None):
        asked.append(key)
        return fields[key][offset : offset + n]

    monkeypatch.setattr(philox, "uniform", jax_fields)
    tstep = make_train_step(ttx, CompressionConfig(mode="int8", rounding="stochastic"), seed=SEED)
    jlosses, tlosses = [], []
    for x, y in zip(images, labels):
        jstate, m = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        jlosses.append(float(m["loss"]))
        tlosses.append(float(tstep(state, torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)))["loss"]))
    assert asked == list(fields)  # local then mean, step 0 then step 1

    p, s, _ = flax_from_torch(tmodel.state_dict())
    jout = {"params": _flat(jstate.params), "batch_stats": _flat(jstate.batch_stats)}
    tout = {"params": _flat(p), "batch_stats": _flat(s)}
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    _close(jout["batch_stats"], tout["batch_stats"], 1e-4, 1e-6)
    _params_agree(jout, tout, max_share=2e-2)
