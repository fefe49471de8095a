"""The port's partition rule engines (``ddlpc_tpu_torch/parallel/partition.py``)
and stage plans (``parallel/pipeline.py``) against the JAX package's, on the
full trees of the flagship's and the Cityscapes config's U-Nets as the
configs write them.

The port names its tensors by flax path (``convert.flax_from_torch``, the
kernels in flax's HWIO layout) and its optimizer state as optax's tree
(``convert.optax_tree``), so that every decision compares one to one:
name, shape, spec (JAX's ``PartitionSpec`` as a tuple), matching rule and
reason, leaf by leaf, exactly.  The stage plans' cuts, rule tables and
per-stage bytes are equal exactly.
"""

import os

import jax
import jax.numpy as jnp
import pytest
import torch

from ddlpc_tpu.config import ExperimentConfig as JExperimentConfig
from ddlpc_tpu.models import build_model as jbuild_model
from ddlpc_tpu.parallel import partition as jpartition
from ddlpc_tpu.parallel.pipeline import build_stage_plan as jbuild_stage_plan
from ddlpc_tpu.parallel.pipeline import stage_param_bytes as jstage_param_bytes
from ddlpc_tpu.train.optim import build_optimizer as jbuild_optimizer
from ddlpc_tpu_torch.config import ExperimentConfig, ModelConfig
from ddlpc_tpu_torch.convert import flax_from_torch, optax_tree
from ddlpc_tpu_torch.models import build_model
from ddlpc_tpu_torch.parallel import partition
from ddlpc_tpu_torch.parallel.pipeline import build_stage_plan, param_tree, stage_param_bytes
from ddlpc_tpu_torch.train.optim import build_optimizer

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
NAMES = ("vaihingen_unet_tpu_flagship.json", "cityscapes_unet_v5e64.json")
_TREES: dict = {}


def _trees(name: str):
    """``(jax_state_tree, port_state_tree, pshapes_jax, pshapes_port, jax
    model, jax params, port model)`` of one config."""
    if name in _TREES:
        return _TREES[name]
    with open(os.path.join(CONFIGS, name)) as f:
        text = f.read()
    jcfg, cfg = JExperimentConfig.from_json(text), ExperimentConfig.from_json(text)
    jmodel = jbuild_model(jcfg.model)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 128, 128, 3)),
                                                train=False))
    jparams = shapes["params"]
    jopt = jax.eval_shape(jbuild_optimizer(jcfg.train, total_steps=100).init, jparams)
    jtree = {"params": jparams, "grads": jparams, "opt_state": jopt}
    model = build_model(cfg.model)
    params, _, _ = flax_from_torch({k: v for k, v in model.state_dict().items()
                                    if "running" not in k})
    tx = build_optimizer(cfg.train, total_steps=100)
    core = {k: params for k in ("mu", "nu")}
    tree = {"params": params, "grads": params, "opt_state": optax_tree(tx.layout(), 0, core)}
    jps = frozenset(tuple(l.shape) for l in jax.tree.leaves(jparams))
    ps = frozenset(tuple(v.shape) for _, v in partition.leaves_with_path(params))
    _TREES[name] = (jtree, tree, jps, ps, jmodel, jparams, model)
    return _TREES[name]


def _jax_decisions(rules, tree, **kw):
    out = {}
    for d in jax.tree.leaves(jpartition.decide_tree(rules, tree, "", **kw),
                             is_leaf=lambda x: isinstance(x, jpartition.Decision)):
        out[d.name] = (d.shape, tuple(d.spec), d.rule, d.reason)
    return out


def _port_decisions(rules, tree, **kw):
    out = {}
    for _, d in partition.leaves_with_path(partition.decide_tree(rules, tree, "", **kw)):
        out[d.name] = (d.shape, d.spec, d.rule, d.reason)
    return out


@pytest.mark.parametrize("mode", ["leaf", "chunk"])
@pytest.mark.parametrize("level", ["replicated", "zero1", "zero2", "zero3"])
@pytest.mark.parametrize("name", NAMES)
def test_rule_decisions_equal_jax_leaf_by_leaf(name, level, mode):
    jtree, tree, jps, ps, *_ = _trees(name)
    assert jps == ps
    for n in (2, 4, 8):
        kw = dict(mode=mode, n_shards=n, data_axis="data")
        want = _jax_decisions(jpartition.state_partition_rules(level), jtree, pshapes=jps, **kw)
        got = _port_decisions(partition.state_partition_rules(level), tree, pshapes=ps, **kw)
        assert got == want
        assert ({k: v for k, v in got.items() if v[3] == partition.REASON_REPLICATED_BY_RULE}
                .keys() == {k for k, v in want.items()
                            if v[3] == jpartition.REASON_REPLICATED_BY_RULE})


@pytest.mark.parametrize("name", NAMES)
def test_even_shard_spec_picks_equal_jax(name):
    jtree, tree, *_ = _trees(name)
    shapes = {tuple(v.shape) for _, v in partition.leaves_with_path(tree["params"])}
    for shape in sorted(shapes):
        for n in (2, 3, 4, 8, 16, 64):
            assert partition.even_shard_spec(shape, n, "data") == tuple(
                jpartition.even_shard_spec(shape, n, "data")), (shape, n)


@pytest.mark.parametrize("n_stages", [2, 3, 4])
@pytest.mark.parametrize("name", NAMES)
def test_stage_plans_and_bytes_equal_jax(name, n_stages):
    *_, jmodel, jparams, model = _trees(name)
    want = jbuild_stage_plan(jmodel, jparams, n_stages)
    got = build_stage_plan(model, param_tree(model), n_stages)
    assert got.block_names == want.block_names
    assert got.assignment == want.assignment
    assert [(r.pattern, r.stage) for r in got.rules] == [(r.pattern, r.stage) for r in want.rules]
    assert stage_param_bytes(got, param_tree(model)) == jstage_param_bytes(want, jparams)


def test_replicated_by_rule_bytes_equal_jax():
    jtree, tree, jps, ps, *_ = _trees(NAMES[0])
    rules_j, rules = jpartition.state_partition_rules("zero3"), partition.state_partition_rules("zero3")
    kw = dict(mode="leaf", n_shards=64, data_axis="data")
    jd = jpartition.decide_tree(rules_j, jtree, "", pshapes=jps, **kw)
    d = partition.decide_tree(rules, tree, "", pshapes=ps, **kw)
    want = jpartition.replicated_by_rule_bytes(jd, jtree)
    assert want > 0
    assert partition.replicated_by_rule_bytes(d, tree) == want


def test_chunk_shard_and_gather_round_trip_on_port_tensors():
    """``make_shard_and_gather_fns`` in chunk mode on the port's torch
    tensors: ``[N, K]`` chunks and back, exactly."""
    model = build_model(ModelConfig(features=(8, 16)))
    tree = {"params": {k: v.detach() for k, v in model.state_dict().items()}}
    rules = partition.state_partition_rules("zero3")
    d = partition.decide_tree(rules, tree, "", mode="chunk", n_shards=3, data_axis="data")
    shard, gather = partition.make_shard_and_gather_fns(d, 3, "chunk")
    for (path, leaf), (_, f), (_, g) in zip(partition.leaves_with_path(tree),
                                            partition.leaves_with_path(shard),
                                            partition.leaves_with_path(gather)):
        chunks = f(leaf)
        assert chunks.shape == (3, -(-leaf.numel() // 3))
        torch.testing.assert_close(g(chunks), leaf, rtol=0, atol=0)
