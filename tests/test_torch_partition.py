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
import numpy as np
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
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

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


# ---------------------------------------------------------------------------
# the port's StateLayout: the rule table that places the ZeRO state


def _layout_inputs(name: str, n: int):
    """``(port StateLayout inputs, JAX state and optimizer)`` of one
    config at ``n`` replicas, from shapes alone (no buffer allocated)."""
    from types import SimpleNamespace

    from ddlpc_tpu_torch.convert import flax_param_path

    *_, jmodel, jparams, model = _trees(name)
    with open(os.path.join(CONFIGS, name)) as f:
        text = f.read()
    named = dict(model.named_parameters())
    names = sorted(named, key=lambda k: flax_param_path(k, named[k].dim()))
    flat = SimpleNamespace(names=names, shapes=[tuple(named[k].shape) for k in names], n_shards=n)
    tx = build_optimizer(ExperimentConfig.from_json(text).train, total_steps=100)
    jtx = jbuild_optimizer(JExperimentConfig.from_json(text).train, total_steps=100)
    return flat, tx, SimpleNamespace(params=jparams), jtx


def _jax_tree_decisions(tree) -> dict:
    return {d.name: (d.shape, tuple(d.spec), d.rule, d.reason)
            for d in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, jpartition.Decision))}


def _port_tree_decisions(tree) -> dict:
    return {d.name: (d.shape, d.spec, d.rule, d.reason) for _, d in partition.leaves_with_path(tree)}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("level", ["off", "zero1", "zero2", "zero3"])
@pytest.mark.parametrize("name", NAMES)
def test_state_layout_decisions_equal_jax(name, level, n):
    """The port's ``StateLayout`` over its flat buffer's leaves decides
    every param, gradient and optimizer leaf as JAX's ``StateLayout`` of
    the same level on a data mesh of ``n``: names, shapes, specs, rules and
    reasons; the same replicated-by-rule bytes; and the chunked kinds are
    the level's rung of the ladder."""
    from jax.sharding import Mesh

    from ddlpc_tpu.parallel import shard_update as jshard_update
    from ddlpc_tpu_torch.parallel.shard_update import StateLayout

    flat, tx, jstate, jtx = _layout_inputs(name, n)
    got = StateLayout.from_flat(flat, tx.layout(), level)
    mode = {"off": "replicated"}.get(level, level)
    want = jshard_update.StateLayout(mode, jtx, jstate, Mesh(jax.devices()[:n], ("data",)))
    for kind in ("param_decisions", "grad_decisions", "opt_decisions"):
        assert _port_tree_decisions(getattr(got, kind)) == _jax_tree_decisions(getattr(want, kind)), kind
    assert got.replicated_by_rule_bytes() == want.replicated_by_rule_bytes() == 0
    rung = {"off": (0, 0, 0), "zero1": (0, 0, 1), "zero2": (0, 1, 1), "zero3": (1, 1, 1)}[level]
    assert tuple(int(got.chunked[k]) for k in ("params", "grads", "opt_state")) == rung
    assert got.level == level and (want.chunk_params, want.level) == (
        level == "zero3", {"off": "replicated"}.get(level, level))


def test_state_layout_refuses_what_the_flat_layout_cannot_hold():
    from ddlpc_tpu_torch.parallel.shard_update import StateLayout

    flat, tx, *_ = _layout_inputs(NAMES[0], 4)
    Rule, SHARD = partition.Rule, partition.SHARD
    moments = Rule(r"^opt_state/(.*/)?(mu|nu|trace)(/|$)", SHARD)
    grads = Rule(r"^grads/", SHARD)
    # One kind split between sharded and whole leaves: named, with the rule.
    with pytest.raises(ValueError, match=r"params/DownBlock_0/.* is sharded by rule '\^params/Down'"):
        StateLayout.from_flat(flat, tx.layout(), "zero3",
                              rules=(Rule("^params/Down", SHARD), grads, moments, Rule(".*", ())))
    # Params chunked without the gradients: refused, naming both.
    with pytest.raises(ValueError, match=r"grads/.* is whole by rule '\.\*'"):
        StateLayout.from_flat(flat, tx.layout(), "zero3",
                              rules=(Rule("^params/", SHARD), moments, Rule(".*", ())))
    # A chunked optax count: refused.
    with pytest.raises(ValueError, match="opt_state/0/count is sharded"):
        StateLayout.from_flat(flat, tx.layout(), "zero1",
                              rules=(Rule("count$", ("data",)), moments, Rule(".*", ())))
    # A zero3 table that shards no params keeps them whole: never chunked.
    kept = StateLayout.from_flat(flat, tx.layout(), "zero3",
                                 rules=(grads, moments, Rule(".*", ())))
    assert kept.chunked == {"params": False, "grads": True, "opt_state": True}
    assert kept.level == "zero2"


def test_c21_replicated_by_rule_at_data4_space2():
    """ROADMAP C21: the Vaihingen U-Net (``vaihingen_unet_v5e8.json``) at
    data 4 × space 2, where both trainers resolve ``shard_update=auto`` to
    zero2.  JAX's GSPMD layout decides in leaf mode and keeps the moments
    of the 6-class head's bias whole (6 does not divide by 4): 48 bytes
    replicated by rule.  The port's flat layout chunks every moment and
    pads instead: 0 bytes replicated, and its buffer (Σ N·rows_b) holds
    ``n`` elements plus the padding pinned here."""
    from types import SimpleNamespace

    from jax.sharding import Mesh

    from ddlpc_tpu.parallel import shard_update as jshard_update
    from ddlpc_tpu_torch.parallel.shard_update import StateLayout, flat_layout

    with open(os.path.join(CONFIGS, "vaihingen_unet_v5e8.json")) as f:
        text = f.read()
    jcfg, cfg = JExperimentConfig.from_json(text), ExperimentConfig.from_json(text)
    jmodel = jbuild_model(jcfg.model)
    jparams = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 128, 128, 3)),
                                                 train=False))["params"]
    jtx = jbuild_optimizer(jcfg.train, total_steps=100)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "space"))
    want = jshard_update.StateLayout("gspmd_zero2", jtx, SimpleNamespace(params=jparams), mesh)
    assert want.replicated_by_rule_bytes() == 48
    whole = [n for n, v in _jax_tree_decisions(want.opt_decisions).items()
             if v[3] == jpartition.REASON_REPLICATED_BY_RULE]
    assert whole == ["opt_state/0/mu/DetailHead_0/Conv_1/bias", "opt_state/0/nu/DetailHead_0/Conv_1/bias"]
    model = build_model(cfg.model)
    named = dict(model.named_parameters())
    from ddlpc_tpu_torch.convert import flax_param_path

    names = sorted(named, key=lambda k: flax_param_path(k, named[k].dim()))
    flat = SimpleNamespace(names=names, shapes=[tuple(named[k].shape) for k in names], n_shards=4)
    got = StateLayout.from_flat(flat, build_optimizer(cfg.train, total_steps=100).layout(), "zero2")
    assert got.replicated_by_rule_bytes() == 0 and got.chunked["opt_state"]
    sizes = [named[k].numel() for k in names]
    _, _, total = flat_layout(sizes, 4, cfg.compression.bucket_mb)
    assert (sum(sizes), total - sum(sizes)) == (8_372_422, 58)


def test_trainer_publishes_the_replicated_by_rule_gauge(tmp_path):
    """The trainer publishes ``ddlpc_hbm_replicated_by_rule_bytes`` with
    JAX's name, from its state's placement."""
    import json

    from ddlpc_tpu_torch.train.__main__ import parse_args
    from ddlpc_tpu_torch.train.trainer import Trainer

    config = tmp_path / "tiny.json"
    config.write_text(json.dumps({
        "model": {"features": [8], "bottleneck_features": 8, "num_classes": 3,
                  "compute_dtype": "float32", "head_dtype": "float32"},
        "data": {"image_size": [32, 32], "synthetic_len": 12, "test_split": 4, "num_classes": 3},
        "train": {"epochs": 1, "micro_batch_size": 2, "sync_period": 2},
    }))
    cfg, _, device, _ = parse_args(["--config", str(config), "--device", "cpu",
                                    "--workdir", str(tmp_path / "run")])
    trainer = Trainer(cfg, resume=False, device=device)
    snap = trainer.registry.snapshot()
    assert snap["ddlpc_hbm_replicated_by_rule_bytes"] == trainer.state.placement.replicated_by_rule_bytes() == 0
    assert trainer.state.placement.level == "off"
