"""The JAX package's own partition and pipeline-plan tests, run on the port.

The tests of ``tests/test_partition.py`` and the backend-free ones of
``tests/test_pipeline.py`` (the bubble model, the balanced assignment, the
anchored stage rules) run here unchanged, with every name they use taken
from the port: the module's globals are rebound (the pattern of
``tests/test_torch_obs_jax_tests.py``).  The port's specs are tuples, which
compare equal to JAX's ``PartitionSpec`` of the same axes.

Not run: ``test_zero_leaf_spec_delegates_to_rule_engine`` (it pins JAX's
``shard_update.zero_leaf_spec``, which has no counterpart: the port's ZeRO
layouts chunk flat buffers), and every ``tests/test_halo.py`` and the rest
of ``tests/test_pipeline.py``, whose bodies build ``shard_map`` programs
on JAX meshes — ``tests/test_torch_halo.py``, ``tests/test_torch_spatial.py``
and ``tests/test_torch_pipeline.py`` hold their counterparts on the port.
"""

import inspect
import types

import pytest

import test_partition as jpartition_tests
import test_pipeline as jpipeline_tests
from ddlpc_tpu.parallel import partition as jpartition
from ddlpc_tpu_torch.parallel import partition as tpartition
from ddlpc_tpu_torch.parallel import pipeline as tpipeline
from ddlpc_tpu_torch.parallel import shard_update as tshard_update
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

PORT_NAMES = {
    "partition": tpartition,
    "zero": tshard_update,
    "bubble_fraction": tpipeline.bubble_fraction,
    **{name: getattr(tpartition, name) for name in (
        "Decision", "REASON_AUTO", "REASON_NOT_PARAM_SHAPED", "REASON_REPLICATED_BY_RULE",
        "REASON_RULE", "Rule", "SHARD", "decide", "decide_tree", "even_shard_spec",
        "make_shard_and_gather_fns", "match_partition_rules", "named_leaves",
        "replicated_by_rule_bytes", "state_partition_rules")},
    # The module's rule table, built from the JAX package's objects at
    # import: the same patterns over the port's Rule and SHARD.
    "_RULES": tuple(
        tpartition.Rule(r.pattern, tpartition.SHARD if r.spec is jpartition.SHARD else tuple(r.spec))
        for r in jpartition_tests._RULES),
}

PARTITION_TESTS = [
    name for name, fn in vars(jpartition_tests).items()
    if name.startswith("test_") and callable(fn)
    and name != "test_zero_leaf_spec_delegates_to_rule_engine"
]
PIPELINE_TESTS = [
    "test_bubble_fraction_model",
    "test_balanced_assignment_properties",
    "test_stage_rules_are_start_anchored",
]


def on_the_port(module, name):
    """``module.name`` with every function of ``module`` re-made over one
    copy of its globals in which the port's objects replace the JAX
    package's."""
    ns = dict(vars(module))
    ns.update({k: v for k, v in PORT_NAMES.items() if k in ns})
    for k, v in list(ns.items()):
        if isinstance(v, types.FunctionType) and v.__module__ == module.__name__:
            fn = types.FunctionType(v.__code__, ns, v.__name__, v.__defaults__, v.__closure__)
            fn.__kwdefaults__ = v.__kwdefaults__
            if hasattr(v, "pytestmark"):
                fn.pytestmark = v.pytestmark
            ns[k] = fn
    return ns[name]


def _params(fn):
    """The parametrize cases of a JAX test: ``[(argnames, values), ...]``."""
    marks = [m for m in getattr(fn, "pytestmark", []) if m.name == "parametrize"]
    if not marks:
        return [{}]
    (mark,) = marks
    names = [n.strip() for n in mark.args[0].split(",")]
    return [dict(zip(names, v if len(names) > 1 else (v,))) for v in mark.args[1]]


CASES = [(mod, name, kw) for mod, names in ((jpartition_tests, PARTITION_TESTS),
                                           (jpipeline_tests, PIPELINE_TESTS))
         for name in names for kw in _params(getattr(mod, name))]


@pytest.mark.parametrize(
    "module,name,kwargs", CASES,
    ids=[f"{m.__name__}-{n}-{i}" for i, (m, n, _) in enumerate(CASES)])
def test_jax_parallel_test_passes_on_the_port(module, name, kwargs):
    fn = on_the_port(module, name)
    assert not (set(inspect.signature(fn).parameters) - set(kwargs))
    fn(**kwargs)


def test_rebinding_reaches_the_port():
    fn = on_the_port(jpartition_tests, "test_decide_concrete_rule")
    assert fn.__globals__["decide"] is tpartition.decide
    assert fn.__globals__["SHARD"] is tpartition.SHARD
    fn = on_the_port(jpipeline_tests, "test_balanced_assignment_properties")
    assert fn.__globals__["partition"] is tpartition
