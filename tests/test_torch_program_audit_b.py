"""The port's program auditor, part (b) (``ddlpc_tpu_torch/analysis/program.py``):
JAX's space, pipeline, serve and eval arms (13 arms, 21 programs), the
``stage-boundary`` contract, the pipeline's carries under the census and
the port's committed per-program baseline
(``docs/port_analysis/program_baseline.json``).

One world of 8 gloo ranks, started before JAX's references are computed,
runs the 13 arms (one step each).  Then:

- every program holds its contracts on every rank that holds it, and
  equals its committed baseline entry; ``build_baseline`` over the run
  rewrites those entries byte for byte;
- the pipeline segments and stage updates, and ``eval``, against JAX's
  jaxpr census of the same program (``audit_program(name, fast=True)``) on
  unpadded totals.  A segment's census holds every micro-batch slot of the
  step (M = 2), JAX's program one; the carries are JAX's carry avals at
  this replica's 2 of the global micro-batch's 8 columns.  The differences
  are the named deviations: C23 (one collective a bucket region of the
  flat buffer, and one of the batch statistics' concatenation, against
  JAX's one a leaf), C24 (the eval sums in one float64 all-reduce, JAX's in
  three float32 ones) and C25 (JAX's zero2 stage update psums the chunks'
  squared norm, the port sums it in the step's closing all-reduce);
- the serve programs issue no collective, and their inputs by dtype are
  JAX's avals' (``build_program(name).avals``; for ``serve_fp32`` the
  ``TrainState`` leaves the forward reads: params, batch statistics and
  images);
- the space arms' gradient all-reduce moves exactly the flat buffer's f32
  elements, and their halo rows equal a closed form from the model's
  convs;
- ``stage-boundary`` fires on a segment holding a reduce-scatter, on one
  over its statistics' budget, on a codec call and on an f32 carry;
  ``census-drift`` fires on a baseline with one row changed (in the CLI
  too, exit 1), while age and another torch only warn.
"""

from __future__ import annotations

import collections
import copy
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from ddlpc_tpu_torch.analysis import program as prog
from ddlpc_tpu_torch.config import CompressionConfig
from ddlpc_tpu_torch.models import build_model, build_model_from_experiment
from ddlpc_tpu_torch.models.layers import Conv, space_halo
from ddlpc_tpu_torch.ops import cuda_quantize
from ddlpc_tpu_torch.parallel import mesh
from ddlpc_tpu_torch.parallel.train_step import FlatParams
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARMS = [a for a in prog.ARMS if a not in prog.DATA_PARALLEL_ARMS]
PROGRAMS = [p for p, (arm, _) in prog.PROGRAMS.items() if arm in ARMS]
SPACE = [a for a in ARMS if prog.arm_kind(prog.ARMS[a]) == "spatial"]
PIPE = [p for p in PROGRAMS if prog.PROGRAMS[p][1].startswith("stage")]
SERVE = [a for a in ARMS if prog.arm_kind(prog.ARMS[a]) == "serve"]
JAX_KIND = {"all_reduce": "all-reduce", "reduce_scatter": "reduce-scatter",
            "all_gather": "all-gather"}
JAX_DTYPE = {"float32": "f32", "bfloat16": "bf16", "int8": "s8", "int32": "s32"}
M = 2  # the tiny experiment's sync_period: the pipeline's micro-batches
STAGE_DATA = 4  # pipe 2 × data 4


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")


@pytest.fixture(scope="module")
def world():
    """The module's one world: the 13 arms, started on a thread before
    JAX's references."""
    box = {}

    def run():
        try:
            box["result"] = prog.audit(ARMS, "cpu")
        except BaseException as e:  # re-raised on the test's thread
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    yield box, t


def _audits(world) -> dict:
    box, t = world
    t.join(prog.DEADLINE_S)
    if "error" in box:
        raise box["error"]
    return {a["program"]: a for a in box["result"]["audits"]}


@pytest.fixture(scope="module")
def jax_refs(world):
    """JAX's jaxpr census and bundle of every pipeline, eval and serve
    program, computed while the world runs."""
    from ddlpc_tpu.analysis import program as jprog

    refs = {}
    for name in PIPE + ["eval/eval_step", "eval_gspmd/eval_step"] + [f"{a}/forward" for a in SERVE]:
        audit = jprog.audit_program(name, fast=True)
        refs[name] = {"census": {(r["kind"], r["dtype"]): r for r in audit.jaxpr_census},
                      "bundle": jprog.build_program(name),
                      "violations": [v.format() for v in audit.violations]}
    return refs


@pytest.fixture(scope="module")
def baseline():
    return prog.load_baseline()


def _holders(program: str) -> list:
    kind = prog.PROGRAMS[program][1]
    if kind.startswith("stage"):
        stage = int(program.split("/stage")[1][0])
        return list(range(stage * STAGE_DATA, (stage + 1) * STAGE_DATA))
    return list(range(prog.AXIS_SIZE))


def test_the_table_is_jaxs():
    from ddlpc_tpu.analysis import program as jprog

    assert list(prog.ARMS) == list(jprog.ARMS)
    for name, arm in prog.ARMS.items():
        j = jprog.ARMS[name]
        for f in ("mode", "transport", "rounding", "quantize_local", "quantize_mean",
                  "shard_update", "spatial", "serve_quantize", "bucket_mb", "pipeline_stages"):
            assert getattr(arm, f) == getattr(j, f), (name, f)
    # JAX audits an update program and a train step of the data-parallel
    # arms; the port's one program there is its whole step.
    jax_rest = [p for p, (arm, _) in jprog.PROGRAMS.items() if arm in ARMS]
    assert sorted(PROGRAMS) == sorted(jax_rest) and len(PROGRAMS) == 21
    assert len(prog.PROGRAMS) == 36 and len(ARMS) == 13


@pytest.mark.parametrize("program", PROGRAMS)
def test_every_program_holds_its_contracts_on_every_rank(world, program):
    a = _audits(world)[program]
    assert [v.format() for v in a["violations"]] == []
    assert a["ranks"] == _holders(program)
    assert a["exceptions"] == []
    assert np.isfinite(a.get("loss", 0.0))
    kind = prog.PROGRAMS[program][1]
    if kind in ("spatial_step", "eval_step", "stage_fwd", "stage_bwd"):
        # The space arms' collectives are the partitioner's in JAX: aux.
        assert all(r["role"] == "aux" for r in a["census"])


@pytest.mark.parametrize("program", PROGRAMS)
def test_every_program_equals_its_committed_baseline(world, baseline, program):
    a = _audits(world)[program]
    assert prog.compare_to_baseline(a, baseline["programs"].get(program)) == []


def test_update_baseline_rewrites_the_programs_block_byte_for_byte(world, baseline):
    audits = list(_audits(world).values())
    new = prog.build_baseline(audits, baseline)
    assert json.dumps(new["programs"], indent=1) == json.dumps(baseline["programs"], indent=1)
    assert list(new["programs"]) == list(prog.PROGRAMS)
    assert prog.validate_program_baseline(new) == []
    for key in ("schema", "generated_by", "generated_at", "generated_at_iso", "axis_size",
                "torch_version"):
        assert key in new, key
    assert new["axis_size"] == 8


def _totals(rows) -> dict:
    """``{(JAX kind, dtype): [count, elements]}`` of census rows (a widened
    wire under its own dtype)."""
    out = collections.defaultdict(lambda: [0, 0])
    for r in rows:
        key = (JAX_KIND[r["op"]], r.get("widened_from", r["dtype"]))
        out[key][0] += 1
        out[key][1] += int(r["elements"])
    return dict(out)


@pytest.mark.parametrize("program", PIPE)
def test_pipeline_programs_match_jax_jaxpr_census(world, jax_refs, program):
    ref = jax_refs[program]
    assert ref["violations"] == []
    jax = {k: [r["count"], r["elements"]] for k, r in ref["census"].items()}
    a = _audits(world)[program]
    rows = [r for r in a["census"] if r["op"] not in ("send", "send_header")]
    sends = [r for r in a["census"] if r["op"] == "send"]
    headers = [r for r in a["census"] if r["op"] == "send_header"]
    kind = prog.PROGRAMS[program][1]
    bundle = ref["bundle"]
    d = bundle.declared
    if kind != "stage_update":
        # A segment's census holds the step's M micro-batch slots; JAX's
        # program is one slot: the same sync-BN sums, M times.
        assert {k: [M * c, M * n] for k, (c, n) in jax.items()} == _totals(rows)
        assert a["stats_elements"] == d.stats_elements
        assert a["declared_wire"] == d.carry_dtype == "bf16"
        # The carries: every tensor sent is one row, bf16 as handed in.
        # JAX's carry avals hold the global micro-batch of 8 columns.
        if program.endswith("_fwd"):
            out = _leaves(_carry_out(bundle))
        elif program.endswith("_loss_bwd"):
            out = _leaves(bundle.avals[2])  # the cotangent of its carry in
        else:
            out = []  # stage 0 sends no cotangent back
        assert len(sends) == M * len(out)
        assert sorted(r["elements"] for r in sends) == sorted(
            int(np.prod(leaf.shape)) // STAGE_DATA for leaf in out for _ in range(M))
        assert {JAX_DTYPE[str(leaf.dtype)] for leaf in out} <= {"bf16"}
        assert {r["dtype"] for r in sends} <= {"bf16"}
        assert len(headers) == (M if program.endswith("_fwd") else 0)
        assert all(r["dtype"] == "s64" and r["elements"] == 64 for r in headers)
        return
    # The stage update: JAX's one collective a leaf against the port's one
    # a bucket region (and one for the statistics' concatenation): C23.
    got = _totals(rows)
    n = d.n_grad
    pad = {("reduce-scatter", "s8"): d.rs_pad_bytes, ("all-gather", "f32"): d.ag_pad_bytes // 4}
    wire = [r for r in rows if r["role"] == "wire" and r["elements"] > 1]
    port_pad = sum(r["elements"] for r in wire) // len(wire) - n
    assert port_pad >= 0 and all(r["elements"] == n + port_pad for r in wire)
    stats = [r for r in rows if r["role"] == "aux"]
    assert len(stats) == 1 and stats[0]["elements"] == d.stats_elements
    scales = [r for r in rows if r["role"] == "wire" and r["elements"] == 1]
    assert len(scales) == d.scale_collectives
    n_leaves = len(_leaves(bundle.avals[0]))
    stat_leaves = len(_leaves(bundle.avals[3]))
    # C25: JAX's zero2 update psums the chunks' squared norm (one element);
    # the port sums it in the step's closing all-reduce (the tail).
    norm = int(bundle.arm.shard_update == "zero2")
    for key, (count, elements) in jax.items():
        c, e = got[key]
        if key[0] == "all-reduce":
            payload = [r for r in wire if r["op"] == "all_reduce"]
            assert e - port_pad * len(payload) + norm == elements
            assert c == len(payload) + len(scales) + 1
            assert count == n_leaves * len(payload) + stat_leaves + len(scales) + norm
        else:
            assert c == 1 and count == n_leaves
            assert e - port_pad == elements - pad[key] == n
    assert set(got) == set(jax)


def _leaves(tree) -> list:
    import jax

    return jax.tree_util.tree_leaves(tree)


def _carry_out(bundle):
    """JAX's carry avals out of a stage's forward program."""
    import jax

    return jax.eval_shape(bundle.fn, *bundle.avals)[0]


@pytest.mark.parametrize("arm", ["eval", "eval_gspmd"])
def test_eval_sums_in_one_float64_all_reduce_c24(world, jax_refs, arm):
    a = _audits(world)[f"{arm}/eval_step"]
    ref = jax_refs[f"{arm}/eval_step"]
    assert ref["violations"] == []
    sums = [r for r in a["census"] if r["op"] == "all_reduce"]
    assert len(sums) == 1
    r = sums[0]
    assert (r["dtype"], r["elements"], r["bytes"], r["axis"]) == (
        "f64", 38, 304, "stage" if arm == "eval_gspmd" else "data")
    if arm == "eval":
        # JAX psums the confusion matrix, the NLL sum and the count: three
        # float32 all-reduces of 38 elements in all, 152 bytes (C24).
        assert ref["census"] == {("all-reduce", "f32"): {
            "kind": "all-reduce", "dtype": "f32", "group": "all", "count": 3, "elements": 38,
            "bytes": 152}}
    else:
        # JAX's partitioner inserts the GSPMD eval's collectives after the
        # jaxpr; the port's sharded forward adds its halo rows.
        assert ref["census"] == {}
        assert {r["op"] for r in a["census"]} == {"all_reduce", "exchange"}


@pytest.mark.parametrize("arm", SERVE)
def test_serve_programs_have_no_collective_and_jaxs_inputs(world, jax_refs, arm):
    a = _audits(world)[f"{arm}/forward"]
    assert a["census"] == []
    ref = jax_refs[f"{arm}/forward"]
    assert ref["census"] == {} and ref["violations"] == []
    avals = ref["bundle"].avals
    if arm == "serve_fp32":
        state, images = avals  # the leaves the forward reads of the TrainState
        leaves = _leaves(state.params) + _leaves(state.batch_stats) + [images]
    else:
        leaves = _leaves(avals)
    want = collections.defaultdict(lambda: [0, 0])
    for leaf in leaves:
        want[JAX_DTYPE[str(leaf.dtype)]][0] += 1
        want[JAX_DTYPE[str(leaf.dtype)]][1] += int(np.prod(leaf.shape)) * leaf.dtype.itemsize
    assert a["inputs"] == [f"{k}|leaves={n}|bytes={b}" for k, (n, b) in sorted(want.items())]
    decodes = 36 if arm == "serve_int8" else 0
    assert a["codec_calls"] == ({"decode_from_wire": decodes} if decodes else {})


def _halo_closed_form(arm: str, batch: int, slots: int, backward: bool) -> collections.Counter:
    """The elements of rank 0's halo sends, one entry a send, from the
    model's convs: at space 2 rank 0 sends its bottom ``top`` rows forward
    (the halo above rank 1's rows) and, in the backward, the cotangent of
    its ``bottom`` halo rows, ``rows × batch × channels × width`` each; the
    backward of the first conv (on the images) sends nothing."""
    cfg = prog.tiny_experiment(prog.ARMS[arm])
    model = build_model(cfg.model, seed=0)
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, tuple(args[0].shape), args[0].requires_grad)))
        for m in model.modules() if isinstance(m, Conv) and (m.kernel > 1 or m.stride > 1)]
    h, w = cfg.data.image_size
    model.train()(torch.zeros(batch, h, w, 3))
    for hk in hooks:
        hk.remove()
    out = collections.Counter()
    for mod, (b, c, _, width), needs_grad in seen:
        top, bottom = space_halo(mod.kernel, mod.stride, mod.dilation)
        if top:
            out[top * b * c * width] += slots
        if backward and bottom and needs_grad:
            out[bottom * b * c * width] += slots
    return out


@pytest.mark.parametrize("arm", SPACE + ["eval_gspmd"])
def test_space_arms_halo_rows_and_gradient_all_reduce(world, arm):
    program = f"{arm}/eval_step" if arm.startswith("eval") else f"{arm}/train_step"
    a = _audits(world)[program]
    cfg = prog.tiny_experiment(prog.ARMS[arm])
    halos = collections.Counter(r["elements"] for r in a["census"] if r["op"] == "exchange"
                                for _ in range(1))
    assert all(r["dtype"] == "bf16" and r["axis"] == "space"
               for r in a["census"] if r["op"] == "exchange")
    if arm.startswith("eval"):
        assert halos == _halo_closed_form(arm, 2, 1, backward=False)
        return
    # JAX's global micro-batch of 16 tiles, 4 a data shard, 2 micro-batches.
    assert halos == _halo_closed_form(arm, 4, cfg.train.sync_period, backward=True)
    model = build_model_from_experiment(cfg, 3, prog.SPATIAL_DATA)
    flat = FlatParams(model, prog.SPATIAL_DATA, cfg.compression.bucket_mb)
    grads = [r for r in a["census"] if r["op"] == "all_reduce" and r["elements"] > 2
             and r["elements"] == flat.data.numel()]
    assert len(grads) == 1
    assert (grads[0]["dtype"], grads[0]["axis"], grads[0]["role"], grads[0]["bytes"]) == (
        "f32", "stage", "aux", 4 * flat.data.numel())
    assert flat.numel == 19_366
    gathers = [r for r in a["census"] if r["op"] == "all_gather"]
    assert [(r["role"], r["elements"]) for r in gathers] == (
        [("aux", flat.data.numel())] if prog.ARMS[arm].shard_update != "off" else [])
    if prog.ARMS[arm].mode != "none":
        assert a["codec_calls"] == {"fake_quantize_fused": len(flat.regions),
                                    "absmax": len(flat.regions)}


def _row(op="all_reduce", dtype="f32", elements=16, **kw):
    return {"op": op, "reduce": "sum" if op != "send" else None, "dtype": dtype,
            "elements": elements, "bytes": elements * 4, "role": "aux", "axis": "data", **kw}


def test_stage_boundary_fires():
    ok = [_row(elements=32), _row("send", "bf16", 1024), _row("send_header", "s64", 64)]
    assert prog.check_stage_segment("p/stage0_fwd", ok, 16, 1) == []
    assert prog.check_carry_dtypes("p/stage0_fwd", ok, "bf16") == []
    rs = prog.check_stage_segment("p/stage0_fwd", ok + [_row("reduce_scatter", "s8", 64)], 16, 1)
    assert [v.contract for v in rs] == ["stage-boundary"] and "reduce_scatter[s8]" in rs[0].message
    over = prog.check_stage_segment("p/stage0_bwd", [_row(elements=65)], 16, 1)
    assert [v.contract for v in over] == ["stage-boundary"] and "over the sync-BN" in over[0].message
    assert prog.check_stage_segment("p/stage0_bwd", [_row(elements=65)], 16, 2) == []
    codec = prog.check_stage_segment("p/stage0_fwd", ok, 16, 1, {"absmax": 1})
    assert [v.contract for v in codec] == ["stage-boundary"]
    wide = prog.check_carry_dtypes("p/stage0_fwd", [_row("send", "f32", 1024)], "bf16")
    assert [v.contract for v in wide] == ["stage-boundary"] and "f32" in wide[0].message


def test_census_drift_fires_on_one_row_changed(world, baseline, tmp_path):
    a = _audits(world)["pipe2_none/stage0_update"]
    entry = copy.deepcopy(baseline["programs"]["pipe2_none/stage0_update"])
    entry["census_strings"][0] = entry["census_strings"][0].replace("count=1|", "count=2|")
    bad = prog.compare_to_baseline(a, entry)
    assert {v.contract for v in bad} == {"census-drift"} and len(bad) == 2
    assert all(v.program == "pipe2_none/stage0_update" for v in bad)
    assert any("count=2|" in v.message and "in the baseline" in v.message for v in bad)
    # Through the CLI, against a baseline with one row changed: exit 1.
    changed = copy.deepcopy(baseline)
    rows = changed["programs"]["eval/eval_step"]["census_strings"]
    rows[0] = rows[0].replace("|f64|", "|f32|")
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps(changed))
    r = subprocess.run([sys.executable, "-m", "ddlpc_tpu_torch.analysis.check", "--programs",
                        "--device", "cpu", "--arms", "eval", "--baseline", str(path)],
                       cwd=REPO, env=_env(), capture_output=True, text=True, timeout=600)
    assert r.returncode == 1, r.stderr[-2000:]
    assert "VIOLATION eval/eval_step: [census-drift] census_strings row" in r.stdout


def test_age_and_another_torch_only_warn(world, baseline):
    old = dict(baseline, generated_at=baseline["generated_at"] - 400 * 86400.0,
               torch_version="0.0.0")
    warnings = prog.baseline_warnings(old)
    assert len(warnings) == 2 and "days old" in warnings[0] and "torch 0.0.0" in warnings[1]
    audits = [a for a in _audits(world).values()]
    assert prog.drift(audits, old, every_program=False) == []
    # Every program of the baseline audited or named.
    missing = prog.drift(audits, old, every_program=True)
    assert {v.program for v in missing} == set(prog.PROGRAMS) - set(PROGRAMS)


def test_census_segments_tag_rows_and_codec_calls_and_do_nothing_when_off():
    with mesh.census_segment("stage0_fwd"):
        cuda_quantize.absmax(torch.ones(8))
    assert not mesh.census_on()
    with mesh.census() as c:
        with mesh.census_segment("stage0_update"):
            cuda_quantize.absmax(torch.ones(8))
        cuda_quantize.absmax(torch.ones(8))
    assert c.codec["absmax"] == 2 and c.segment("stage0_update").codec["absmax"] == 1
    assert c.segment("stage0_fwd").rows == [] and c.segment("stage0_fwd").codec == {}


def test_codec_calls_on_mean_is_the_spatial_steps():
    assert prog.codec_calls_on_mean(CompressionConfig(mode="none")) == {}
    assert prog.codec_calls_on_mean(CompressionConfig(mode="float16", quantize_local=False)) == {
        "fake_quantize_fused": 1, "absmax": 1}
    assert prog.codec_calls_on_mean(CompressionConfig(mode="int8", rounding="stochastic")) == {
        "fake_quantize_sr": 1, "absmax": 1}
