"""The port's program auditor (``ddlpc_tpu_torch/analysis/program.py``,
``python -m ddlpc_tpu_torch.analysis.check --programs``) on the CPU.

One world of 8 gloo ranks, started before JAX's references are computed,
runs JAX's 15 data-parallel arms (one optimizer step each), the three
injections and the census-off probe.  Then:

- every arm holds the four contracts with no violation;
- each arm's ``wire`` census against JAX's jaxpr census of the same arm's
  update program (``audit_program(f"{arm}/update_step", fast=True)``: kind,
  count, elements, dtype) and JAX's ``comm_plan`` at the same element count
  and codec.  The differences are the named deviations: C5 (int16 summed
  as int32; no arm here reaches it, its exception is pinned on a census
  row) and C23 (one collective a bucket region of the flat buffer, its
  elements padded to ``N·rows_b``, against JAX's one collective a leaf
  padded to ``N·ceil(n_leaf/N)``).  JAX's update program ends at the update:
  the zero3 step's head all-gather is held against JAX's ``comm_plan``
  instead, and JAX's dead grad-norm ``psum`` (declared by JAX itself) has
  no counterpart;
- each injection is caught, naming its arm and contract, and exits 1
  through the CLI (on the module world's result, and in a world of its
  own); ``--inject drop-fence`` exits 2;
- a census that is off records nothing;
- the CLI's ``kind="program"`` stream lints;
- the census, not only ``comm_plan``, backs the wire rows of
  ``ddlpc_comm_bytes_total``.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import subprocess
import sys
import threading

import pytest
import torch

from ddlpc_tpu_torch.analysis import check as port_check
from ddlpc_tpu_torch.analysis import program as prog
from ddlpc_tpu_torch.config import CompressionConfig
from ddlpc_tpu_torch.models import build_model
from ddlpc_tpu_torch.obs.schema import check_record
from ddlpc_tpu_torch.parallel import mesh
from ddlpc_tpu_torch.parallel.train_step import FlatParams
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARMS = list(prog.ARMS)
JAX_KIND = {"all_reduce": "all-reduce", "reduce_scatter": "reduce-scatter",
            "all_gather": "all-gather", "ring_shift": "collective-permute"}
ITEM = {"s8": 1, "s16": 2, "f16": 2, "f32": 4, "s32": 4}
# What each injection must trip, as JAX's CLI names it.
INJECTED = {"extra-collective": "comm-closed-form", "fp32-widen": "dtype-flow",
            "replicated-leaf": "placement"}


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")


@pytest.fixture(scope="module")
def world():
    """The module's one world: every arm, every injection and the
    census-off probe, started on a thread before JAX's references."""
    box = {}

    def run():
        try:
            box["result"] = prog.audit(ARMS, "cpu", injections=prog.INJECTIONS,
                                       probes=("census-off",))
        except BaseException as e:  # re-raised on the test's thread
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    yield box, t


def _result(world) -> dict:
    box, t = world
    t.join(prog.DEADLINE_S)
    if "error" in box:
        raise box["error"]
    return box["result"]


@pytest.fixture(scope="module")
def jax_refs(world):
    """JAX's jaxpr census, declarations and comm plan of each arm's update
    program, computed while the world runs."""
    from ddlpc_tpu.analysis import program as jprog
    from ddlpc_tpu.obs import comm as jcomm

    refs = {}
    for arm in ARMS:
        name = f"{arm}/update_step"
        audit = jprog.audit_program(name, fast=True)
        bundle = jprog.build_program(name)
        d = bundle.declared
        plan = jcomm.comm_plan(d.n_grad, d.n_param, bundle.arm.compression(), d.axis_size,
                               bundle.arm.comm_variant, n_buckets=d.n_buckets)
        refs[arm] = {"census": audit.jaxpr_census, "declared": d, "plan": plan,
                     "violations": [v.format() for v in audit.violations]}
    return refs


def _audits(world) -> dict:
    return {(a["arm"], a["inject"]): a for a in _result(world)["audits"]}


def _port_layout(arm: str):
    """The flat buffer's regions of the arm's model over 8 replicas, from
    the model alone: ``(n, [N·rows_b], leaves)``."""
    cfg = prog.tiny_experiment(prog.ARMS[arm])
    flat = FlatParams(build_model(cfg.model, seed=cfg.train.seed), prog.AXIS_SIZE,
                      cfg.compression.bucket_mb)
    return flat.numel, [prog.AXIS_SIZE * rows for _, _, rows in flat.regions], len(flat.names)


@pytest.mark.parametrize("arm", ARMS)
def test_every_arm_holds_the_four_contracts(world, arm):
    a = _audits(world)[(arm, None)]
    assert a["program"] == f"{arm}/step"
    assert [v.format() for v in a["violations"]] == []
    assert a["exceptions"] == []  # no arm of the 15 sums int16 at 8 replicas
    wire = [r for r in a["census"] if r["role"] == "wire"]
    assert wire and all(r["axis"] == "data" for r in wire)
    assert a["n_params"] == 19_366  # tests/test_program_audit.py's tiny model
    assert a["declared_wire"] == prog.ARMS[arm].declared_wire_dtype()


@pytest.mark.parametrize("arm", ARMS)
def test_wire_census_matches_jax_census_and_comm_plan(world, jax_refs, arm):
    ref = jax_refs[arm]
    d, plan = ref["declared"], ref["plan"]
    assert ref["violations"] == []
    a = _audits(world)[(arm, None)]
    n, regions, leaves = _port_layout(arm)
    assert n == d.n_grad == 19_366
    assert len(regions) == d.n_buckets
    port_pad = sum(regions) - n
    wire = [r for r in a["census"] if r["role"] == "wire"]
    scalars = [r for r in wire if r["op"] == "all_reduce" and r["elements"] == 1]
    payload = [r for r in wire if r not in scalars]
    assert all(r["reduce"] == "max" and r["dtype"] == "f32" for r in scalars)
    # The scale maxes: JAX's declared scalar control collectives, less its
    # dead grad-norm psum (JAX's own declaration: XLA removes it).
    jax_scalars = sum(r["count"] for r in ref["census"]
                      if r["kind"] == "all-reduce" and r["dtype"] == "f32"
                      and r["elements"] == r["count"])
    assert jax_scalars == d.scale_collectives + int(d.has_dead_norm_psum)
    assert len(scalars) == d.scale_collectives
    jax_payload = {(r["kind"], r["dtype"]): r for r in ref["census"]
                   if not (r["kind"] == "all-reduce" and r["elements"] == r["count"])}
    head_gather = prog.ARMS[arm].shard_update == "zero3"
    by_kind = collections.defaultdict(list)
    for r in payload:
        if head_gather and r["op"] == "all_gather":
            continue  # JAX's update program has no head gather (its train step does)
        # C5: a summed int16 wire goes as int32; JAX's census reads s16.
        dtype = r.get("widened_from", r["dtype"])
        by_kind[(JAX_KIND[r["op"]], dtype)].append(r)
    assert set(by_kind) == set(jax_payload)
    for key, rows in by_kind.items():
        j = jax_payload[key]
        elements = sum(r["elements"] for r in rows)
        if key[0] == "collective-permute":
            # The ring chunks the n gradients as JAX does: the same hops.
            assert len(rows) == j["count"] == 2 * (prog.AXIS_SIZE - 1)
            assert elements == j["elements"]
            continue
        # C23: one collective a bucket region against one a leaf, each
        # padded its own way; unpadded, the same gradient elements.
        assert len(rows) == len(regions) and j["count"] == leaves
        jax_pad = {"all-reduce": 0,
                   "reduce-scatter": d.rs_pad_bytes // ITEM[key[1]],
                   "all-gather": d.ag_pad_bytes // 4}[key[0]]
        assert sorted(r["elements"] for r in rows) == sorted(regions)
        assert elements - port_pad == j["elements"] - jax_pad == n
    # JAX's comm_plan at the same n and codec: the gradient row's payload
    # (its bytes_wire less the scales it folds in), the params row.
    grad = [r for r in payload if r["op"] != "all_gather"]
    narrow = plan[0]["wire_dtype"] != "f32"
    if prog.ARMS[arm].comm_variant == "ring":
        assert sum(r["bytes"] for r in grad) == plan[0]["bytes_wire"]
        assert plan[0]["wire_dtype"] == grad[0]["dtype"]
    else:
        item = ITEM[grad[0].get("widened_from", grad[0]["dtype"])]
        scale_in_plan = 4 * d.n_buckets if narrow else 0
        assert sum(r["elements"] for r in grad) * item - port_pad * item == (
            plan[0]["bytes_wire"] - scale_in_plan)
        assert 4 * len(scalars) >= scale_in_plan
    gathers = [r for r in payload if r["op"] == "all_gather"]
    assert len(plan) == 1 + bool(gathers)
    if gathers:
        assert sum(r["bytes"] for r in gathers) - 4 * port_pad == plan[1]["bytes_wire"]


@pytest.mark.parametrize("inject", prog.INJECTIONS)
def test_each_injection_is_caught_naming_its_arm_and_contract(world, inject, monkeypatch):
    arm = prog.INJECTION_ARMS[inject]
    a = _audits(world)[(arm, inject)]
    contracts = {v.contract for v in a["violations"]}
    assert INJECTED[inject] in contracts
    assert all(v.program == f"{arm}/step+{inject}" for v in a["violations"])
    # Through the CLI, on the world's result for this injection: exit 1,
    # each violation printed as JAX's CLI prints it.
    result = dict(_result(world), audits=[a])
    monkeypatch.setattr(prog, "audit", lambda arms, device, injections: (
        result if list(injections) == [inject] and arms == [] else None))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = port_check.main(["--programs", "--device", "cpu", "--inject", inject])
    assert rc == 1
    assert f"program_audit: VIOLATION {arm}/step+{inject}: [{INJECTED[inject]}]" in out.getvalue()


def _cli(*args) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "ddlpc_tpu_torch.analysis.check", "--programs", "--device", "cpu",
         *args], cwd=REPO, env=_env(), capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("inject", prog.INJECTIONS)
def test_each_injection_exits_1_through_the_cli_in_a_world_of_its_own(inject):
    r = _cli("--inject", inject)
    assert r.returncode == 1, r.stderr[-2000:]
    arm = prog.INJECTION_ARMS[inject]
    assert f"VIOLATION {arm}/step+{inject}: [{INJECTED[inject]}]" in r.stdout


def test_drop_fence_and_an_unknown_arm_exit_2():
    r = _cli("--inject", "drop-fence")
    assert r.returncode == 2 and "no eager counterpart" in r.stderr
    r = _cli("--arms", "int8_simulate,bogus")
    assert r.returncode == 2 and "unknown arm(s): bogus" in r.stderr


def test_the_census_off_records_nothing(world):
    probes = _result(world)["probes"]
    assert [p["probe"] for p in probes] == ["census-off"]
    for r in probes[0]["ranks"]:
        assert r == {"probe": "census-off", "rows": 0, "calls": 0, "census_on": False,
                     "tally_on": False}
    # In this process: off, the codec tally is None and a call counts
    # nothing; a census cannot nest.
    from ddlpc_tpu_torch.ops import cuda_quantize

    assert not mesh.census_on() and cuda_quantize.CALLS is None
    with mesh.census() as c:
        cuda_quantize.absmax(torch.ones(8))
        with pytest.raises(RuntimeError):
            with mesh.census():
                pass
    cuda_quantize.absmax(torch.ones(8))
    assert c.codec["absmax"] == 1 and not mesh.census_on()


def test_a_card_asked_for_without_one_raises():
    if torch.cuda.is_available():
        pytest.fail("this test is for a host without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prog.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prog.audit(["int8_simulate"], "cuda")
    assert prog.resolve_device("cpu") == "cpu"


def test_cli_stream_lints(tmp_path):
    from ddlpc_tpu.obs.schema import check_record as jax_check_record

    out = tmp_path / "programs.jsonl"
    r = subprocess.run([sys.executable, "-m", "ddlpc_tpu_torch.analysis.check", "--programs",
                        "--device", "cpu", "--arms", "int8_zero2,fp16_bucketed_zero2",
                        "--out", str(out)], cwd=REPO, env=_env(), capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert all(check_record(rec) == [] and jax_check_record(rec) == [] for rec in recs)
    assert all(rec["kind"] == "program" for rec in recs)
    assert [rec["arm"] for rec in recs[:-1]] == ["int8_zero2", "fp16_bucketed_zero2"]
    assert recs[-1]["record"] == "summary"
    assert recs[-1]["programs"] == 2 and recs[-1]["violations"] == 0 and recs[-1]["world"] == 8
    assert "reduce_scatter/sum|s8|data|wire|count=1|elements=19456|bytes=19456" in (
        recs[0]["wire_census"])


def test_codec_calls_closed_form_is_chip_smokes_per_bucket_table():
    sys.path.insert(0, REPO)
    import chip_smoke

    with open(os.path.join(REPO, "configs", "vaihingen_unet_v5e8.json")) as f:
        base = json.load(f)["compression"]
    for label, (world, extra, _, per_bucket, _) in chip_smoke.DP_PHASES.items():
        codec = dict(base)
        for o in extra:
            key, _, value = o.partition("=")
            if key.startswith("compression."):
                codec[key.split(".", 1)[1]] = value
        comp = CompressionConfig(**codec)
        assert prog.codec_calls_per_sync(comp, world) == per_bucket, label


def test_dtype_flow_reports_c5_as_its_named_exception():
    """An int16 wire summed as int32 (C5) is the exception, not a
    violation; an int32 operand that was not widened is a violation."""
    row = {"op": "all_reduce", "reduce": "sum", "dtype": "s32", "widened_from": "s16",
           "elements": 100, "bytes": 400, "role": "wire", "axis": "data"}
    bad, exc = prog.check_dtype_flow("p", [row], "s16")
    assert bad == [] and len(exc) == 1 and exc[0].startswith("C5:")
    plain = dict(row)
    del plain["widened_from"]
    bad, exc = prog.check_dtype_flow("p", [plain], "s16")
    assert [v.contract for v in bad] == ["dtype-flow"] and exc == []
    # 16 int8 levels over 8 replicas sum past 127: the closed form expects
    # the int32 payload the widening sends.
    comp = CompressionConfig(mode="int8", int8_levels=16)
    assert prog.declared_wire(comp, 8) == "s16"
    rows = prog.expected_wire_rows(comp, "off", 8, [(100, 128)], 100)
    assert rows == {("all_reduce", "max", "f32", 1): 1, ("all_reduce", "sum", "s32", 128): 1}


def test_the_census_backs_the_comm_gauge(world, monkeypatch):
    """The wire rows of ``ddlpc_comm_bytes_total`` a ``CommAccountant``
    publishes from ``comm_plan`` equal what the census saw move, and a
    plan that disagrees with the census is a violation: it is not
    published silently."""
    audits = _audits(world)
    for arm in ARMS:
        a = audits[(arm, None)]
        wire = sum(r["bytes"] for r in a["census"] if r["role"] == "wire")
        ring_scale = 4 if prog.ARMS[arm].comm_variant == "ring" else 0
        assert sum(a["gauge_wire"].values()) + ring_scale == wire, arm
    # The smuggled all-reduce moved 64 bytes the gauge does not carry.
    inj = audits[("int8_simulate", "extra-collective")]
    assert inj["gauge_wire"] == audits[("int8_simulate", None)]["gauge_wire"] == {
        "all_reduce": 19_460}
    # A plan 4 bytes short (its scale forgotten) against the honest census.
    a = audits[("int8_simulate", None)]
    real = prog.comm_plan

    def short(*args, **kwargs):
        rows = real(*args, **kwargs)
        return [dict(rows[0], bytes_wire=rows[0]["bytes_wire"] - 4)] + rows[1:]

    monkeypatch.setattr(prog, "comm_plan", short)
    n, regions, _ = _port_layout("int8_simulate")
    comp = prog.ARMS["int8_simulate"].compression()
    bad, gauge = prog.check_comm_closed_form("int8_simulate/step", a["census"], comp, "off",
                                             prog.AXIS_SIZE, [(n, regions[0])], n)
    assert gauge == {"all_reduce": 19_456}
    assert [v.contract for v in bad] == ["comm-closed-form"]
    assert "moves 19460 B" in bad[0].message and "says 19456 B" in bad[0].message
