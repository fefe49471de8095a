"""The port's program auditor: a census of one real step's collectives and
codec calls, held to closed forms — the port's counterpart of
``ddlpc_tpu/analysis/program.py`` over JAX's 28 arms and 36 programs.

What the JAX package does: it lowers its real step builders on
``ShapeDtypeStruct``s and audits the jaxprs and the optimized HLO of its
config arms against ``comm-closed-form``, ``dtype-flow``,
``fence-survival``, ``sharding``, ``donation`` and ``stage-boundary``, and
pins each program's census in a committed baseline.

What the port does: it runs eagerly, so there is no program to lower.  An
arm is ONE real step of the port's own entry on every rank of a gloo world
of :data:`AXIS_SIZE` processes (the :func:`tiny_experiment`: the U-Net at
features (8, 16), bottleneck 16, 6 classes, 32² tiles, micro-batch 2 ×
sync 2, bf16 compute, 19,366 parameters), with the census of
``parallel/mesh.py`` on (:func:`mesh.census`): every collective and
pipeline send the step issues, its op, axis, the dtype handed to
``torch.distributed``, its elements and bytes and its role (``wire``: the
gradient sync's and a ZeRO level's params all-gather, as JAX's
``_classify_wire`` classes them; ``aux``: the rest), and the codec's entry
calls by ``ops/cuda_quantize.LAUNCHES`` name.  One world runs every arm in
turn; before each, ``mesh.init_grid`` lays it out as JAX's ``_mesh_for``
does (:func:`arm_grid`).  A program is what JAX's ``_program_table`` names
(:data:`PROGRAMS`); each rank holds its own to its contracts:

- the data-parallel arms (``<arm>/step``, one step of
  ``parallel/train_step.make_train_step``; :func:`check_step`):

  - ``comm-closed-form`` — the census' ``wire`` rows against the port's
    ``obs/comm.comm_plan``: byte for byte through the
    ``ddlpc_comm_bytes_total{stage="wire"}`` rows a ``CommAccountant`` fed
    that plan reports (so a plan the collectives disagree with is a
    violation, not a silently published number), and row for row per
    gradient bucket (op, reduction, dtype, elements: the flat buffer's
    regions of ``N·rows_b`` elements, the padding of
    ``shard_update.region_rows`` included); the codec's scale all-reduces
    (one max a bucket for the fused encode's shared scale, one more under
    chunked gradients for the mean stage's) and the ring's one scale max
    are accounted explicitly, as JAX accounts its scalar control
    collectives;
  - ``dtype-flow`` — no ``wire`` payload operand is wider than the arm
    declares (``grad_sync.simulate_wire_dtype``, or
    ``compressed_allreduce.wire_dtype`` for the ring, fp32 otherwise);
    scalar control collectives are exempt, and an int16 wire widened to
    int32 by ``mesh._widened`` is ROADMAP C5, reported as that named
    exception and not as a violation;
  - ``placement`` (JAX's ``sharding``) — the bytes this rank holds of
    each kind (params, grads, optimizer moments), measured from the
    tensors the state holds after the step (the param buffer's storage
    and the owned chunks, the optimizer-boundary gradient the sync left,
    the moment buffers), against what the state's ``StateLayout`` decides
    for the kind: a chunked kind ``(n + pad)/N`` elements, a whole one
    ``n + pad``, with the flat layout's padding ``pad`` (C21) counted
    apart;
  - ``codec-calls`` — the codec's entry calls a sync a bucket against the
    closed form (:func:`codec_calls_per_sync`, the ``per_bucket`` table
    ``chip_smoke.py`` holds on the card); on a card the census' calls
    must also equal ``LAUNCHES``' delta;

- the space arms (``<arm>/train_step``, one step of
  ``train_step.make_train_step_spatial`` over ``models.shard_space(model,
  4, 2)``, each rank its 16 of the 32 rows; :func:`check_spatial_step`):
  ``placement`` (the ZeRO levels through the same ``StateLayout``, in the
  port's chunk mode where JAX's GSPMD layout decides in leaf mode: C21)
  and ``codec-calls`` (``train_step.codec_on_mean``: one max-abs and one
  fake-quantize a bucket region, :func:`codec_calls_on_mean`).
  ``comm-closed-form`` and ``dtype-flow`` do not apply, as JAX's
  ``comm_variant`` is None for these arms: the collectives are the
  partitioner's there, and here the gradient all-reduce over the
  ``stage`` group and the params all-gather keep role ``aux``.  The whole
  census (halo ``exchange`` rows, that all-reduce, the BatchNorm sums,
  the metrics) is pinned by the baseline;
- the pipeline arms (one step of ``parallel/pipeline.PipelineTrainStep``,
  pipe 2 × data 4, M = 2, a global micro-batch of 8; each rank holds its
  own stage's programs, cut from the census by the step's segment tags):
  a segment (``stage<s>_fwd``, ``stage<s>_bwd``, ``stage<S-1>_loss_bwd``)
  is held to ``stage-boundary`` (:func:`check_stage_segment`: only f32
  all-reduces, their elements at most 4 × the stage's batch-stat elements
  a micro-batch slot, no codec call; :func:`check_carry_dtypes`: no carry
  sent wider than the model's compute dtype), a stage update
  (``stage<s>_update``) to :func:`check_step` at the stage group's 4
  replicas;
- the serve arms (``<arm>/forward``, the engine's ``device_logits`` on one
  bucket of 4 tiles, each rank alone; :func:`check_serve_forward`): no
  collective, and ``serve_int8`` decodes once a leaf; its inputs by dtype
  are recorded as JAX records ``param_dtypes`` and ``argument_bytes``;
- the eval arms (``<arm>/eval_step``, ``make_eval_step`` over the data
  axis of 8 or the (data, space) group; :func:`check_eval_step`): one
  all-reduce of the confusion matrix, the NLL sum and the pixel count,
  float64 (ROADMAP C24: JAX psums three float32 values), and no codec
  call.

No eager counterpart, and no stand-in: ``fence-survival`` (an
``optimization_barrier`` surviving XLA's passes) and ``donation`` (a
donated buffer input/output-aliased in a compiled module) are properties
of a compiled program, which the port does not have.  What a compiler
would take from the port, the checker's ``jit-host-call`` and
``codec-fence`` rules already guard.  So ``--inject drop-fence`` has no
counterpart either, nor does JAX's HLO parser (``analysis/hlo.py``): the
census is taken where the collectives are issued.

The three injections that have one (:data:`INJECTIONS`) run one arm with a
deliberate fault and must be caught: ``extra-collective`` (one more live
``wire`` all-reduce in ``int8_simulate`` → ``comm-closed-form``),
``fp32-widen`` (``simulate_wire_dtype`` patched to None while
``int8_simulate`` declares its honest s8 → ``dtype-flow``) and
``replicated-leaf`` (``none_simulate``'s moments declared chunked but held
whole → ``placement``).

The baseline (``docs/port_analysis/program_baseline.json``,
:func:`build_baseline`): each program's whole census as
:func:`census_strings` (``wire`` and ``aux`` rows alike), its codec calls,
its placement bytes, its named exceptions and (serve) its inputs, stamped
as JAX stamps its own (``torch_version`` where JAX records
``jax_version``).  A structural difference is a ``census-drift``
violation naming the program and the row (:func:`compare_to_baseline`);
age or another torch version only warn (:func:`baseline_warnings`).
``python -m ddlpc_tpu_torch.analysis.check --programs`` is the CLI
(``--update-baseline`` writes the file); this module's ``__main__`` is one
rank of the world it starts.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ddlpc_tpu_torch.config import (
    CompressionConfig,
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    ParallelConfig,
    TrainConfig,
)
from ddlpc_tpu_torch.obs.comm import SCALE_BYTES, CommAccountant, comm_plan, step_variant
from ddlpc_tpu_torch.obs.registry import MetricsRegistry
from ddlpc_tpu_torch.ops import cuda_quantize
from ddlpc_tpu_torch.ops.quantize import levels_for
from ddlpc_tpu_torch.parallel import grad_sync, mesh, train_step
from ddlpc_tpu_torch.parallel.compressed_allreduce import wire_dtype
from ddlpc_tpu_torch.parallel.shard_update import LEVEL_CHUNKS, StateLayout, flat_layout
from ddlpc_tpu_torch.parallel.pipeline import stage_program_names
from ddlpc_tpu_torch.utils.fsio import atomic_write_json

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# JAX's audit mesh: 8 replicas (ddlpc_tpu/analysis/program.py AXIS_SIZE),
# split data 4 × space 2 for the space arms.
AXIS_SIZE = 8
SPATIAL_DATA, SPATIAL_SPACE = 4, 2
SERVE_TILES = 4  # the serve arms' one bucket (JAX's _build_serve)
PROGRAM_BASELINE_SCHEMA = 1
DEFAULT_BASELINE = os.path.join(_REPO, "docs", "port_analysis", "program_baseline.json")
BASELINE_MAX_AGE_DAYS = 90.0
INJECTIONS = ("extra-collective", "fp32-widen", "replicated-leaf")
# The arm each injection runs, as JAX's build_injection picks it.
INJECTION_ARMS = {"extra-collective": "int8_simulate", "fp32-widen": "int8_simulate",
                  "replicated-leaf": "none_simulate"}
# JAX's injection with no eager counterpart (a compiled program's fence).
NO_EAGER_INJECTIONS = ("drop-fence",)
DEADLINE_S = 900.0  # a world still running then is killed
_ITEMSIZE = {"s8": 1, "u8": 1, "s16": 2, "f16": 2, "bf16": 2, "s32": 4, "f32": 4,
             "s64": 8, "f64": 8, "pred": 1}


@dataclass(frozen=True)
class Arm:
    """One audited configuration arm (codec × transport × layout), with
    JAX's fields and names."""

    name: str
    mode: str = "none"              # none | int8 | float16
    transport: str = "simulate"     # simulate | ring
    rounding: str = "nearest"
    quantize_local: bool = True
    quantize_mean: bool = True
    shard_update: str = "off"       # off | zero1 | zero2 | zero3
    spatial: bool = False           # data 4 × space 2, the spatial step
    serve_quantize: str = "off"     # serve arms only
    bucket_mb: float = 0.0
    pipeline_stages: int = 1        # the pipe axis (parallel/pipeline.py)

    def compression(self) -> CompressionConfig:
        return CompressionConfig(mode=self.mode, transport=self.transport,
                                 rounding=self.rounding, quantize_local=self.quantize_local,
                                 quantize_mean=self.quantize_mean, bucket_mb=self.bucket_mb)

    @property
    def comm_variant(self) -> str:
        return step_variant(self.compression(), self.shard_update)

    def declared_wire_dtype(self, axis_size: int = AXIS_SIZE) -> str:
        """The dtype the arm claims is on the wire: :func:`declared_wire`."""
        return declared_wire(self.compression(), axis_size)


# JAX's 28 arms (ddlpc_tpu/analysis/program.py ARMS), in its order.
ARMS: Dict[str, Arm] = {
    a.name: a
    for a in (
        Arm("none_simulate"),
        Arm("int8_simulate", mode="int8"),
        Arm("fp16_simulate", mode="float16"),
        Arm("int8_stochastic", mode="int8", rounding="stochastic"),
        Arm("none_zero1", shard_update="zero1"),
        Arm("int8_zero1", mode="int8", shard_update="zero1"),
        Arm("none_zero2", shard_update="zero2"),
        Arm("int8_zero2", mode="int8", shard_update="zero2"),
        Arm("fp16_zero2", mode="float16", shard_update="zero2"),
        Arm("none_zero3", shard_update="zero3"),
        Arm("int8_zero3", mode="int8", shard_update="zero3"),
        Arm("int8_ring", mode="int8", transport="ring"),
        Arm("fp16_ring", mode="float16", transport="ring"),
        Arm("none_gspmd", spatial=True),
        Arm("fp16_gspmd", mode="float16", spatial=True, quantize_local=False),
        Arm("gspmd_zero1", spatial=True, shard_update="zero1"),
        Arm("gspmd_zero2", spatial=True, shard_update="zero2"),
        Arm("gspmd_zero3", spatial=True, shard_update="zero3"),
        Arm("int8_bucketed", mode="int8", bucket_mb=0.02),
        Arm("fp16_bucketed_zero2", mode="float16", shard_update="zero2", bucket_mb=0.02),
        Arm("fp16_bucketed_gspmd", mode="float16", spatial=True, quantize_local=False,
            bucket_mb=0.02),
        Arm("pipe2_none", pipeline_stages=2),
        Arm("pipe2_int8_zero2", mode="int8", shard_update="zero2", pipeline_stages=2),
        Arm("serve_fp32"),
        Arm("serve_int8", serve_quantize="int8"),
        Arm("serve_bf16", serve_quantize="bf16"),
        Arm("eval"),
        Arm("eval_gspmd", spatial=True),
    )
}


def arm_kind(arm: Arm) -> str:
    """``step`` (data parallel), ``spatial``, ``pipeline``, ``serve`` or
    ``eval``."""
    if arm.name.startswith("serve_"):
        return "serve"
    if arm.name.startswith("eval"):
        return "eval"
    if arm.pipeline_stages > 1:
        return "pipeline"
    return "spatial" if arm.spatial else "step"


# The 15 data-parallel arms (part (a) of the port's auditor).
DATA_PARALLEL_ARMS = tuple(n for n, a in ARMS.items() if arm_kind(a) == "step")


def _program_table() -> Dict[str, Tuple[str, str]]:
    """program -> (arm, kind), JAX's ``_program_table`` names and order
    (the data-parallel arms' one program is the port's whole step)."""
    out: Dict[str, Tuple[str, str]] = {}
    for name, arm in ARMS.items():
        kind = arm_kind(arm)
        if kind == "serve":
            out[f"{name}/forward"] = (name, "serve_forward")
        elif kind == "eval":
            out[f"{name}/eval_step"] = (name, "eval_step")
        elif kind == "pipeline":
            S = arm.pipeline_stages
            for s in range(S - 1):
                out[f"{name}/stage{s}_fwd"] = (name, "stage_fwd")
                out[f"{name}/stage{s}_bwd"] = (name, "stage_bwd")
            out[f"{name}/stage{S - 1}_loss_bwd"] = (name, "stage_bwd")
            for s in range(S):
                out[f"{name}/stage{s}_update"] = (name, "stage_update")
        elif kind == "spatial":
            out[f"{name}/train_step"] = (name, "spatial_step")
        else:
            out[f"{name}/step"] = (name, "step")
    return out


PROGRAMS: Dict[str, Tuple[str, str]] = _program_table()


def arm_grid(arm: Arm) -> Optional[Tuple[int, int, int]]:
    """The ``(pipe, data, space)`` grid the arm's world is laid out as
    (JAX's ``_mesh_for``): data 4 × space 2 for the space arms and
    ``eval_gspmd``, pipe 2 × data 4 for the pipeline arms, data 8
    otherwise; None for the serve arms, whose ranks each run alone."""
    kind = arm_kind(arm)
    if kind == "serve":
        return None
    if arm.spatial:
        return 1, SPATIAL_DATA, SPATIAL_SPACE
    return arm.pipeline_stages, AXIS_SIZE // arm.pipeline_stages, 1


def tiny_experiment(arm: Arm) -> ExperimentConfig:
    """The audit model and config, JAX's ``_tiny_experiment``: the U-Net at
    features (8, 16), bottleneck 16, 6 classes, 32² synthetic tiles,
    micro-batch 2 × sync 2, with the arm's codec and mesh."""
    return ExperimentConfig(
        model=ModelConfig(features=(8, 16), bottleneck_features=16, num_classes=6),
        data=DataConfig(dataset="synthetic", image_size=(32, 32), num_classes=6,
                        synthetic_len=64),
        train=TrainConfig(micro_batch_size=2, sync_period=2),
        compression=arm.compression(),
        parallel=ParallelConfig(data_axis_size=SPATIAL_DATA if arm.spatial else -1,
                                space_axis_size=SPATIAL_SPACE if arm.spatial else 1,
                                pipeline_stages=arm.pipeline_stages),
    )


@dataclass
class ProgramViolation:
    program: str
    contract: str
    message: str

    def format(self) -> str:
        return f"VIOLATION {self.program}: [{self.contract}] {self.message}"


# ---------------------------------------------------------------------------
# closed forms


def declared_wire(compression: CompressionConfig, axis_size: int) -> str:
    """The wire dtype a config declares, as HLO names it: the ring's hop
    dtype (``compressed_allreduce.wire_dtype``), the fused simulate path's
    narrow dtype (``grad_sync.simulate_wire_dtype``), else f32."""
    if compression.transport == "ring" and compression.mode != "none":
        return mesh.DTYPE_NAMES[wire_dtype(axis_size, int(levels_for(compression)))]
    wire = grad_sync.simulate_wire_dtype(axis_size, compression)
    return "f32" if wire is None else mesh.DTYPE_NAMES[wire]


def _sent(dtype: str) -> Tuple[str, Optional[str]]:
    """``(dtype handed to torch.distributed, widened_from)`` of a summed
    payload: int16 goes as int32 (C5)."""
    return ("s32", "s16") if dtype == "s16" else (dtype, None)


def codec_calls_per_sync(compression: CompressionConfig, axis_size: int) -> Dict[str, int]:
    """The codec's entry calls one gradient sync makes a bucket, by
    ``cuda_quantize.LAUNCHES`` name: the fused encode's max-abs, encode and
    decode where the wire is narrow (else the local stage's fake-quantize
    and its max-abs), and the mean stage's fake-quantize with its max-abs
    (its own under a whole gradient, the chunk's under a chunked one); the
    ring's max-abs, encode and decode (its mean stage snaps in plain
    PyTorch)."""
    out: Dict[str, int] = collections.Counter()
    if compression.mode == "none":
        return dict(out)
    stochastic = compression.rounding == "stochastic"
    encode = "encode_sr" if stochastic else "encode_to_wire"
    fq = "fake_quantize_sr" if stochastic else "fake_quantize_fused"
    if compression.transport == "ring":
        if axis_size == 1:
            out.update({fq: 2, "absmax": 2})
        else:
            out.update({"absmax": 1, encode: 1, "decode_from_wire": 1})
        return dict(out)
    if grad_sync.simulate_wire_dtype(axis_size, compression) is not None:
        out.update({"absmax": 1, encode: 1, "decode_from_wire": 1})
    elif compression.quantize_local:
        out.update({fq: 1, "absmax": 1})
    if compression.quantize_mean:
        out.update({fq: 1, "absmax": 1})
    return dict(out)


def expected_wire_rows(compression: CompressionConfig, level: str, axis_size: int,
                       regions: Sequence[Tuple[int, int]], n_elements: int, syncs: int = 1,
                       steps: int = 1) -> collections.Counter:
    """The ``wire`` census rows ``(op, reduce, dtype, elements)`` of
    ``steps`` optimizer steps with ``syncs`` gradient syncs among them
    (the comm probe adds syncs), from the config alone: ``regions`` are the
    flat buffer's bucket regions ``(leaf elements, N·rows)``."""
    want: collections.Counter = collections.Counter()
    if axis_size <= 1:
        return want
    declared = declared_wire(compression, axis_size)
    scale = ("all_reduce", "max", "f32", 1)
    if compression.transport == "ring" and compression.mode != "none":
        want[("ring_shift", None, declared, -(-n_elements // axis_size))] += (
            2 * (axis_size - 1) * syncs)
        want[scale] += syncs
    else:
        chunked = LEVEL_CHUNKS[level]["grads"]
        fused = declared != "f32"
        sent, _ = _sent(declared)
        for _, size in regions:
            want[("reduce_scatter" if chunked else "all_reduce", "sum", sent, size)] += syncs
            want[scale] += syncs * (int(fused) + int(
                chunked and compression.mode != "none" and compression.quantize_mean))
    if level != "off":
        for _, size in regions:
            want[("all_gather", None, "f32", size)] += steps
    return +want


def _plan_collective(row: dict, variant: str) -> str:
    """The ``comm_plan`` row a ``wire`` census row's bytes belong to; the
    ring's scale max is no row of the plan (JAX's neither): ``scale``."""
    op = row["op"]
    if op == "all_gather":
        return "all_gather"
    if variant == "ring":
        return "ring_all_reduce" if op == "ring_shift" else "scale"
    if variant in ("scatter", "zero3"):
        return "reduce_scatter" if op in ("reduce_scatter", "all_reduce") else op
    return op


# ---------------------------------------------------------------------------
# the contracts


def check_comm_closed_form(program: str, rows: Sequence[dict], compression: CompressionConfig,
                           level: str, axis_size: int, regions: Sequence[Tuple[int, int]],
                           n_elements: int, syncs: int = 1, steps: int = 1
                           ) -> Tuple[List[ProgramViolation], Dict[str, int]]:
    """The census' ``wire`` rows against ``obs/comm.comm_plan``: the bytes
    of each plan row as a ``CommAccountant`` fed the plan publishes them
    in ``ddlpc_comm_bytes_total{stage="wire"}`` (the gradient row once a
    sync, the params row once a step, the ring's 4-byte scale max apart),
    and the rows per bucket (:func:`expected_wire_rows`).  Returns the
    violations and the gauge's wire bytes by collective."""
    out: List[ProgramViolation] = []
    wire = [r for r in rows if r["role"] == "wire"]
    variant = step_variant(compression, level)
    buffer = sum(size for _, size in regions)
    plan = comm_plan(n_elements, buffer, compression, axis_size, variant,
                     n_buckets=len(regions), level=level)
    registry = MetricsRegistry()
    acct = CommAccountant(registry, plan, variant)
    acct.on_step(steps)
    counter = registry.get("ddlpc_comm_bytes_total")
    gauge = {row["collective"]: int(counter.value(collective=row["collective"], codec=row["codec"],
                                                  stage="wire"))
             for row in plan}
    expected = {}
    for name, total in gauge.items():
        per_step = total // max(steps, 1)
        expected[name] = per_step * (steps if name == "all_gather" else syncs)
    if variant == "ring" and axis_size > 1:
        expected["scale"] = SCALE_BYTES * syncs
    actual: Dict[str, int] = collections.Counter()
    for r in wire:
        actual[_plan_collective(r, variant)] += int(r["bytes"])
    for name in sorted(set(expected) | set(actual)):
        exp, act = expected.get(name, 0), actual.get(name, 0)
        if exp != act:
            out.append(ProgramViolation(
                program, "comm-closed-form",
                f"census wire {name} moves {act} B/replica over {steps} step(s) ({syncs} "
                f"sync(s)) but obs/comm.comm_plan's ddlpc_comm_bytes_total{{stage=\"wire\"}} "
                f"row says {exp} B (variant={variant}, codec={compression.mode}) — the "
                f"collectives and the accounting have drifted"))
    want = expected_wire_rows(compression, level, axis_size, regions, n_elements, syncs, steps)
    got = collections.Counter((r["op"], r["reduce"], r["dtype"], int(r["elements"])) for r in wire)
    for key in sorted(set(want) | set(got), key=str):
        if want[key] != got[key]:
            op, red, dtype, n = key
            out.append(ProgramViolation(
                program, "comm-closed-form",
                f"census has {got[key]} wire {op}{'/' + red if red else ''}[{dtype}] of {n} "
                f"elements but the closed form over {len(regions)} bucket(s) says "
                f"{want[key]}"))
    return out, gauge


def check_dtype_flow(program: str, rows: Sequence[dict], declared: str
                     ) -> Tuple[List[ProgramViolation], List[str]]:
    """No ``wire`` payload (a sum or a ring hop of more than one element)
    wider than ``declared``.  Returns the violations and the named
    exceptions: an int16 wire that ``mesh._widened`` sends as int32 is C5."""
    out: List[ProgramViolation] = []
    exceptions: List[str] = []
    limit = _ITEMSIZE[declared]
    for r in rows:
        if r["role"] != "wire" or r["op"] not in ("all_reduce", "reduce_scatter", "ring_shift"):
            continue
        if int(r["elements"]) <= 1:
            continue  # a scalar control collective (a scale's max)
        dtype = str(r["dtype"])
        if r.get("widened_from") == declared == "s16":
            exceptions.append(
                f"C5: {r['op']} of {r['elements']} {declared} elements goes to "
                f"torch.distributed as {dtype} (neither NCCL nor gloo sums int16)")
            continue
        if _ITEMSIZE[dtype] > limit:
            out.append(ProgramViolation(
                program, "dtype-flow",
                f"{r['op']} wire operand is {dtype} ({_ITEMSIZE[dtype]} B/elt), wider than the "
                f"declared wire dtype {declared} ({limit} B/elt) — quantized gradients widened "
                f"before the wire ({r['elements']} elements)"))
    return out, exceptions


def _leaf_numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def declared_placement(layout: StateLayout, bucket_mb: float, moments: int) -> Dict[str, dict]:
    """Each kind's bytes a replica holds, as ``layout``'s decisions have
    it: ``4·(n + pad)`` whole, ``4·(n + pad)/N`` chunked, with ``n`` the
    leaves' elements (the decisions' shapes) and ``pad`` the flat layout's
    zero tails (``shard_update.flat_layout``, C21) counted apart; the
    moments ``moments`` times the params'."""
    from ddlpc_tpu_torch.parallel import partition

    sizes = [_leaf_numel(leaf.shape) for _, leaf in partition.leaves_with_path(layout.param_avals)]
    _, _, total = flat_layout(sizes, layout.n, bucket_mb)
    n = sum(sizes)
    out = {}
    for kind, copies in (("params", 1), ("grads", 1), ("opt_state", moments)):
        chunked = layout.chunked[kind]
        out[kind] = {"chunked": chunked, "copies": copies, "n": n, "padded": total,
                     "bytes": 4 * copies * (total // layout.n if chunked else total)}
    return out


def measured_placement(state, grads: Sequence[torch.Tensor]) -> Dict[str, int]:
    """The bytes this replica holds after a step, from the tensors
    themselves: the param buffer's storage (none while released) and the
    owned chunks, the optimizer-boundary gradient the sync left
    (``grads``: the chunks of a reduce-scatter, or the whole buffer), and
    the moment buffers."""
    flat = state.params
    params = flat.data.untyped_storage().nbytes()
    if state.owned is not None:
        params += state.owned.numel() * state.owned.element_size()
    return {
        "params": params,
        "grads": sum(g.numel() * g.element_size() for g in grads),
        "opt_state": sum(t.numel() * t.element_size()
                         for t in state.opt_state.buffers().values()),
    }


def check_placement(program: str, measured: Dict[str, int], declared: Dict[str, dict]
                    ) -> List[ProgramViolation]:
    out: List[ProgramViolation] = []
    for kind, want in declared.items():
        got = measured[kind]
        if got == want["bytes"]:
            continue
        detail = (f"silently replicated — wastes {got - want['bytes']} B/replica"
                  if want["chunked"] and got > want["bytes"]
                  else f"declared {'chunked' if want['chunked'] else 'whole'}")
        share = "1/N of " if want["chunked"] else ""
        out.append(ProgramViolation(
            program, "placement",
            f"{kind} holds {got} B on this replica but the StateLayout decides "
            f"{want['bytes']} B ({want['copies']} × 4 B × {share}the flat layout's "
            f"{want['padded']} elements: {want['n']} of leaves, {want['padded'] - want['n']} of "
            f"padding) — {detail}"))
    return out


def check_codec_calls(program: str, calls: Dict[str, int], want: Dict[str, int],
                      launches: Optional[Dict[str, int]] = None) -> List[ProgramViolation]:
    """The census' codec entry calls against the closed form ``want``; on
    a card (``launches``, ``LAUNCHES``' delta over the same stretch) the
    launches must be the calls."""
    out: List[ProgramViolation] = []
    got = {k: v for k, v in calls.items() if v}
    want = {k: v for k, v in want.items() if v}
    if got != want:
        out.append(ProgramViolation(
            program, "codec-calls",
            f"codec entry calls {json.dumps(got, sort_keys=True)}, the closed form says "
            f"{json.dumps(want, sort_keys=True)}"))
    if launches is not None and {k: v for k, v in launches.items() if v} != got:
        out.append(ProgramViolation(
            program, "codec-calls",
            f"kernel launches {json.dumps(launches, sort_keys=True)} are not the census' "
            f"entry calls {json.dumps(got, sort_keys=True)}"))
    return out


def check_step(program: str, census: "mesh.Census", state, compression: CompressionConfig,
               axis_size: int, syncs: int = 1, steps: int = 1,
               declared_layout: Optional[StateLayout] = None,
               launches: Optional[Dict[str, int]] = None) -> dict:
    """Hold a census of ``steps`` optimizer steps of ``state`` (``syncs``
    gradient syncs among them) to the four contracts, declared by the
    config and the state's own placement (``declared_layout``: an
    injection's).  Returns the violations, the named exceptions, the
    gauge's wire bytes, the placement measured and declared, the codec
    calls."""
    flat = state.params
    level = state.placement.level if axis_size > 1 else "off"
    regions = [(leaves, axis_size * rows) for _, leaves, rows in flat.regions]
    declared = declared_wire(compression, axis_size)
    violations, gauge = check_comm_closed_form(program, census.rows, compression, level,
                                               axis_size, regions, flat.numel, syncs, steps)
    flow, exceptions = check_dtype_flow(program, census.rows, declared)
    violations += flow
    bad, placement = _placement(program, census, state, compression, declared_layout)
    violations += bad
    per_sync = codec_calls_per_sync(compression, axis_size)
    want = {k: v * syncs * len(regions) for k, v in per_sync.items()}
    violations += check_codec_calls(program, census.codec, want, launches)
    return dict(_result(program, violations, census, want, placement, declared, exceptions),
                gauge_wire=gauge)


def _placement(program: str, census: "mesh.Census", state, compression: CompressionConfig,
               layout: Optional[StateLayout] = None) -> Tuple[List[ProgramViolation], dict]:
    """``placement``: the state's bytes a kind after the run against what
    ``layout`` (default the state's own) decides; the violations and each
    kind's measured and declared bytes."""
    declared = declared_placement(layout or state.placement, compression.bucket_mb,
                                  len(state.opt_state.buffers()))
    measured = measured_placement(state, census.grads or [state.params.grad])
    return (check_placement(program, measured, declared),
            {k: {"measured": measured[k], **declared[k]} for k in declared})


def _result(program: str, violations: List[ProgramViolation], census: "mesh.Census",
            want: Dict[str, int], placement: Optional[dict] = None,
            declared_wire: Optional[str] = None, exceptions: Sequence[str] = ()) -> dict:
    """One program's audit, as every check returns it."""
    return {"program": program, "violations": violations, "exceptions": list(exceptions),
            "placement": placement or {},
            "codec_calls": {k: v for k, v in census.codec.items() if v}, "codec_want": want,
            "declared_wire": declared_wire}


def codec_calls_on_mean(compression: CompressionConfig) -> Dict[str, int]:
    """The codec's entry calls the spatial step makes a bucket region
    (``train_step.codec_on_mean``): one fake-quantize of the mean with its
    own max-abs; none without a codec."""
    if compression.mode == "none":
        return {}
    fq = "fake_quantize_sr" if compression.rounding == "stochastic" else "fake_quantize_fused"
    return {fq: 1, "absmax": 1}


def check_spatial_step(program: str, census: "mesh.Census", state,
                       compression: CompressionConfig, steps: int = 1,
                       launches: Optional[Dict[str, int]] = None) -> dict:
    """Hold a census of ``steps`` spatial steps of ``state`` to
    ``placement`` and ``codec-calls`` (the space arms' contracts; their
    collectives are pinned by the baseline only)."""
    violations, placement = _placement(program, census, state, compression)
    buckets = len(state.params.regions)
    want = {k: v * steps * buckets for k, v in codec_calls_on_mean(compression).items()}
    violations += check_codec_calls(program, census.codec, want, launches)
    return _result(program, violations, census, want, placement)


def check_stage_segment(program: str, rows: Sequence[dict], stats_elements: int, slots: int,
                        codec: Optional[Dict[str, int]] = None) -> List[ProgramViolation]:
    """``stage-boundary`` over a pipeline segment's census: a segment owns
    no gradient wire.  Its only collectives are the sync-BN statistics'
    sums, f32 all-reduces whose elements total at most 4 × the stage's
    batch-stat elements a micro-batch slot (``slots`` of them: JAX's budget
    a program invocation, and a segment's census holds every invocation of
    a step); its sends are carries (:func:`check_carry_dtypes`) and their
    headers, and it makes no codec call."""
    out: List[ProgramViolation] = []
    budget = 4 * stats_elements * slots
    total = 0
    for r in rows:
        if r["op"] in ("send", "send_header"):
            continue
        if r["op"] != "all_reduce" or r["dtype"] != "f32":
            out.append(ProgramViolation(
                program, "stage-boundary",
                f"census has {r['op']}[{r['dtype']}] of {r['elements']} elements inside a "
                f"pipeline stage segment — segments own no gradient wire; every collective "
                f"belongs to the stage update and the only cross-stage traffic is the carry "
                f"send"))
            continue
        total += int(r["elements"])
    if total > budget:
        out.append(ProgramViolation(
            program, "stage-boundary",
            f"segment all-reduces move {total} f32 elements, over the sync-BN stat budget "
            f"{budget} (4 × {stats_elements} stage batch-stat elements × {slots} slot(s)) — "
            f"a gradient-sized payload leaked into a stage segment"))
    calls = {k: v for k, v in (codec or {}).items() if v}
    if calls:
        out.append(ProgramViolation(
            program, "stage-boundary",
            f"codec entry calls {json.dumps(calls, sort_keys=True)} inside a pipeline stage "
            f"segment — the codec belongs to the stage update"))
    return out


def check_carry_dtypes(program: str, rows: Sequence[dict], carry_dtype: str
                       ) -> List[ProgramViolation]:
    """``stage-boundary``: no carry sent (a ``send`` row) wider than the
    model's compute dtype — promoting a carry doubles the activation sends
    and the GPipe stash."""
    limit = _ITEMSIZE[carry_dtype]
    return [ProgramViolation(
        program, "stage-boundary",
        f"inter-stage carry {r['dtype']} of {r['elements']} elements is wider than the "
        f"declared boundary dtype {carry_dtype} — cross-stage dtype widening")
        for r in rows if r["op"] == "send" and _ITEMSIZE[str(r["dtype"])] > limit]


def check_pipeline_rank(label: str, census: "mesh.Census", drv, pstate,
                        compression: CompressionConfig, steps: int = 1,
                        launches: Optional[Dict[str, int]] = None) -> List[dict]:
    """Hold this rank's census of ``steps`` steps of the pipeline step
    ``drv`` (a ``PipelineTrainStep``) to its stage's programs' contracts: each segment to
    ``stage-boundary`` (the carries at the model's compute dtype), the
    stage update to :func:`check_step` over the stage group.  Returns one
    result a program, ``<label>/<program>``."""
    s, S = drv.stage, drv.n_stages
    state = pstate.stages[0]
    # The stage's batch-stat elements (its running means and variances).
    stats = sum(b.numel() for n, b in state.model.named_buffers()
                if n.endswith(("running_mean", "running_var")))
    carry = mesh.DTYPE_NAMES[getattr(drv._template, "dtype", torch.float32)]
    out = []
    for name in stage_program_names(s, S):
        seg = census.segment(name)
        program = f"{label}/{name}"
        if name.endswith("_update"):
            res = check_step(program, seg, state, compression, drv._n_data, syncs=steps,
                             steps=steps, launches=launches)
        else:
            violations = check_stage_segment(program, seg.rows, stats,
                                             drv.n_microbatches * steps, seg.codec)
            violations += check_carry_dtypes(program, seg.rows, carry)
            res = dict(_result(program, violations, seg, {}, declared_wire=carry),
                       stats_elements=stats)
        res["census"] = seg.rows
        out.append(res)
    return out


def check_serve_forward(program: str, census: "mesh.Census", mode: str, n_leaves: int,
                        forwards: int = 1, launches: Optional[Dict[str, int]] = None) -> dict:
    """A serve forward issues no collective (``comm-closed-form``: its
    closed form is zero), and the int8 weights decode once a leaf and
    forward (``codec-calls``: ``serve/quantized.dequantize_params``);
    fp32 and bf16 decode nothing."""
    violations = []
    if census.rows:
        ops = collections.Counter(r["op"] for r in census.rows)
        violations.append(ProgramViolation(
            program, "comm-closed-form",
            f"a serve forward issues no collective, the census has {dict(ops)}"))
    want = {"decode_from_wire": n_leaves * forwards} if mode == "int8" else {}
    violations += check_codec_calls(program, census.codec, want, launches)
    return _result(program, violations, census, want)


def check_eval_step(program: str, census: "mesh.Census", num_classes: int, axis: str,
                    group: int) -> dict:
    """An eval step's closed form (``comm-closed-form``): one all-reduce
    over its ``axis`` group of ``group`` ranks of the confusion matrix,
    the NLL sum and the pixel count (``num_classes² + 2`` elements,
    float64: ROADMAP C24), none on one rank; and no codec call.  A sharded
    model's halo ``exchange`` rows are the forward's, pinned by the
    baseline."""
    want = collections.Counter()
    if group > 1:
        want[("all_reduce", "sum", "f64", num_classes * num_classes + 2, axis)] = 1
    got = collections.Counter((r["op"], r["reduce"], r["dtype"], int(r["elements"]), r["axis"])
                              for r in census.rows if r["op"] != "exchange")
    violations = [ProgramViolation(
        program, "comm-closed-form",
        f"census has {got[k]} {k[0]}/{k[1]}[{k[2]}] of {k[3]} elements over {k[4]}, the eval "
        f"step's closed form says {want[k]}")
        for k in sorted(set(want) | set(got), key=str) if want[k] != got[k]]
    violations += check_codec_calls(program, census.codec, {})
    return _result(program, violations, census, {})


def inputs_by_dtype(tensors: Sequence[torch.Tensor]) -> List[str]:
    """A forward's inputs as ``dtype|leaves=N|bytes=B`` strings, one a
    dtype (JAX's ``param_dtypes`` and ``argument_bytes``)."""
    out: Dict[str, List[int]] = {}
    for t in tensors:
        row = out.setdefault(mesh.DTYPE_NAMES[t.dtype], [0, 0])
        row[0] += 1
        row[1] += t.numel() * t.element_size()
    return [f"{k}|leaves={n}|bytes={b}" for k, (n, b) in sorted(out.items())]


# ---------------------------------------------------------------------------
# one rank's run of an arm


@contextlib.contextmanager
def _injected(which: Optional[str]) -> Iterator[None]:
    """The step's fault for an injection, held while the step runs."""
    if which == "extra-collective":
        real = train_step.sync_for_level

        def extra(flat, *args, **kwargs):
            out = real(flat, *args, **kwargs)
            smuggled = mesh.all_reduce_(flat[:16].clone(), role="wire")
            flat[:16] += 0.0 * smuggled  # live: the update reads it
            return out

        train_step.sync_for_level = extra
        try:
            yield
        finally:
            train_step.sync_for_level = real
    elif which == "fp32-widen":
        real = grad_sync.simulate_wire_dtype
        grad_sync.simulate_wire_dtype = lambda axis_size, compression: None
        try:
            yield
        finally:
            grad_sync.simulate_wire_dtype = real
    else:
        yield


def run_arm(arm_name: str, device: torch.device, inject: Optional[str] = None) -> List[dict]:
    """One step of ``arm_name`` on this rank, under the census, each of its
    programs this rank holds held to its contracts; one result a program.
    Every rank of the world must call it with the same arm: it lays the
    world out first (:func:`arm_grid`) and forgets the grid after.
    ``inject`` runs a data-parallel arm with one of :data:`INJECTIONS`'
    faults, declaring what the honest arm declares."""
    arm = ARMS[arm_name]
    kind = arm_kind(arm)
    if inject is not None and kind != "step":
        raise ValueError(f"injections run a data-parallel arm, not {arm_name}")
    shape = arm_grid(arm)
    mesh.reset_grid()
    if shape is not None:
        mesh.init_grid(*shape)
    t0 = time.perf_counter()
    try:
        runner = {"step": _run_step_arm, "spatial": _run_spatial_arm,
                  "pipeline": _run_pipeline_arm, "serve": _run_serve_arm,
                  "eval": _run_eval_arm}[kind]
        results = runner(arm, device, inject) if kind == "step" else runner(arm, device)
    finally:
        mesh.reset_grid()
    for res in results:
        res.update(arm=arm_name, inject=inject, rank=mesh.world_rank(),
                   program_kind=PROGRAMS.get(res["program"].split("+")[0], (arm_name, kind))[1],
                   seconds=time.perf_counter() - t0)
        res["violations"] = [v.__dict__ for v in res["violations"]]
    return results


def _launch_delta(before: Dict[str, int], device: torch.device) -> Optional[Dict[str, int]]:
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    return {k: cuda_quantize.LAUNCHES[k] - before[k] for k in before}


def _images(rng, shape, num_classes: int, device: torch.device):
    """``(images, labels)`` of ``shape`` ``[..., H, W]`` from ``rng``."""
    images = torch.from_numpy(rng.uniform(0, 1, (*shape, 3)).astype(np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(0, num_classes, shape).astype(np.int32)).to(device)
    return images, labels


def _run_step_arm(arm: Arm, device: torch.device, inject: Optional[str]) -> List[dict]:
    """One data-parallel step (part (a)), held to :func:`check_step`."""
    from ddlpc_tpu_torch.models import build_model
    from ddlpc_tpu_torch.train.optim import build_optimizer

    cfg = tiny_experiment(arm)
    comp = cfg.compression
    n_rep = mesh.data_size()
    model = build_model(cfg.model, seed=cfg.train.seed).to(device)
    tx = build_optimizer(cfg.train)
    state = train_step.create_train_state(model, tx, n_rep, arm.shard_update, comp.bucket_mb)
    # The state as a step past the first finds it: under zero3 the param
    # buffer released, so that the step gathers it at its head.
    state.release_params()
    step = train_step.make_train_step(tx, comp, n_rep, cfg.train.seed, arm.shard_update)
    rng = np.random.default_rng(1000 + mesh.replica_index())
    h, w = cfg.data.image_size
    images, labels = _images(rng, (cfg.train.sync_period, cfg.train.micro_batch_size, h, w),
                             cfg.model.num_classes, device)
    layout = (StateLayout.from_flat(state.params, tx.layout(), "zero1")
              if inject == "replicated-leaf" else None)
    before = dict(cuda_quantize.LAUNCHES)
    with _injected(inject), mesh.census() as census:
        metrics = step(state, images, labels)
    program = f"{arm.name}/step" + (f"+{inject}" if inject else "")
    # Checked once the fault is gone: the declarations are the honest arm's.
    result = check_step(program, census, state, comp, n_rep, declared_layout=layout,
                        launches=_launch_delta(before, device))
    result.update(loss=_finite(program, metrics["loss"]), n_params=state.params.numel,
                  n_buckets=len(state.params.regions), census=census.rows)
    return [result]


def _finite(program: str, loss) -> float:
    loss = float(loss)
    if not np.isfinite(loss):
        raise RuntimeError(f"{program}: the step's loss is {loss}")
    return loss


def _run_spatial_arm(arm: Arm, device: torch.device) -> List[dict]:
    """One step of ``train_step.make_train_step_spatial`` on this rank of
    the data 4 × space 2 grid, over the sharded model: JAX's global
    micro-batch of 16 tiles, 4 a data shard, this rank its 16 of their 32
    rows; held to :func:`check_spatial_step`."""
    from ddlpc_tpu_torch.models import build_model_from_experiment
    from ddlpc_tpu_torch.train.optim import build_optimizer

    cfg = tiny_experiment(arm)
    comp = cfg.compression
    model = build_model_from_experiment(cfg, 3, SPATIAL_DATA).to(device)
    tx = build_optimizer(cfg.train)
    state = train_step.create_train_state(model, tx, SPATIAL_DATA, arm.shard_update,
                                          comp.bucket_mb)
    state.release_params()
    step = train_step.make_train_step_spatial(tx, comp, SPATIAL_DATA, SPATIAL_SPACE,
                                              cfg.train.seed, arm.shard_update)
    h, w = cfg.data.image_size
    b = cfg.train.micro_batch_size * AXIS_SIZE // SPATIAL_DATA
    rng = np.random.default_rng(1000 + mesh.replica_index())
    images, labels = _images(rng, (cfg.train.sync_period, b, h, w), cfg.model.num_classes, device)
    rows = h // SPATIAL_SPACE
    lo = mesh.space_index() * rows
    images, labels = images[:, :, lo : lo + rows].contiguous(), labels[:, :, lo : lo + rows].contiguous()
    before = dict(cuda_quantize.LAUNCHES)
    with mesh.census() as census:
        metrics = step(state, images, labels)
    program = f"{arm.name}/train_step"
    result = check_spatial_step(program, census, state, comp,
                                launches=_launch_delta(before, device))
    result.update(loss=_finite(program, metrics["loss"]), n_params=state.params.numel,
                  n_buckets=len(state.params.regions), census=census.rows)
    return [result]


def _run_pipeline_arm(arm: Arm, device: torch.device) -> List[dict]:
    """One step of the GPipe schedule (``PipelineTrainStep``) on this rank
    of the pipe 2 × data 4 grid, as JAX's audit builds it
    (``ddlpc_tpu/analysis/program.py:776-806``): M =
    ``sync_period`` micro-batches of a global micro-batch of 8 (each
    replica its 2 columns), sync-BN over the stage's data group; this
    rank's stage's programs held to :func:`check_pipeline_rank`."""
    from ddlpc_tpu_torch.models import build_model_from_experiment
    from ddlpc_tpu_torch.parallel.pipeline import make_pipeline_train_step
    from ddlpc_tpu_torch.train.optim import build_optimizer

    cfg = tiny_experiment(arm)
    comp = cfg.compression
    nd = mesh.data_size()
    model = build_model_from_experiment(cfg, 3, nd)
    tx = build_optimizer(cfg.train)
    full = train_step.create_train_state(model, tx, 1, "off")
    drv = make_pipeline_train_step(model, tx, comp, cfg.train.sync_period, arm.shard_update,
                                   seed=cfg.train.seed, device=device)
    pstate = drv.init_state(full)
    h, w = cfg.data.image_size
    rng = np.random.default_rng(1000)  # the same global micro-batches on every rank
    images, labels = _images(rng, (cfg.train.sync_period, cfg.train.micro_batch_size * nd, h, w),
                             cfg.model.num_classes, torch.device("cpu"))
    before = dict(cuda_quantize.LAUNCHES)
    with mesh.census() as census:
        pstate, metrics = drv.step(pstate, images, labels)
    results = check_pipeline_rank(arm.name, census, drv, pstate, comp,
                                  launches=_launch_delta(before, device))
    loss = _finite(arm.name, metrics["loss"])
    state = pstate.stages[0]
    for res in results:
        res.update(loss=loss, n_params=state.params.numel, n_buckets=len(state.params.regions),
                   stage=drv.stage)
    return results


def _run_serve_arm(arm: Arm, device: torch.device) -> List[dict]:
    """The serve engine's forward (``InferenceEngine.device_logits``) on one
    bucket of :data:`SERVE_TILES` tiles, the weights fp32, int8 or bf16
    (``serve/quantized.quantize_state``), on this rank alone; held to
    :func:`check_serve_forward`, its inputs recorded by dtype."""
    from ddlpc_tpu_torch.models import build_model
    from ddlpc_tpu_torch.serve.engine import InferenceEngine, split_state_dict

    cfg = tiny_experiment(arm)
    model = build_model(cfg.model, seed=cfg.train.seed)
    state = split_state_dict(model, {k: v.detach().clone() for k, v in model.state_dict().items()})
    engine = InferenceEngine(cfg, model, state, 3, max_bucket=SERVE_TILES,
                             quantize=arm.serve_quantize, device=device)
    snap = engine.qstate if arm.serve_quantize != "off" else engine.state
    h, w = cfg.data.image_size
    rng = np.random.default_rng(1000 + mesh.world_rank())
    x, _ = _images(rng, (SERVE_TILES, h, w), cfg.model.num_classes, device)
    tensors = list(snap.params.values())
    if arm.serve_quantize != "off":
        tensors += list(snap.scales.values())
    tensors += list(snap.batch_stats.values()) + [x]
    before = dict(cuda_quantize.LAUNCHES)
    with mesh.census() as census, torch.inference_mode():
        logits = engine.device_logits(snap, x)
    program = f"{arm.name}/forward"
    result = check_serve_forward(program, census, arm.serve_quantize, len(snap.params),
                                 launches=_launch_delta(before, device))
    if logits.shape != (SERVE_TILES, h, w, cfg.model.num_classes) or not bool(
            torch.isfinite(logits).all()):
        raise RuntimeError(f"{program}: logits {tuple(logits.shape)}, not finite or misshapen")
    result.update(n_params=sum(t.numel() for t in snap.params.values()), n_buckets=0,
                  census=census.rows, inputs=inputs_by_dtype(tensors))
    return [result]


def _run_eval_arm(arm: Arm, device: torch.device) -> List[dict]:
    """One ``make_eval_step`` on this rank: over the data axis of 8
    (``eval``, JAX's global batch of 8 tiles, one a rank) or the (data,
    space) group of the sharded model (``eval_gspmd``, 2 tiles a data
    shard, this rank its 16 of their 32 rows); held to
    :func:`check_eval_step`."""
    from ddlpc_tpu_torch.models import build_model_from_experiment
    from ddlpc_tpu_torch.train.optim import build_optimizer

    cfg = tiny_experiment(arm)
    nd = mesh.data_size()
    model = build_model_from_experiment(cfg, 3, nd).to(device)
    state = train_step.create_train_state(model, build_optimizer(cfg.train), nd, "off")
    axis, group = ("stage", nd * mesh.space_size()) if arm.spatial else ("data", nd)
    step = train_step.make_eval_step(cfg.model.num_classes, group, axis)
    h, w = cfg.data.image_size
    rng = np.random.default_rng(1000 + mesh.replica_index())
    images, labels = _images(rng, (AXIS_SIZE // nd, h, w), cfg.model.num_classes, device)
    rows = h // mesh.space_size()
    lo = mesh.space_index() * rows
    images, labels = images[:, lo : lo + rows].contiguous(), labels[:, lo : lo + rows].contiguous()
    with mesh.census() as census:
        out = step(state, images, labels)
    program = f"{arm.name}/eval_step"
    result = check_eval_step(program, census, cfg.model.num_classes, axis, group)
    if float(out["pixel_count"]) != AXIS_SIZE * h * w:
        raise RuntimeError(f"{program}: {float(out['pixel_count'])} pixels counted, "
                           f"not {AXIS_SIZE * h * w}")
    result.update(loss=_finite(program, out["loss_sum"] / out["pixel_count"]),
                  n_params=state.params.numel, n_buckets=len(state.params.regions),
                  census=census.rows)
    return [result]


def census_off_probe(device: torch.device) -> dict:
    """A step of ``int8_zero2`` with the census off after one was on:
    nothing may be recorded (the census and the codec tally stay None)."""
    with mesh.census() as census:
        pass
    from ddlpc_tpu_torch.models import build_model
    from ddlpc_tpu_torch.train.optim import build_optimizer

    arm = ARMS["int8_zero2"]
    cfg = tiny_experiment(arm)
    n_rep = mesh.data_size()
    model = build_model(cfg.model, seed=cfg.train.seed).to(device)
    tx = build_optimizer(cfg.train)
    state = train_step.create_train_state(model, tx, n_rep, arm.shard_update)
    step = train_step.make_train_step(tx, cfg.compression, n_rep, cfg.train.seed, arm.shard_update)
    x = torch.zeros(2, 2, 32, 32, 3, device=device)
    y = torch.zeros(2, 2, 32, 32, dtype=torch.int32, device=device)
    step(state, x, y)
    return {"rows": len(census.rows), "calls": sum(census.codec.values()),
            "census_on": mesh.census_on(), "tally_on": cuda_quantize.CALLS is not None}


# ---------------------------------------------------------------------------
# the world


def _rank_main(workdir: str, device: str) -> None:
    """One rank: join the world, run every job of ``jobs.json`` in order,
    write ``rank<r>.json``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    mesh.initialize_distributed("gloo", f"file://{os.path.join(workdir, 'rendezvous')}")
    with open(os.path.join(workdir, "jobs.json")) as f:
        jobs = json.load(f)
    results = []
    for job in jobs:
        if job.get("probe") == "census-off":
            results.append({"probe": "census-off", **census_off_probe(dev)})
        else:
            results.append(run_arm(job["arm"], dev, job.get("inject")))
        gc.collect()
    atomic_write_json(os.path.join(workdir, f"rank{mesh.world_rank()}.json"),
                      {"rank": mesh.world_rank(), "results": results}, indent=None)
    mesh.destroy_distributed()


def resolve_device(device: str) -> str:
    """``cpu``, or a card (every rank on ``cuda:0`` over gloo); a card
    asked for where there is none raises: nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {device}: no CUDA device here (pass --device cpu)")
        return "cuda:0" if dev.index is None else str(dev)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return "cpu"


def audit(arms: Sequence[str], device: str = "cuda", injections: Sequence[str] = (),
          probes: Sequence[str] = ()) -> dict:
    """Run ``arms``, then the arm of each of ``injections`` with its fault,
    then ``probes`` (``census-off``), in one gloo world of :data:`AXIS_SIZE`
    processes on ``device``; returns ``{"audits": [...], "probes": [...],
    "seconds": s, "device": ..., "world": ...}``, one audit a job with rank
    0's census and every rank's violations (each naming its ranks)."""
    unknown = [a for a in arms if a not in ARMS]
    if unknown:
        raise ValueError(f"unknown arm(s): {', '.join(unknown)} (one of {', '.join(ARMS)})")
    bad = [i for i in injections if i not in INJECTIONS]
    if bad:
        raise ValueError(f"unknown injection(s) {bad} (one of {INJECTIONS})")
    dev = resolve_device(device)
    if dev != "cpu":  # the ranks load the codec's library; build it once, here
        from ddlpc_tpu_torch.kernels.build import build

        build()
    jobs = [{"arm": a} for a in arms]
    jobs += [{"arm": INJECTION_ARMS[i], "inject": i} for i in injections]
    jobs += [{"probe": p} for p in probes]
    workdir = tempfile.mkdtemp(prefix="ddlpc_program_audit_")
    t0 = time.perf_counter()
    try:
        atomic_write_json(os.path.join(workdir, "jobs.json"), jobs, indent=None)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (_REPO, env.get("PYTHONPATH")) if p)
        if dev == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        mesh.spawn_world([sys.executable, "-m", "ddlpc_tpu_torch.analysis.program", "--rank",
                          workdir, dev], AXIS_SIZE, DEADLINE_S, env=env, cwd=_REPO)
        ranks = []
        for r in range(AXIS_SIZE):
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                ranks.append(json.load(f)["results"])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    audits, probe_rows = [], []
    order = {name: i for i, name in enumerate(PROGRAMS)}
    for i, job in enumerate(jobs):
        per_rank = [ranks[r][i] for r in range(AXIS_SIZE)]
        if "probe" in job:
            probe_rows.append({"probe": job["probe"], "ranks": per_rank})
            continue
        holders: Dict[str, List[Tuple[int, dict]]] = {}
        for r, results in enumerate(per_rank):
            for res in results:
                holders.setdefault(res["program"], []).append((r, res))
        for name in sorted(holders, key=lambda n: order.get(n, len(order))):
            audits.append(_merge_ranks(holders[name]))
    return {"audits": audits, "probes": probe_rows, "seconds": time.perf_counter() - t0,
            "device": dev, "world": AXIS_SIZE}


def _merge_ranks(held: List[Tuple[int, dict]]) -> dict:
    """One program's audit from the ranks that hold it: the lowest rank's
    census and numbers, every rank's violations (each naming its ranks)
    and named exceptions."""
    first = dict(held[0][1])
    seen: Dict[Tuple[str, str, str], List[int]] = {}
    for r, res in held:
        for v in res["violations"]:
            seen.setdefault((v["program"], v["contract"], v["message"]), []).append(r)
    first["violations"] = [
        ProgramViolation(p, c, f"{m} (rank{'s' if len(rs) > 1 else ''} "
                               f"{','.join(map(str, rs))})")
        for (p, c, m), rs in seen.items()]
    first["exceptions"] = sorted({e for _, res in held for e in res["exceptions"]})
    first["rank_seconds"] = max(res["seconds"] for _, res in held)
    first["ranks"] = [r for r, _ in held]
    return first


def census_strings(rows: Sequence[dict]) -> List[str]:
    """A census as JAX's record strings, ``op|dtype|axis|role|...``, one a
    distinct row with its count."""
    counts = collections.Counter(
        (r["op"], r["reduce"] or "", r["dtype"], r["axis"], r["role"], int(r["elements"]),
         int(r["bytes"])) for r in rows)
    return [f"{op}{'/' + red if red else ''}|{dtype}|{axis}|{role}|count={c}|elements={n}|"
            f"bytes={b}"
            for (op, red, dtype, axis, role, n, b), c in sorted(counts.items(), key=str)]


def to_record(a: dict) -> dict:
    """A flat ``kind="program"`` record of one audit (unstamped)."""
    wire = [r for r in a["census"] if r["role"] == "wire"]
    return {
        "record": "audit", "program": a["program"], "arm": a["arm"],
        "inject": a["inject"], "program_kind": a["program_kind"],
        "wire_census": census_strings(wire),
        "aux_census": census_strings([r for r in a["census"] if r["role"] == "aux"]),
        "wire_bytes": sum(int(r["bytes"]) for r in wire),
        "declared_wire": a["declared_wire"],
        "codec_calls": [f"{k}={v}" for k, v in sorted(a["codec_calls"].items())],
        "placement": [f"{k}={v['measured']}/{v['bytes']}" for k, v in a["placement"].items()],
        "exceptions": list(a["exceptions"]),
        "inputs": list(a.get("inputs", [])),
        "n_params": a["n_params"], "n_buckets": a["n_buckets"],
        "seconds": round(a["rank_seconds"], 3),
        "violations": len(a["violations"]),
    }


# ---------------------------------------------------------------------------
# the baseline


def baseline_entry(a: dict) -> dict:
    """What the baseline pins of one audit: the whole census (``wire`` and
    ``aux`` rows alike), the codec calls, the placement bytes (measured /
    declared), the named exceptions and, for a forward, its inputs by
    dtype."""
    entry = {
        "census_strings": census_strings(a["census"]),
        "codec_calls": [f"{k}={v}" for k, v in sorted(a["codec_calls"].items())],
        "placement": [f"{k}={v['measured']}/{v['bytes']}" for k, v in a["placement"].items()],
        "exceptions": sorted(a["exceptions"]),
    }
    if a.get("inputs"):
        entry["inputs"] = list(a["inputs"])
    return entry


def build_baseline(audits: Sequence[dict], previous: Optional[dict] = None) -> dict:
    """The baseline of ``audits`` (injections left out), stamped as the
    JAX package's ``build_baseline`` stamps its own; the entries of
    ``previous`` for programs not audited are kept.  Programs in
    :data:`PROGRAMS` order."""
    programs = dict((previous or {}).get("programs", {}))
    programs.update({a["program"]: baseline_entry(a) for a in audits if a.get("inject") is None})
    order = {name: i for i, name in enumerate(PROGRAMS)}
    return {
        "schema": PROGRAM_BASELINE_SCHEMA,
        "generated_by": "python -m ddlpc_tpu_torch.analysis.check --programs --update-baseline",
        "generated_at": time.time(),
        "generated_at_iso": time.strftime("%Y-%m-%dT%H:%M:%S%z", time.localtime()),
        "torch_version": torch.__version__,
        "axis_size": AXIS_SIZE,
        # Structural fields are compared exactly (a census is not a timing).
        "tolerances": {"structural": 0},
        "programs": {k: programs[k] for k in sorted(programs, key=lambda n: (order.get(n, len(order)), n))},
    }


def validate_program_baseline(obj: object) -> List[str]:
    """Schema errors of a decoded baseline (empty: valid)."""
    if not isinstance(obj, dict):
        return ["program baseline is not a JSON object"]
    errs = []
    if obj.get("schema") != PROGRAM_BASELINE_SCHEMA:
        errs.append(f"program baseline schema {obj.get('schema')!r} != {PROGRAM_BASELINE_SCHEMA}")
    programs = obj.get("programs")
    if not isinstance(programs, dict) or not programs:
        return errs + ["program baseline has no 'programs' table"]
    for name, entry in programs.items():
        for key in ("census_strings", "codec_calls", "placement", "exceptions"):
            if not isinstance(entry, dict) or not isinstance(entry.get(key), list):
                errs.append(f"program {name!r}: {key} must be a list")
    return errs


def load_baseline(path: str = DEFAULT_BASELINE) -> dict:
    """The committed baseline at ``path``; raises ``ValueError`` on one the
    schema refuses."""
    with open(path) as f:
        obj = json.load(f)
    errs = validate_program_baseline(obj)
    if errs:
        raise ValueError(f"{path}: {'; '.join(errs)}")
    return obj


def baseline_warnings(baseline: dict, max_age_days: float = BASELINE_MAX_AGE_DAYS,
                      now: Optional[float] = None) -> List[str]:
    """Staleness and provenance warnings, never fatal (JAX's
    ``baseline_warnings``): older than ``max_age_days``, or made under
    another torch.  Only the structure a run compares decides."""
    out = []
    now = time.time() if now is None else now
    at = baseline.get("generated_at")
    if not isinstance(at, (int, float)) or isinstance(at, bool):
        out.append("program baseline has no generated_at stamp — regenerate with "
                   "--update-baseline")
    elif (now - float(at)) / 86400.0 > max_age_days:
        out.append(f"program baseline is {(now - float(at)) / 86400.0:.1f} days old "
                   f"(> {max_age_days:g}) — regenerate with --update-baseline")
    recorded = baseline.get("torch_version")
    if recorded != torch.__version__:
        out.append(f"program baseline was generated under torch {recorded}, this process runs "
                   f"{torch.__version__} — the census compares all the same")
    return out


def compare_to_baseline(a: dict, entry: Optional[dict]) -> List[ProgramViolation]:
    """``census-drift``: every structural difference between an audit and
    its baseline entry, naming the program and the row or field."""
    program = a["program"]
    if entry is None:
        return [ProgramViolation(program, "census-drift",
                                 "program is not in the committed baseline — regenerate "
                                 "docs/port_analysis/program_baseline.json (--update-baseline)")]
    now = baseline_entry(a)
    out = []
    for key in sorted(set(now) | set(entry)):
        got, want = now.get(key, []), entry.get(key, [])
        for row in sorted(set(want) - set(got)):
            out.append(ProgramViolation(program, "census-drift",
                                        f"{key} row {row!r} is in the baseline, not in this run"))
        for row in sorted(set(got) - set(want)):
            out.append(ProgramViolation(program, "census-drift",
                                        f"{key} row {row!r} is in this run, not in the baseline"))
    return out


def drift(audits: Sequence[dict], baseline: dict, every_program: bool) -> List[ProgramViolation]:
    """:func:`compare_to_baseline` over ``audits`` (injections left out);
    ``every_program``: a program of the baseline this run did not audit is
    drift too."""
    programs = baseline["programs"]
    out = []
    seen = set()
    for a in audits:
        if a.get("inject") is None:
            seen.add(a["program"])
            out += compare_to_baseline(a, programs.get(a["program"]))
    if every_program:
        out += [ProgramViolation(name, "census-drift",
                                 "program is in the committed baseline but was not audited")
                for name in programs if name not in seen]
    return out


if __name__ == "__main__":
    if len(sys.argv) != 4 or sys.argv[1] != "--rank":
        sys.exit("usage: python -m ddlpc_tpu_torch.analysis.program --rank WORKDIR DEVICE "
                 "(one rank of the world `python -m ddlpc_tpu_torch.analysis.check --programs` "
                 "starts)")
    _rank_main(sys.argv[2], sys.argv[3])
