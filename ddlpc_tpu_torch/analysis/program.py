"""The port's program auditor, part (a): a census of one real optimizer
step's collectives and codec calls, held to closed forms — the port's
counterpart of ``ddlpc_tpu/analysis/program.py`` over JAX's 15
data-parallel arms.

What the JAX package does: it lowers its real step builders on
``ShapeDtypeStruct``s and audits the jaxprs and the optimized HLO of its
config arms against ``comm-closed-form``, ``dtype-flow``,
``fence-survival``, ``sharding``, ``donation`` and ``stage-boundary``.

What the port does: it runs eagerly, so there is no program to lower.  An
arm is ONE real optimizer step of ``parallel/train_step.make_train_step``
on every rank of a gloo world of :data:`AXIS_SIZE` processes (the
:func:`tiny_experiment`: the U-Net at features (8, 16), bottleneck 16, 6
classes, 32² tiles, micro-batch 2 × sync 2, 19,366 parameters), with the
census of ``parallel/mesh.py`` on (:func:`mesh.census`): every collective
the step issues, its op, axis, the dtype handed to ``torch.distributed``,
its elements and bytes and its role (``wire``: the gradient sync's and a
ZeRO level's params all-gather, as JAX's ``_classify_wire`` classes them;
``aux``: the rest), and the codec's entry calls by
``ops/cuda_quantize.LAUNCHES`` name.  One world runs every arm in turn.
Each rank holds its own step to four contracts (:func:`check_step`):

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
  each kind (params, grads, optimizer moments), measured from the tensors
  the state holds after the step (the param buffer's storage and the
  owned chunks, the optimizer-boundary gradient the sync left, the
  moment buffers), against what the state's ``StateLayout`` decides for
  the kind: a chunked kind ``(n + pad)/N`` elements, a whole one ``n +
  pad``, with the flat layout's padding ``pad`` (C21) counted apart;
- ``codec-calls`` — the codec's entry calls a sync a bucket against the
  closed form (:func:`codec_calls_per_sync`, the ``per_bucket`` table
  ``chip_smoke.py`` holds on the card); on a card the census' calls must
  also equal ``LAUNCHES``' delta.

No eager counterpart, and no stand-in: ``fence-survival`` (an
``optimization_barrier`` surviving XLA's passes) and ``donation`` (a
donated buffer input/output-aliased in a compiled module) are properties
of a compiled program, which the port does not have.  What a compiler
would take from the port, the checker's ``jit-host-call`` and
``codec-fence`` rules already guard.  So ``--inject drop-fence`` has no
counterpart either.

The three injections that have one (:data:`INJECTIONS`) run one arm with a
deliberate fault and must be caught: ``extra-collective`` (one more live
``wire`` all-reduce in ``int8_simulate`` → ``comm-closed-form``),
``fp32-widen`` (``simulate_wire_dtype`` patched to None while
``int8_simulate`` declares its honest s8 → ``dtype-flow``) and
``replicated-leaf`` (``none_simulate``'s moments declared chunked but held
whole → ``placement``).

The space, pipeline, serve and eval arms and a per-arm baseline are part
(b) (ROADMAP A8.3).  ``python -m ddlpc_tpu_torch.analysis.check
--programs`` is the CLI; this module's ``__main__`` is one rank of the
world it starts.
"""

from __future__ import annotations

import collections
import contextlib
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
from ddlpc_tpu_torch.utils.fsio import atomic_write_json

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# JAX's audit mesh: 8 replicas (ddlpc_tpu/analysis/program.py AXIS_SIZE).
AXIS_SIZE = 8
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
    spatial: bool = False           # part (b)
    serve_quantize: str = "off"     # part (b)
    bucket_mb: float = 0.0
    pipeline_stages: int = 1        # part (b)

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


# JAX's 15 data-parallel arms (ddlpc_tpu/analysis/program.py ARMS), in
# its order; its space, pipeline, serve and eval arms are part (b).
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
        Arm("int8_bucketed", mode="int8", bucket_mb=0.02),
        Arm("fp16_bucketed_zero2", mode="float16", shard_update="zero2", bucket_mb=0.02),
    )
}


def tiny_experiment(arm: Arm) -> ExperimentConfig:
    """The audit model and config, JAX's ``_tiny_experiment``: the U-Net at
    features (8, 16), bottleneck 16, 6 classes, 32² synthetic tiles,
    micro-batch 2 × sync 2, with the arm's codec."""
    return ExperimentConfig(
        model=ModelConfig(features=(8, 16), bottleneck_features=16, num_classes=6),
        data=DataConfig(dataset="synthetic", image_size=(32, 32), num_classes=6,
                        synthetic_len=64),
        train=TrainConfig(micro_batch_size=2, sync_period=2),
        compression=arm.compression(),
        parallel=ParallelConfig(data_axis_size=-1, space_axis_size=1, pipeline_stages=1),
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
    layout = declared_layout or state.placement
    placement = declared_placement(layout, compression.bucket_mb, len(state.opt_state.buffers()))
    measured = measured_placement(state, census.grads or [flat.grad])
    violations += check_placement(program, measured, placement)
    per_sync = codec_calls_per_sync(compression, axis_size)
    want = {k: v * syncs * len(regions) for k, v in per_sync.items()}
    violations += check_codec_calls(program, census.codec, want, launches)
    return {
        "program": program, "violations": violations, "exceptions": exceptions,
        "gauge_wire": gauge, "placement": {k: {"measured": measured[k], **placement[k]}
                                           for k in placement},
        "codec_calls": {k: v for k, v in census.codec.items() if v}, "codec_want": want,
        "declared_wire": declared,
    }


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


def run_arm(arm_name: str, device: torch.device, inject: Optional[str] = None) -> dict:
    """One optimizer step of ``arm_name`` on this rank, under the census,
    held to the contracts (:func:`check_step`).  Every rank of the world
    must call it with the same arm.  ``inject`` runs the arm with one of
    :data:`INJECTIONS`' faults, declaring what the honest arm declares."""
    from ddlpc_tpu_torch.models import build_model
    from ddlpc_tpu_torch.train.optim import build_optimizer

    arm = ARMS[arm_name]
    cfg = tiny_experiment(arm)
    comp = cfg.compression
    n_rep = mesh.data_size()
    t0 = time.perf_counter()
    model = build_model(cfg.model, seed=cfg.train.seed).to(device)
    tx = build_optimizer(cfg.train)
    state = train_step.create_train_state(model, tx, n_rep, arm.shard_update, comp.bucket_mb)
    # The state as a step past the first finds it: under zero3 the param
    # buffer released, so that the step gathers it at its head.
    state.release_params()
    step = train_step.make_train_step(tx, comp, n_rep, cfg.train.seed, arm.shard_update)
    rng = np.random.default_rng(1000 + mesh.replica_index())
    a, b = cfg.train.sync_period, cfg.train.micro_batch_size
    h, w = cfg.data.image_size
    images = torch.from_numpy(rng.uniform(0, 1, (a, b, h, w, 3)).astype(np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(0, cfg.model.num_classes, (a, b, h, w))
                              .astype(np.int32)).to(device)
    layout = (StateLayout.from_flat(state.params, tx.layout(), "zero1")
              if inject == "replicated-leaf" else None)
    before = dict(cuda_quantize.LAUNCHES)
    with _injected(inject), mesh.census() as census:
        metrics = step(state, images, labels)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    launches = ({k: cuda_quantize.LAUNCHES[k] - before[k] for k in before}
                if device.type == "cuda" else None)
    program = f"{arm_name}/step" + (f"+{inject}" if inject else "")
    # Checked once the fault is gone: the declarations are the honest arm's.
    result = check_step(program, census, state, comp, n_rep, declared_layout=layout,
                        launches=launches)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"{program}: the step's loss is {loss}")
    result.update(arm=arm_name, inject=inject, rank=mesh.world_rank(), loss=loss,
                  n_params=state.params.numel, n_buckets=len(state.params.regions),
                  census=census.rows, seconds=time.perf_counter() - t0)
    result["violations"] = [v.__dict__ for v in result["violations"]]
    return result


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
    for i, job in enumerate(jobs):
        per_rank = [ranks[r][i] for r in range(AXIS_SIZE)]
        if "probe" in job:
            probe_rows.append({"probe": job["probe"], "ranks": per_rank})
            continue
        first = dict(per_rank[0])
        seen: Dict[Tuple[str, str, str], List[int]] = {}
        for r, res in enumerate(per_rank):
            for v in res["violations"]:
                seen.setdefault((v["program"], v["contract"], v["message"]), []).append(r)
        first["violations"] = [
            ProgramViolation(p, c, f"{m} (rank{'s' if len(rs) > 1 else ''} "
                                   f"{','.join(map(str, rs))})")
            for (p, c, m), rs in seen.items()]
        first["exceptions"] = sorted({e for res in per_rank for e in res["exceptions"]})
        first["rank_seconds"] = max(res["seconds"] for res in per_rank)
        audits.append(first)
    return {"audits": audits, "probes": probe_rows, "seconds": time.perf_counter() - t0,
            "device": dev, "world": AXIS_SIZE}


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
        "inject": a["inject"], "program_kind": "step",
        "wire_census": census_strings(wire),
        "aux_census": census_strings([r for r in a["census"] if r["role"] == "aux"]),
        "wire_bytes": sum(int(r["bytes"]) for r in wire),
        "declared_wire": a["declared_wire"],
        "codec_calls": [f"{k}={v}" for k, v in sorted(a["codec_calls"].items())],
        "placement": [f"{k}={v['measured']}/{v['bytes']}" for k, v in a["placement"].items()],
        "exceptions": list(a["exceptions"]),
        "n_params": a["n_params"], "n_buckets": a["n_buckets"],
        "seconds": round(a["rank_seconds"], 3),
        "violations": len(a["violations"]),
    }


if __name__ == "__main__":
    if len(sys.argv) != 4 or sys.argv[1] != "--rank":
        sys.exit("usage: python -m ddlpc_tpu_torch.analysis.program --rank WORKDIR DEVICE "
                 "(one rank of the world `python -m ddlpc_tpu_torch.analysis.check --programs` "
                 "starts)")
    _rank_main(sys.argv[2], sys.argv[3])
