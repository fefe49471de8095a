"""Communication accounting: the exact bytes each collective of a step
moves — the port's copy of ``comm_plan`` and ``CommAccountant`` from
``ddlpc_tpu/obs/comm.py``, over the port's ``parallel/grad_sync.py``.

The step variants are the JAX package's (:func:`step_variant`):
``allreduce`` (``shard_update='off'``, the fused all-reduce), ``zero1``
(the same all-reduce, then the all-gather of the params), ``scatter``
(``zero2``: the reduce-scatter of the gradient, then the all-gather of the
params), ``zero3`` (the same two collectives, the all-gather at the head
of the next step) and ``ring`` (``compression.transport='ring'``).  Each
row carries:

- ``bytes_pre``: the fp32 bytes of the ``n`` gradients entering the codec,
  ``n · 4``, as in JAX;
- ``bytes_post``: the codec's declared payload, ``n`` times the wire
  mode's itemsize plus one fp32 scale a bucket, as in JAX;
- ``wire_dtype`` and ``bytes_wire``: what the port's collectives really
  move.  The operand is the whole flat buffer, every bucket region's
  ``N·K_b`` elements with the alignment padding
  (``shard_update.region_rows``; JAX's row counts ``n``), plus 4 bytes a
  bucket for each max-abs all-reduce of the codec's scale (one for the
  fused encode's shared scale, one more under ``zero2``/``zero3`` for the
  mean stage's max over the chunks).  Neither NCCL nor gloo sums int16,
  so the int16 wire moves int32 (ROADMAP C5): there ``wire_dtype`` is
  ``s32``, 4 bytes an element against JAX's 2, and the row says
  ``widened_from: s16``.

The ring's row is ``ring_wire_report``'s, the JAX package's integers:
2(N−1) hops of ``ceil(n/N)`` elements in the hop's own dtype, which is
what the port's point-to-point hops move (the shared scale's 4-byte max
is not counted, as in JAX).  Under ``zero1`` the ring is followed by the
params' all-gather, which the JAX package's plan leaves out (its ``ring``
variant wins over ``zero1``); the port counts it in a second row.

One replica communicates nothing: an empty plan.  JAX's fenced comm-time
probe runs only under ``train.trace``, which the port does not have yet
(ROADMAP A9).
"""

from __future__ import annotations

import threading
from typing import Dict, List

import torch

# Wire itemsize of each codec mode's declared payload.
CODEC_ITEMSIZE = {"none": 4, "int8": 1, "float16": 2}
SCALE_BYTES = 4  # one fp32 max-abs scale
_WIRE_NAMES = {torch.int8: ("s8", 1), torch.int16: ("s32", 4), torch.float16: ("f16", 2)}
VARIANTS = ("allreduce", "zero1", "scatter", "zero3", "ring")


def codec_payload_bytes(n_elements: int, mode: str, n_scales: int = 1) -> int:
    """The codec's declared payload for ``n_elements``: the wire dtype's
    bytes plus one fp32 scale a bucket (quantizing modes only)."""
    if mode not in CODEC_ITEMSIZE:
        raise ValueError(f"unknown compression mode {mode!r}")
    return n_elements * CODEC_ITEMSIZE[mode] + (SCALE_BYTES * n_scales if mode != "none" else 0)


def step_variant(compression, level: str) -> str:
    """The comm plan's variant of a resolved ZeRO level, as the JAX
    trainer picks it: the ring over every level, then ``scatter`` for
    zero2, the level's own name for zero1 and zero3, else ``allreduce``."""
    if compression.transport == "ring" and compression.mode != "none":
        return "ring"
    return {"zero2": "scatter", "zero1": "zero1", "zero3": "zero3"}.get(level, "allreduce")


def _params_row(n_elements: int, buffer_elements: int) -> Dict[str, object]:
    return {
        "collective": "all_gather",
        "codec": "none",
        "bytes_pre": n_elements * 4,
        "bytes_post": n_elements * 4,
        "wire_dtype": "f32",
        "bytes_wire": buffer_elements * 4,
    }


def comm_plan(
    n_elements: int, buffer_elements: int, compression, axis_size: int, variant: str,
    n_buckets: int = 1, level: str = "off",
) -> List[Dict[str, object]]:
    """Rows of the collectives one optimizer step issues: ``n_elements``
    gradients in flat buffers of ``buffer_elements`` (``n_buckets``
    regions) over ``axis_size`` replicas.  ``level`` matters to the ring
    only (zero1 adds the params' all-gather)."""
    from ddlpc_tpu_torch.parallel.compressed_allreduce import ring_wire_report
    from ddlpc_tpu_torch.parallel.grad_sync import simulate_wire_dtype

    if variant not in VARIANTS:
        raise ValueError(f"unknown comm plan variant {variant!r} (one of {VARIANTS})")
    if axis_size <= 1:
        return []
    mode = compression.mode
    if variant == "ring":
        rep = ring_wire_report(n_elements, axis_size, compression)
        name = {"int8": "s8", "int16": "s16", "float32": "f32"}[rep["wire_dtype"]]
        rows = [{
            "collective": "ring_all_reduce",
            "codec": mode,
            "bytes_pre": rep["fp32_bytes_per_replica"],
            "bytes_post": rep["wire_bytes_per_replica"],
            "wire_dtype": name,
            "bytes_wire": rep["wire_bytes_per_replica"],
        }]
        return rows + ([_params_row(n_elements, buffer_elements)] if level == "zero1" else [])
    wire_mode = mode if (mode != "none" and compression.quantize_local) else "none"
    wire = simulate_wire_dtype(axis_size, compression)
    wire_name, wire_item = _WIRE_NAMES[wire] if wire is not None else ("f32", 4)
    scatter = variant in ("scatter", "zero3")
    scales = 1 if wire is not None else 0
    if scatter and mode != "none" and compression.quantize_mean:
        scales += 1
    grad_row = {
        "collective": "reduce_scatter" if scatter else "all_reduce",
        "codec": wire_mode,
        "bytes_pre": n_elements * 4,
        "bytes_post": codec_payload_bytes(n_elements, wire_mode, n_buckets),
        "wire_dtype": wire_name,
        "bytes_wire": buffer_elements * wire_item + SCALE_BYTES * scales * n_buckets,
    }
    if wire == torch.int16:
        grad_row["widened_from"] = "s16"
    if variant == "allreduce":
        return [grad_row]
    return [grad_row, _params_row(n_elements, buffer_elements)]


class CommAccountant:
    """``on_step`` (once an optimizer step) adds the plan's rows to
    ``ddlpc_comm_bytes_total{collective,codec,stage}``; ``publish``
    returns the flat ``kind="comm"`` record."""

    def __init__(self, registry, plan: List[Dict[str, object]], variant: str):
        self.plan = list(plan)
        self.variant = variant
        self._lock = threading.Lock()
        self._steps = 0
        self._bytes = registry.counter(
            "ddlpc_comm_bytes_total",
            "Collective payload bytes per replica (pre_codec = fp32 entering "
            "the codec, post_codec = the codec's declared payload, wire = the "
            "bytes the collectives move).",
            labelnames=("collective", "codec", "stage"),
        )
        ratio = registry.gauge(
            "ddlpc_comm_compression_ratio",
            "Pre/post codec byte ratio per collective.",
            labelnames=("collective",),
        )
        for row in self.plan:
            ratio.set(row["bytes_pre"] / max(row["bytes_post"], 1), collective=row["collective"])

    def on_step(self, n: int = 1) -> None:
        for row in self.plan:
            for stage, key in (("pre_codec", "bytes_pre"), ("post_codec", "bytes_post"),
                               ("wire", "bytes_wire")):
                self._bytes.inc(row[key] * n, collective=row["collective"],
                                codec=row["codec"], stage=stage)
        with self._lock:
            self._steps += n

    def publish(self) -> Dict[str, object]:
        with self._lock:
            steps = self._steps
        rec: Dict[str, object] = {"kind": "comm", "variant": self.variant, "steps": steps}
        for row in self.plan:
            name = str(row["collective"])
            rec[f"{name}_bytes_pre_per_step"] = row["bytes_pre"]
            rec[f"{name}_bytes_post_per_step"] = row["bytes_post"]
            rec[f"{name}_codec"] = row["codec"]
            rec[f"{name}_wire_dtype"] = row["wire_dtype"]
            rec[f"{name}_bytes_wire_per_step"] = row["bytes_wire"]
            rec[f"{name}_compression_ratio"] = round(row["bytes_pre"] / max(row["bytes_post"], 1), 4)
            if "widened_from" in row:
                rec[f"{name}_wire_widened_from"] = row["widened_from"]
        return rec
