"""Communication accounting: the exact bytes each collective of a step
moves — the port's copy of ``comm_plan`` and ``CommAccountant`` from
``ddlpc_tpu/obs/comm.py``, over the port's ``parallel/grad_sync.py``.

Two step variants are ported: ``allreduce`` (``shard_update='off'``, the
fused all-reduce) and ``scatter`` (``zero2``: the reduce-scatter of the
gradient, then the all-gather of the params).  Each row carries:

- ``bytes_pre``: the fp32 bytes of the ``n`` gradients entering the codec,
  ``n · 4``, as in JAX;
- ``bytes_post``: the codec's declared payload, ``n`` times the wire
  mode's itemsize plus one fp32 scale, as in JAX;
- ``wire_dtype`` and ``bytes_wire``: what the port's collectives really
  move.  The operand is the whole flat buffer, ``N·K`` elements with the
  alignment padding (``shard_update.flat_chunk_rows``; JAX's row counts
  ``n``), plus 4 bytes for each max-abs all-reduce of the codec's scale
  (one for the fused encode's shared scale, one more under ``zero2`` for
  the mean stage's max over the chunks).  Neither NCCL nor gloo sums
  int16, so the int16 wire moves int32 (ROADMAP C5): there ``wire_dtype``
  is ``s32``, 4 bytes an element against JAX's 2, and the row says
  ``widened_from: s16``.

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


def codec_payload_bytes(n_elements: int, mode: str) -> int:
    """The codec's declared payload for ``n_elements``: the wire dtype's
    bytes plus one fp32 scale (quantizing modes only)."""
    if mode not in CODEC_ITEMSIZE:
        raise ValueError(f"unknown compression mode {mode!r}")
    return n_elements * CODEC_ITEMSIZE[mode] + (SCALE_BYTES if mode != "none" else 0)


def comm_plan(
    n_elements: int, buffer_elements: int, compression, axis_size: int, variant: str
) -> List[Dict[str, object]]:
    """Rows of the collectives one optimizer step issues: ``n_elements``
    gradients in a flat buffer of ``buffer_elements`` over ``axis_size``
    replicas, ``variant`` ``allreduce`` or ``scatter``."""
    from ddlpc_tpu_torch.parallel.grad_sync import simulate_wire_dtype

    if variant not in ("allreduce", "scatter"):
        raise ValueError(f"unknown comm plan variant {variant!r} (allreduce or scatter)")
    if axis_size <= 1:
        return []
    mode = compression.mode
    wire_mode = mode if (mode != "none" and compression.quantize_local) else "none"
    wire = simulate_wire_dtype(axis_size, compression)
    wire_name, wire_item = _WIRE_NAMES[wire] if wire is not None else ("f32", 4)
    scales = 1 if wire is not None else 0
    if variant == "scatter" and mode != "none" and compression.quantize_mean:
        scales += 1
    grad_row = {
        "collective": "all_reduce" if variant == "allreduce" else "reduce_scatter",
        "codec": wire_mode,
        "bytes_pre": n_elements * 4,
        "bytes_post": codec_payload_bytes(n_elements, wire_mode),
        "wire_dtype": wire_name,
        "bytes_wire": buffer_elements * wire_item + SCALE_BYTES * scales,
    }
    if wire == torch.int16:
        grad_row["widened_from"] = "s16"
    if variant == "allreduce":
        return [grad_row]
    return [grad_row, {
        "collective": "all_gather",
        "codec": "none",
        "bytes_pre": n_elements * 4,
        "bytes_post": n_elements * 4,
        "wire_dtype": "f32",
        "bytes_wire": buffer_elements * 4,
    }]


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
