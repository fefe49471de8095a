"""Weight-quantized inference state: int8 / bf16 params, the model's own
math — the port of ``ddlpc_tpu/serve/quantized.py``.

Serving weights are static between reloads, so their scales are computed
ONCE per restore (not per request), one max-abs scale per param leaf.

Scheme, per param leaf (``model.named_parameters()``: conv kernels and
biases, and BatchNorm's weight and bias, which flax keeps under
``params`` too):

- ``int8``: ``q = clip(rint(leaf / safe · 127), ±127)`` as int8 with
  ``safe = safe_divisor(max |leaf|)`` and the scale ``safe / 127`` (an
  IEEE division, ``ops/quantize.true_div``, as JAX's eager ``safe /
  127.0``).  On a card the three steps are the codec's kernels:
  ``cuda_quantize.absmax`` (``absmax.cu``), then ``encode_to_wire`` at
  levels 127 onto the int8 wire (``quantize.cu``, the formula of
  ``_encode_kernel``); on the CPU the same wrappers take their plain
  versions.  Dequantization is ``decode_from_wire(q, inv=scale)``,
  ``float(q) · scale``, in every forward: the dequantized fp32 tensors are
  transient, only the int8 leaves and their scales stay resident;
- ``bf16``: a round-to-nearest-even cast (``Tensor.to``), widened back to
  fp32 in every forward; its scales are all-ones placeholders, so the
  state has one structure in both modes (and the same byte count as
  JAX's, which keeps them too);
- ``off``: identity (the engine never calls in here).

The BatchNorm running statistics (``model.named_buffers()``, flax's
``batch_stats``) are never quantized.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ddlpc_tpu_torch.config import CompressionConfig
from ddlpc_tpu_torch.ops import cuda_quantize as cq
from ddlpc_tpu_torch.ops.quantize import safe_divisor, true_div

MODES = ("off", "int8", "bf16")

# The codec at the serving lattice: levels 127, nearest rounding.
INT8_CODEC = CompressionConfig(mode="int8", int8_levels=127)


class QuantizedState(NamedTuple):
    """Resident quantized inference state, keyed by the model's parameter
    and buffer names.  ``scales`` holds one 1-element fp32 tensor a param
    (ones for bf16)."""

    params: Dict[str, torch.Tensor]  # int8 or bf16, each leaf's own shape
    scales: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]  # fp32, untouched


def check_mode(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(
            f"unknown weight-quantization mode {mode!r} "
            f"(expected one of {MODES})"
        )
    return mode


def quantize_error_bound(mode: str) -> float:
    """Worst-case per-weight |dequant - original| as a fraction of the
    leaf's absmax: half an int8 lattice step, or bf16's 8-bit mantissa
    rounding."""
    check_mode(mode)
    if mode == "int8":
        return 0.5 / 127.0
    if mode == "bf16":
        return 2.0 ** -8
    return 0.0


def _quantize_leaf(p: torch.Tensor, mode: str):
    p32 = p.detach().to(torch.float32).contiguous()
    if mode == "bf16":
        return p32.to(torch.bfloat16), torch.ones(1, dtype=torch.float32, device=p.device)
    flat = p32.reshape(-1)  # a fresh leaf: its own 16-byte aligned storage
    safe = safe_divisor(cq.absmax(flat))
    q = cq.encode_to_wire(flat, safe, INT8_CODEC, torch.int8)
    return q.view(p.shape), true_div(safe, 127.0)


def quantize_state(
    params: Dict[str, torch.Tensor],
    batch_stats: Dict[str, torch.Tensor],
    mode: str,
    device=None,
) -> QuantizedState:
    """Quantize restored params for serving, leaf by leaf, on ``device``
    (default: each leaf's own); each fp32 leaf is on the device only while
    it is quantized.  Runs ONCE per restore/reload: scales depend on the
    checkpoint, not on traffic."""
    check_mode(mode)
    if mode == "off":
        raise ValueError("quantize_state needs mode 'int8' or 'bf16'")
    qp, scales = {}, {}
    for name, p in params.items():
        qp[name], scales[name] = _quantize_leaf(p if device is None else p.to(device), mode)
    stats = {
        k: (v if device is None else v.to(device)).to(torch.float32).contiguous()
        for k, v in batch_stats.items()
    }
    return QuantizedState(qp, scales, stats)


def dequantize_params(qstate: QuantizedState, mode: str) -> Dict[str, torch.Tensor]:
    """fp32 params from the quantized state: ``float(q) · scale`` a leaf
    (the decode kernel on a card), or the bf16 leaf widened."""
    if mode == "bf16":
        return {k: q.to(torch.float32) for k, q in qstate.params.items()}
    return {
        k: cq.decode_from_wire(q.reshape(-1), qstate.scales[k]).view(q.shape)
        for k, q in qstate.params.items()
    }


def tree_nbytes(tree: Dict[str, torch.Tensor]) -> int:
    """Resident bytes of a dict of tensors (elements × itemsize)."""
    return sum(t.numel() * t.element_size() for t in tree.values())


def state_nbytes(state) -> dict:
    """``{params: bytes, batch_stats: bytes}`` of a :class:`QuantizedState`
    (its scales counted with the params) or of an fp32 ``(params,
    batch_stats)`` pair — what ``ddlpc_hbm_bytes{kind}`` reports."""
    if isinstance(state, QuantizedState):
        return {
            "params": tree_nbytes(state.params) + tree_nbytes(state.scales),
            "batch_stats": tree_nbytes(state.batch_stats),
        }
    params, batch_stats = state
    return {"params": tree_nbytes(params), "batch_stats": tree_nbytes(batch_stats)}
