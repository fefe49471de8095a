"""The gradient codec in plain PyTorch — the port's copy of
``ddlpc_tpu/ops/quantize.py``.

A "tree" here is a sequence of tensors (the port flattens the gradient
tree into one buffer, which is a one-leaf tree).  The arithmetic is the
reference's, operation for operation, so encode/decode/fake_quantize are
bit-identical to it: ``x / scale`` (IEEE division), ``* levels``,
half-to-even rounding, clip to ±levels, cast to the wire dtype; decode is
one multiply by the runtime scalar ``scale / levels``.

This module is the plain version of the CUDA kernels in
``ops/cuda_quantize.py``: the wrappers there call it for CPU tensors, and
``chip_smoke.py`` holds each kernel against it on the card.  Stochastic
rounding is not ported yet and raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ddlpc_tpu_torch.config import CompressionConfig


class Encoded(NamedTuple):
    """Quantized payload: one global fp32 scale + discretized leaves."""

    scale: torch.Tensor  # 0-dim fp32, the whole-model max-abs
    tree: list  # int8 or fp16 leaves, one per input leaf


def levels_for(cfg: CompressionConfig) -> int:
    """Level count for a quantizing mode; raises on unknown modes."""
    if cfg.mode == "int8":
        if not 0 < cfg.int8_levels <= 127:
            # ±levels must survive the int8 cast: beyond 127 it wraps.
            raise ValueError(f"int8_levels must be in [1, 127], got {cfg.int8_levels}")
        return cfg.int8_levels
    if cfg.mode == "float16":
        if cfg.fp16_levels <= 0:
            raise ValueError(f"fp16_levels must be positive, got {cfg.fp16_levels}")
        return cfg.fp16_levels
    raise ValueError(f"unknown compression mode {cfg.mode!r}")


def wire_dtype_for(cfg: CompressionConfig) -> torch.dtype:
    """The dtype ``encode`` stores lattice values in."""
    return torch.int8 if cfg.mode == "int8" else torch.float16


def check_rounding(cfg: CompressionConfig) -> None:
    """Nearest rounding is ported; stochastic (a Philox draw in the
    kernels) is not yet, and must not silently become nearest."""
    if cfg.rounding == "stochastic":
        raise NotImplementedError(
            "compression.rounding='stochastic' is not yet ported"
        )
    if cfg.rounding != "nearest":
        raise ValueError(f"unknown rounding {cfg.rounding!r}")


def true_div(t: torch.Tensor, divisor: float) -> torch.Tensor:
    """``t / divisor`` as an IEEE division on every device.  (PyTorch's CUDA
    division by a Python number multiplies by its fp32 reciprocal, which
    can differ by an ulp; dividing by a tensor on ``t``'s device does not.)"""
    return t / torch.full((), divisor, dtype=t.dtype, device=t.device)


def snap_to_lattice(scaled: torch.Tensor, levels: float) -> torch.Tensor:
    """Round values in lattice units half-to-even, clipped to ±levels."""
    return torch.clamp(torch.round(scaled), -levels, levels)


def quantize_with_scale(
    x: torch.Tensor, safe_scale: torch.Tensor, levels: float
) -> torch.Tensor:
    """``x/scale·levels`` snapped to the integer lattice, as fp32 lattice
    values.  ``safe_scale`` must already be zero-guarded."""
    return snap_to_lattice(x.float() / safe_scale * levels, levels)


def safe_divisor(scale: torch.Tensor) -> torch.Tensor:
    """Zero-guard: a zero scale divides by 1 (every value is 0 anyway)."""
    return torch.where(scale > 0, scale, torch.ones_like(scale))


def global_absmax(tree: Sequence[torch.Tensor]) -> torch.Tensor:
    """Whole-model max |g| as a 0-dim fp32 tensor (0 for an empty tree)."""
    if not tree:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack([leaf.float().abs().amax() for leaf in tree]).amax()


def encode(tree: Sequence[torch.Tensor], cfg: CompressionConfig) -> Encoded:
    """Quantize a gradient tree.  mode='none' stores fp32 unchanged."""
    scale = global_absmax(tree)
    if cfg.mode == "none":
        return Encoded(scale, [leaf.float() for leaf in tree])
    check_rounding(cfg)
    safe = safe_divisor(scale)
    levels = float(levels_for(cfg))
    wire = wire_dtype_for(cfg)
    return Encoded(
        scale, [quantize_with_scale(leaf, safe, levels).to(wire) for leaf in tree]
    )


def decode(enc: Encoded, cfg: CompressionConfig) -> list:
    """Dequantize: ``q · (scale / levels)`` — one multiply by a runtime
    scalar, so every program rounds it the same way."""
    if cfg.mode == "none":
        return list(enc.tree)
    step = true_div(enc.scale, float(levels_for(cfg)))
    return [q.float() * step for q in enc.tree]


def fake_quantize(tree: Sequence[torch.Tensor], cfg: CompressionConfig) -> list:
    """encode→decode round trip; identity when mode='none'."""
    if cfg.mode == "none":
        return list(tree)
    return decode(encode(tree, cfg), cfg)


def quantization_error_bound(cfg: CompressionConfig) -> float:
    """Max per-element |decode(encode(g)) − g| as a fraction of the global
    absmax: half a step for nearest rounding, a full step for stochastic."""
    if cfg.mode == "none":
        return 0.0
    step = 1.0 / levels_for(cfg)
    return step if cfg.rounding == "stochastic" else 0.5 * step


def encode_with_scale(
    x: torch.Tensor,
    safe_scale: torch.Tensor,
    levels: float,
    wire: torch.dtype,
) -> torch.Tensor:
    """Plain version of the encode kernel: one tensor to its wire dtype
    against a caller-shared scale (the fused all-reduce's convention)."""
    return quantize_with_scale(x, safe_scale, levels).to(wire)


def decode_with_inv(
    q: torch.Tensor, inv: torch.Tensor, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain version of the decode kernel: ``float(q) · inv``."""
    return torch.mul(q.float(), inv, out=out)
