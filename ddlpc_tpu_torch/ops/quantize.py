"""The gradient codec in plain PyTorch — the port's copy of
``ddlpc_tpu/ops/quantize.py``.

A "tree" here is a sequence of tensors (the port flattens the gradient
tree into one buffer, which is a one-leaf tree).  The arithmetic is the
reference's, operation for operation, so encode/decode/fake_quantize are
bit-identical to it: ``x / scale`` (IEEE division), ``* levels``,
half-to-even rounding, clip to ±levels, cast to the wire dtype; decode is
one multiply by the runtime scalar ``scale · rn(1/levels)``, the JAX
package's ``scale / levels`` as XLA compiles it (a division by a constant
becomes a multiply by its reciprocal).

This module is the plain version of the CUDA kernels in
``ops/cuda_quantize.py``: the wrappers there call it for CPU tensors, and
``chip_smoke.py`` holds each kernel against it on the card.

Stochastic rounding snaps ``floor(v + u)`` with ``u`` from U[0,1): either a
field the caller hands in (``noise=``, the JAX package's ``snap_to_lattice
(noise=)``) or the Philox stream of a key from ``offset`` on (``key=``,
``ops/philox.py``), which is what the CUDA kernels draw in registers.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ddlpc_tpu_torch.config import CompressionConfig
from ddlpc_tpu_torch.ops import philox
from ddlpc_tpu_torch.ops.philox import PhiloxKey


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
    """Raise on a rounding the codec does not know."""
    if cfg.rounding not in ("nearest", "stochastic"):
        raise ValueError(f"unknown rounding {cfg.rounding!r}")


def rounding_key(
    cfg: CompressionConfig, key: Optional[PhiloxKey], noise
) -> Tuple[Optional[PhiloxKey], object]:
    """The ``(key, noise)`` a codec call uses under ``cfg``: neither for
    nearest rounding (a key is ignored, as in the JAX package); exactly one
    for stochastic, which raises without either, so a stochastic config
    can never silently round to nearest."""
    check_rounding(cfg)
    if cfg.rounding == "nearest":
        if noise is not None:
            raise ValueError("noise given for rounding='nearest'")
        return None, None
    if key is not None and noise is not None:
        raise ValueError("pass either key or noise, not both")
    if key is None and noise is None:
        raise ValueError(
            "rounding='stochastic' needs a key or a noise field (the train "
            "step derives the key from train.seed and the step counter)"
        )
    return key, noise


def true_div(t: torch.Tensor, divisor: float) -> torch.Tensor:
    """``t / divisor`` as an IEEE division on every device.  (PyTorch's CUDA
    division by a Python number multiplies by its fp32 reciprocal, which
    can differ by an ulp; dividing by a tensor on ``t``'s device does not.)"""
    return t / torch.full((), divisor, dtype=t.dtype, device=t.device)


def times_reciprocal(t: torch.Tensor, divisor: float) -> torch.Tensor:
    """``t · rn(1 / divisor)``, the fp32 reciprocal rounded once: what XLA
    compiles the JAX codec's ``t / divisor`` into when the divisor is a
    constant of the program (``levels``, ``levels · axis_size``), as it is
    in every jitted train step.  (Eager JAX divides; the two agree where
    ``t`` is a power of two, and may differ by an ulp elsewhere.)"""
    one = torch.ones((), dtype=torch.float32)
    return t * float(one / torch.full((), divisor, dtype=torch.float32))


def snap_to_lattice(
    scaled: torch.Tensor, levels: float, noise: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Snap values in lattice units to integers, clipped to ±levels:
    half-to-even without ``noise``, ``floor(scaled + noise)`` with it."""
    snapped = torch.round(scaled) if noise is None else torch.floor(scaled + noise)
    return torch.clamp(snapped, -levels, levels)


def quantize_with_scale(
    x: torch.Tensor,
    safe_scale: torch.Tensor,
    levels: float,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``x/scale·levels`` snapped to the integer lattice, as fp32 lattice
    values.  ``safe_scale`` must already be zero-guarded."""
    return snap_to_lattice(x.float() / safe_scale * levels, levels, noise)


def draw_noise(
    x: torch.Tensor,
    key: Optional[PhiloxKey],
    offset: int = 0,
    noise: Optional[torch.Tensor] = None,
) -> Optional[torch.Tensor]:
    """The U[0,1) field for ``x``: ``noise`` as given, the key's Philox
    stream from ``offset`` on (over ``x`` in memory order), or None for
    nearest rounding."""
    if key is None:
        return noise
    return philox.uniform(key, offset, x.numel(), device=x.device).view(x.shape)


def safe_divisor(scale: torch.Tensor) -> torch.Tensor:
    """Zero-guard: a zero scale divides by 1 (every value is 0 anyway)."""
    return torch.where(scale > 0, scale, torch.ones_like(scale))


def global_absmax(tree: Sequence[torch.Tensor]) -> torch.Tensor:
    """Whole-model max |g| as a 0-dim fp32 tensor (0 for an empty tree)."""
    if not tree:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack([leaf.float().abs().amax() for leaf in tree]).amax()


def _leaf_noise(tree, key, offset, noise) -> List[Optional[torch.Tensor]]:
    """One field per leaf: ``noise`` (a sequence, one per leaf) as given, or
    the key's stream laid over the leaves as over their concatenation."""
    if noise is not None:
        if len(noise) != len(tree):
            raise ValueError(f"{len(noise)} noise fields for {len(tree)} leaves")
        return list(noise)
    out = []
    for leaf in tree:
        out.append(draw_noise(leaf, key, offset))
        offset += leaf.numel()
    return out


def encode(
    tree: Sequence[torch.Tensor],
    cfg: CompressionConfig,
    key: Optional[PhiloxKey] = None,
    offset: int = 0,
    noise: Optional[Sequence[torch.Tensor]] = None,
    scale: Optional[torch.Tensor] = None,
) -> Encoded:
    """Quantize a gradient tree against its max-abs, or against ``scale``
    (0-dim fp32) where the caller gives one.  mode='none' stores fp32
    unchanged."""
    if scale is None:
        scale = global_absmax(tree)
    if cfg.mode == "none":
        return Encoded(scale, [leaf.float() for leaf in tree])
    key, noise = rounding_key(cfg, key, noise)
    safe = safe_divisor(scale)
    levels = float(levels_for(cfg))
    wire = wire_dtype_for(cfg)
    return Encoded(scale, [
        quantize_with_scale(leaf, safe, levels, u).to(wire)
        for leaf, u in zip(tree, _leaf_noise(tree, key, offset, noise))
    ])


def decode(enc: Encoded, cfg: CompressionConfig) -> list:
    """Dequantize: ``q · step`` with ``step = scale · rn(1/levels)``
    (:func:`times_reciprocal`, the JAX decode's ``scale / levels`` as
    XLA compiles it) — one multiply by a runtime scalar, so every program
    rounds it the same way."""
    if cfg.mode == "none":
        return list(enc.tree)
    step = times_reciprocal(enc.scale, float(levels_for(cfg)))
    return [q.float() * step for q in enc.tree]


def fake_quantize(
    tree: Sequence[torch.Tensor],
    cfg: CompressionConfig,
    key: Optional[PhiloxKey] = None,
    offset: int = 0,
    noise: Optional[Sequence[torch.Tensor]] = None,
    scale: Optional[torch.Tensor] = None,
) -> list:
    """encode→decode round trip (against ``scale`` where given); identity
    when mode='none'."""
    if cfg.mode == "none":
        return list(tree)
    return decode(encode(tree, cfg, key=key, offset=offset, noise=noise, scale=scale), cfg)


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
    key: Optional[PhiloxKey] = None,
    offset: int = 0,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the encode kernels: one tensor to its wire dtype
    against a caller-shared scale (the fused all-reduce's convention),
    rounding to nearest, or stochastically with ``key`` or ``noise``."""
    u = draw_noise(x, key, offset, noise)
    return quantize_with_scale(x, safe_scale, levels, u).to(wire)


def decode_with_inv(
    q: torch.Tensor, inv: torch.Tensor, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain version of the decode kernel: ``float(q) · inv``."""
    return torch.mul(q.float(), inv, out=out)
