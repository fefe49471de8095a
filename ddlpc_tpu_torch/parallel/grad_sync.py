"""Gradient synchronization with the optional lossy codec — the port's copy
of ``ddlpc_tpu/parallel/grad_sync.py`` for one process.

The gradient tree arrives as ONE flat fp32 buffer (``FlatParams.grad``),
so each codec stage is a single kernel launch over the whole model.  The
loss points are the reference's: ``quantize_local`` before the reduce (the
worker's wire), ``quantize_mean`` on the mean (the server's re-quantized
broadcast).  When the lattice sums fit a narrow dtype
(:func:`simulate_wire_dtype`) the local stage FUSES into the reduce: the
lattice itself is what the all-reduce sums, and one decode multiply by
``scale / (levels · world_size)`` both dequantizes and takes the mean.

This slice runs one process: the reduce over replicas is the identity
(:func:`_allreduce_sum`), the one place a later slice puts
``torch.distributed.all_reduce`` (with a MAX reduce for the shared scale).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ddlpc_tpu_torch.config import CompressionConfig
from ddlpc_tpu_torch.ops import cuda_quantize
from ddlpc_tpu_torch.ops.quantize import (
    check_rounding,
    levels_for,
    safe_divisor,
    true_div,
)

Codec = Callable[[torch.Tensor, CompressionConfig], torch.Tensor]


def resolve_codec_backend(compression: CompressionConfig) -> Codec:
    """The fake-quantize implementation of the simulate transport.

    ``'xla'`` and ``'pallas'`` both name the port's one codec: the CUDA
    kernel for a CUDA buffer, its plain version for a CPU buffer (the
    dispatch lives in the wrapper).  Anything else raises."""
    if compression.codec_backend not in ("xla", "pallas"):
        raise ValueError(
            f"unknown codec_backend {compression.codec_backend!r} "
            "(expected 'xla' or 'pallas')"
        )
    return cuda_quantize.fake_quantize_fused


def simulate_wire_dtype(
    axis_size: Optional[int], compression: CompressionConfig
) -> Optional[torch.dtype]:
    """The narrow dtype the fused all-reduce puts on the wire, or None when
    the fp32 fake-quantize path must stay: int8/int16 while every partial
    sum (≤ axis_size·levels) fits, fp16 while ``axis_size·levels ≤ 2048``
    (every integer up to 2048 is exact in fp16)."""
    if (
        axis_size is None
        or compression.mode == "none"
        or not compression.quantize_local
        or compression.transport != "simulate"
    ):
        return None
    levels = levels_for(compression)
    peak = axis_size * levels
    if compression.mode == "int8":
        if peak <= 127:
            return torch.int8
        if peak <= 32767:
            return torch.int16
        return None
    if peak <= 2048:
        return torch.float16
    return None


def _allreduce_sum(t: torch.Tensor, axis_size: int) -> torch.Tensor:
    """Sum over replicas.  One process: the identity."""
    if axis_size != 1:
        raise NotImplementedError("gradient sync across processes is not yet ported")
    return t


def _allreduce_max(t: torch.Tensor, axis_size: int) -> torch.Tensor:
    """Max over replicas (the shared codec scale).  One process: the identity."""
    if axis_size != 1:
        raise NotImplementedError("gradient sync across processes is not yet ported")
    return t


def _fused_allreduce_mean(
    flat: torch.Tensor,
    compression: CompressionConfig,
    axis_size: int,
    wire: torch.dtype,
    out: torch.Tensor,
) -> torch.Tensor:
    """quantize_local with the narrow dtype on the wire: encode against the
    shared scale, sum the lattice, decode with ``inv = scale / (levels ·
    axis_size)`` into ``out``."""
    scale = _allreduce_max(flat.abs().amax().reshape(1), axis_size)
    safe = safe_divisor(scale)
    levels = float(levels_for(compression))
    q = cuda_quantize.encode_to_wire(flat, safe, compression, wire)
    summed = _allreduce_sum(q, axis_size)
    inv = true_div(scale, levels * axis_size)
    return cuda_quantize.decode_from_wire(summed, inv, out=out)


def check_supported(compression: CompressionConfig) -> None:
    """Raise on a codec setting this slice does not implement."""
    if compression.transport not in ("simulate", "ring"):
        raise ValueError(
            f"unknown compression transport {compression.transport!r} "
            "(expected 'simulate' or 'ring')"
        )
    if compression.transport == "ring" and compression.mode != "none":
        raise NotImplementedError("compression.transport='ring' is not yet ported")
    if compression.bucket_mb > 0:
        raise NotImplementedError("compression.bucket_mb > 0 is not yet ported")
    if compression.mode != "none":
        levels_for(compression)
        check_rounding(compression)
    resolve_codec_backend(compression)


def sync_gradients(
    flat: torch.Tensor, compression: CompressionConfig, axis_size: int = 1
) -> torch.Tensor:
    """All-reduce-mean the flat gradient buffer IN PLACE, with the codec's
    loss injected at the configured points; returns ``flat``."""
    check_supported(compression)
    fq = resolve_codec_backend(compression)
    return _sync_tree(flat, compression, axis_size, fq)


def _sync_tree(flat, compression, axis_size, fq) -> torch.Tensor:
    wire = simulate_wire_dtype(axis_size, compression)
    if wire is not None:
        _fused_allreduce_mean(flat, compression, axis_size, wire, out=flat)
    else:
        if compression.quantize_local:
            fq(flat, compression, out=flat)
        _allreduce_sum(flat, axis_size).div_(axis_size)
    if compression.quantize_mean:
        fq(flat, compression, out=flat)
    return flat
