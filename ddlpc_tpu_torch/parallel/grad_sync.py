"""Gradient synchronization with the optional lossy codec — the port's copy
of ``ddlpc_tpu/parallel/grad_sync.py``.

The gradient tree arrives as ONE flat fp32 buffer (``FlatParams.grad``),
so each codec stage is a single kernel launch over the whole model.  The
loss points are the reference's: ``quantize_local`` before the reduce (the
worker's wire), ``quantize_mean`` on the mean (the server's re-quantized
broadcast).  When the lattice sums fit a narrow dtype
(:func:`simulate_wire_dtype`) the local stage FUSES into the reduce: the
lattice itself is what the all-reduce sums, against a scale shared by all
replicas (the max over the world of each one's max-abs), and one decode
multiply by ``scale / (levels · world_size)`` (as XLA compiles it: by the
constant's fp32 reciprocal) both dequantizes and takes
the mean.

Two programs, as in the JAX package: :func:`sync_gradients` all-reduces
and leaves every replica the whole mean (``shard_update='off'``);
:func:`sync_gradients_scatter` reduce-scatters and leaves replica ``r``
only its chunk of the mean (``zero2``, chunk layout in
``shard_update.py``), its mean stage run on the chunk against the max of
the chunks' max-abs values, which is the whole mean's.

Stochastic rounding (``compression.rounding='stochastic'``) takes the
step's key (``ops/philox.step_key``) and splits it as the reference's
``_sync_tree`` does: a local key with the replica index folded in, and a
mean key every replica shares.  Each stage's kernel draws its Philox
stream from offset 0 of the flat buffer; a chunk of the mean draws from
its own offset, so that it rounds as the same elements of the whole mean
would.

Gradient buckets (``compression.bucket_mb > 0``): the flat buffers are
cut into regions, one a bucket (``train_step.FlatParams``, in the JAX
package's leaf order), and each region is synced on its own: its own
max-abs scale, its own collective, its own set of codec launches.  With
more than one bucket, bucket ``b``'s rounding key is the step's with
``b`` folded in, before the local/mean split, as the JAX package's
``_bucketed`` folds it; one bucket is the unbucketed sync, bit for bit.

``compression.transport='ring'`` swaps the all-reduce for the quantized
ring of ``compressed_allreduce.py``, which puts the int8/int16 chunks
themselves on the wire.

The reduces over replicas run over the process group
(``parallel/mesh.py``), each issued as the census' ``wire``; with one
replica they are the identity.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ddlpc_tpu_torch.config import CompressionConfig
from ddlpc_tpu_torch.ops import cuda_quantize, philox
from ddlpc_tpu_torch.ops.quantize import (
    check_rounding,
    levels_for,
    rounding_key,
    safe_divisor,
    times_reciprocal,
)
from ddlpc_tpu_torch.parallel import mesh
from ddlpc_tpu_torch.parallel.compressed_allreduce import ring_allreduce_mean_, wire_dtype
from ddlpc_tpu_torch.parallel.shard_update import local_chunk

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
    if compression.mode == "int8":
        try:
            return wire_dtype(axis_size, levels)
        except ValueError:
            return None
    if axis_size * levels <= 2048:
        return torch.float16
    return None


def _allreduce_sum(t: torch.Tensor, axis_size: int) -> torch.Tensor:
    """Sum over replicas, in place (int16 widened for the collective, see
    ``mesh.py``); the identity for one."""
    if axis_size == 1:
        return t
    mesh.check_world(axis_size)
    return mesh.all_reduce_(t, "sum", role="wire")


def _allreduce_max(t: torch.Tensor, axis_size: int) -> torch.Tensor:
    """Max over replicas (the shared codec scale), in place."""
    if axis_size == 1:
        return t
    mesh.check_world(axis_size)
    return mesh.all_reduce_(t, "max", role="wire")


def _reduce_scatter_sum(t: torch.Tensor, axis_size: int) -> torch.Tensor:
    """This replica's chunk of the sum over replicas (a new tensor)."""
    if axis_size == 1:
        return t.clone()
    mesh.check_world(axis_size)
    return mesh.reduce_scatter(t, role="wire")


def _replica_index(axis_size: int) -> int:
    """This process's index among the replicas."""
    if axis_size == 1:
        return 0
    mesh.check_world(axis_size)
    return mesh.replica_index()


def _encode_shared(
    flat: torch.Tensor,
    compression: CompressionConfig,
    axis_size: int,
    wire: torch.dtype,
    draw: dict,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused path's encode: ``(lattice on the wire, shared scale)``,
    the scale being the max over replicas of each one's max-abs."""
    scale = _allreduce_max(cuda_quantize.absmax(flat), axis_size)
    q = cuda_quantize.encode_to_wire(flat, safe_divisor(scale), compression, wire, **draw)
    return q, scale


def _decode_mean(
    q: torch.Tensor, scale: torch.Tensor, compression: CompressionConfig,
    axis_size: int, out: torch.Tensor,
) -> torch.Tensor:
    """The summed lattice as the mean: ``inv = scale / (levels · axis_size)``
    as the JAX program computes it, a multiply by the constant's fp32
    reciprocal (``times_reciprocal``)."""
    inv = times_reciprocal(scale, float(levels_for(compression)) * axis_size)
    return cuda_quantize.decode_from_wire(q, inv, out=out)


def _fused_allreduce_mean(
    flat: torch.Tensor,
    compression: CompressionConfig,
    axis_size: int,
    wire: torch.dtype,
    out: torch.Tensor,
    draw: dict,
) -> torch.Tensor:
    """quantize_local with the narrow dtype on the wire: encode against the
    shared scale (rounding with the local stage's ``draw``), sum the
    lattice, decode the mean into ``out``."""
    q, scale = _encode_shared(flat, compression, axis_size, wire, draw)
    return _decode_mean(_allreduce_sum(q, axis_size), scale, compression, axis_size, out)


def check_supported(compression: CompressionConfig) -> None:
    """Raise on a codec setting the JAX package refuses: an unknown
    transport, level count, rounding or backend."""
    if compression.transport not in ("simulate", "ring"):
        raise ValueError(
            f"unknown compression transport {compression.transport!r} "
            "(expected 'simulate' or 'ring')"
        )
    if compression.mode != "none":
        levels_for(compression)
        check_rounding(compression)
    resolve_codec_backend(compression)


def _check_ring(compression: CompressionConfig) -> None:
    """The JAX package's refusals of what the ring cannot do."""
    if compression.bucket_mb > 0:
        raise ValueError(
            "bucket_mb composes only with transport='simulate' — the "
            "ring's flatten/concat transport is whole-tree by "
            "construction (one concatenated wire buffer per sync)"
        )
    if not (compression.quantize_local and compression.quantize_mean):
        raise ValueError(
            "transport='ring' quantizes at both loss points by "
            "construction (integer wire sums + quantized gather hops); "
            "quantize_local/quantize_mean=False ablations need "
            "transport='simulate'"
        )


def _bucket_args(
    flat: torch.Tensor,
    buckets: Optional[Sequence[Tuple[int, int]]],
    key: Optional[int],
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]],
) -> List[Tuple[torch.Tensor, Optional[int], Optional[tuple]]]:
    """``(region, key, noise)`` for each bucket's sync: the whole buffer
    with the step's key for one bucket (``buckets`` None or one region);
    else each region ``(start, elements)`` of ``flat``, the key with the
    bucket's index folded in, the region's slice of the noise fields."""
    if buckets is None or len(buckets) == 1:
        return [(flat, key, noise)]
    out = []
    for b, (start, size) in enumerate(buckets):
        out.append((
            flat[start : start + size],
            None if key is None else philox.fold_in(key, b),
            None if noise is None else tuple(u[start : start + size] for u in noise),
        ))
    return out


def _stage_draws(
    compression: CompressionConfig,
    axis_size: int,
    key: Optional[int],
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]],
) -> Tuple[dict, dict]:
    """The codec's rounding arguments for the local and the mean stage:
    none for nearest; ``noise=(local_u, mean_u)`` as given; or Philox keys
    from the step's ``key``, the local one with the replica index folded
    in, the mean one shared."""
    if compression.mode == "none":
        return {}, {}
    rounding_key(compression, key, noise)  # raises on what no codec call takes
    if noise is not None:
        local_u, mean_u = noise
        return {"noise": local_u}, {"noise": mean_u}
    if compression.rounding == "nearest":
        return {}, {}
    local = philox.stage_key(key, "local", replica=_replica_index(axis_size))
    return {"key": local}, {"key": philox.stage_key(key, "mean")}


def _chunk_draw(draw: dict, index: int, k: int) -> dict:
    """The draw of replica ``index``'s K-element chunk of a buffer: the
    chunk of a given field, or the key's stream from the chunk's offset."""
    if "noise" in draw:
        return {"noise": draw["noise"][index * k : (index + 1) * k]}
    if "key" in draw:
        return {"key": draw["key"], "offset": index * k}
    return {}


def sync_gradients(
    flat: torch.Tensor,
    compression: CompressionConfig,
    axis_size: int = 1,
    key: Optional[int] = None,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    buckets: Optional[Sequence[Tuple[int, int]]] = None,
    n_elements: Optional[int] = None,
) -> torch.Tensor:
    """All-reduce-mean the flat gradient buffer IN PLACE, with the codec's
    loss injected at the configured points; returns ``flat``.

    ``key`` (the step's, ``philox.step_key``) drives stochastic rounding;
    ``noise=(local_u, mean_u)`` hands in both stages' U[0,1) fields
    instead (fp32, ``flat``'s shape).  ``buckets`` are the regions
    ``(start, elements)`` synced one by one (``FlatParams.buckets``; None
    is one).  ``n_elements`` counts the gradients at the buffer's head
    (the rest is zero padding); the ring chunks those, as the JAX
    package chunks its tree."""
    check_supported(compression)
    fq = resolve_codec_backend(compression)
    if compression.transport == "ring" and compression.mode != "none":
        _check_ring(compression)
        local, mean = _stage_draws(compression, axis_size, key, noise)
        n = flat.numel() if n_elements is None else n_elements
        return ring_allreduce_mean_(flat, n, compression, axis_size, local, mean)
    for region, bkey, bnoise in _bucket_args(flat, buckets, key, noise):
        local, mean = _stage_draws(compression, axis_size, bkey, bnoise)
        _sync_tree(region, compression, axis_size, fq, local, mean)
    return flat


def _sync_tree(flat, compression, axis_size, fq, local: dict, mean: dict) -> torch.Tensor:
    wire = simulate_wire_dtype(axis_size, compression)
    if wire is not None:
        _fused_allreduce_mean(flat, compression, axis_size, wire, out=flat, draw=local)
    else:
        if compression.quantize_local:
            fq(flat, compression, out=flat, **local)
        _allreduce_sum(flat, axis_size).div_(axis_size)
    if compression.quantize_mean:
        fq(flat, compression, out=flat, **mean)
    return flat


def validate_scatter_compression(compression: CompressionConfig) -> None:
    """Reject codec settings the sharded update cannot reproduce bit for
    bit, in the JAX package's words (``resolve_shard_update``'s ``auto``
    avoids them)."""
    check_supported(compression)
    if compression.transport == "ring" and compression.mode != "none":
        raise ValueError(
            "sharded update composes only with transport='simulate' — "
            "transport='ring' owns its own full-tree quantized collective "
            "(set shard_update='off' to keep the ring)"
        )
    if (
        compression.mode != "none"
        and compression.quantize_mean
        and compression.codec_backend == "pallas"
    ):
        raise ValueError(
            "sharded update cannot reproduce the pallas mean-stage codec "
            "bit-identically (hardware-PRNG noise cannot be sliced to a "
            "shard) — use codec_backend='xla' or shard_update='off'"
        )


def sync_gradients_scatter(
    flat: torch.Tensor,
    compression: CompressionConfig,
    axis_size: int,
    key: Optional[int] = None,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    buckets: Optional[Sequence[Tuple[int, int]]] = None,
) -> List[torch.Tensor]:
    """Reduce-scatter-mean the flat gradient buffer: returns this replica's
    chunks of the codec-processed mean, one a bucket region (``buckets``
    as in :func:`sync_gradients`; each region ``axis_size · K_b``
    elements), written IN PLACE into its rows of ``flat`` (the rest of
    ``flat`` is left holding this replica's pre-sync gradient, or its
    fake-quantized copy).

    Per element it equals :func:`sync_gradients`: the local stage encodes
    each region exactly as there, the integer (or fp16) lattice sums are
    exact in any order, and the mean stage quantizes the chunk against
    the region's whole mean's max-abs with the chunk's slice of the mean
    stage's draw.  ``noise=(local_u, mean_u)`` are full-buffer fields."""
    validate_scatter_compression(compression)
    fq = resolve_codec_backend(compression)
    shards = []
    for region, bkey, bnoise in _bucket_args(flat, buckets, key, noise):
        local, mean = _stage_draws(compression, axis_size, bkey, bnoise)
        shards.append(_scatter_tree(region, compression, axis_size, fq, local, mean))
    return shards


def sync_for_level(
    flat: torch.Tensor,
    compression: CompressionConfig,
    axis_size: int,
    chunked_grads: bool,
    key: Optional[int] = None,
    buckets: Optional[Sequence[Tuple[int, int]]] = None,
    n_elements: Optional[int] = None,
) -> Optional[List[torch.Tensor]]:
    """The train step's gradient sync at the state's ZeRO level: where its
    placement keeps the gradients chunked (``chunked_grads``, the
    ``StateLayout``'s ``chunked["grads"]``) the reduce-scatter, returning
    this replica's chunks (:func:`sync_gradients_scatter`), else the
    in-place all-reduce, returning None (:func:`sync_gradients`).  The
    step and the comm probe (``obs/comm.make_comm_probe``) both sync
    through it, so that the probe times what the step runs."""
    if chunked_grads:
        return sync_gradients_scatter(flat, compression, axis_size, key=key, buckets=buckets)
    sync_gradients(flat, compression, axis_size=axis_size, key=key, buckets=buckets,
                   n_elements=n_elements)
    return None


def _scatter_tree(flat, compression, axis_size, fq, local: dict, mean: dict) -> torch.Tensor:
    index = _replica_index(axis_size)
    shard = local_chunk(flat, axis_size, index)
    wire = simulate_wire_dtype(axis_size, compression)
    if wire is not None:
        q, scale = _encode_shared(flat, compression, axis_size, wire, local)
        _decode_mean(_reduce_scatter_sum(q, axis_size), scale, compression, axis_size, shard)
    else:
        if compression.quantize_local:
            fq(flat, compression, out=flat, **local)
        shard.copy_(_reduce_scatter_sum(flat, axis_size)).div_(axis_size)
    if compression.quantize_mean and compression.mode != "none":
        amax = _allreduce_max(cuda_quantize.absmax(shard), axis_size)
        fq(shard, compression, out=shard, amax=amax,
           **_chunk_draw(mean, index, shard.numel()))
    return shard
