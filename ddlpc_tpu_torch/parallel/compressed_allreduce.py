"""Wire-compressed ring all-reduce — the port's copy of
``ddlpc_tpu/parallel/compressed_allreduce.py`` (``compression.transport=
'ring'``).

The reference's research contribution is fewer bytes on the wire between
replicas.  The ring moves them: a reduce-scatter of N−1 hops and an
all-gather of N−1 hops, each hop a point-to-point exchange with the ring's
neighbours (``mesh.ring_shift``) of one chunk in the smallest integer
dtype that holds any partial sum (:func:`wire_dtype`: int8 while
N·levels ≤ 127, else int16).  The tensors sent are the int8/int16 tensors
themselves: a hop sums nothing, so neither backend's lack of an int16 sum
(ROADMAP C5) applies, and the wire bytes are the JAX package's
``ppermute`` hops' (:func:`ring_wire_report`).

Quantization, at the reference's two loss points:

- one shared scale, the max over the replicas of each one's whole-model
  max-abs;
- each replica quantizes once (the client's wire; the ``encode`` kernel),
  and the integer partial sums then accumulate exactly (each hop is
  followed by an fp32 add);
- the owned chunk's sum is snapped once as ``partial / N`` (the server's
  re-quantized broadcast), so every replica gathers the same lattice
  values, and one multiply by ``scale / levels`` (the ``decode`` kernel
  with N = 1) dequantizes the gathered mean.

The chunks are the JAX package's: the first ``n`` elements of the flat
buffer, zero-padded to ``N·ceil(n/N)`` (the flat buffer's zero tail is the
padding), so each hop carries ``ceil(n/N)`` elements.  Stochastic rounding
draws the local stage from the replica's Philox stream over that padded
vector, and the mean stage's snap of every chunk from the same
``ceil(n/N)``-element field of the shared mean key, as the JAX package
draws one field of the chunk's shape.
"""

from __future__ import annotations

import torch

from ddlpc_tpu_torch.config import CompressionConfig


def wire_dtype(axis_size: int, levels: int) -> torch.dtype:
    """Smallest integer dtype holding any partial sum (≤ N·levels) of the
    int8 codec's lattice over ``axis_size`` replicas.

    Raises when only int32 would fit: 4-byte words are the bytes of the
    fp32 all-reduce, so the integer wire would compress nothing."""
    peak = axis_size * levels
    if peak <= 127:
        return torch.int8
    if peak <= 32767:
        return torch.int16
    raise ValueError(
        f"ring transport with {levels} levels on {axis_size} replicas needs "
        f"int32 hops (peak partial sum {peak}) — that moves the same bytes "
        "as the native fp32 all-reduce; use transport='simulate' instead"
    )


def ring_wire_report(num_elements: int, axis_size: int, cfg: CompressionConfig) -> dict:
    """Exact wire bytes of one ring all-reduce a replica against the fp32
    ring: 2(N−1) hops, each one ``ceil(n/N)``-element chunk in the wire
    dtype (fp32 for ``mode='none'``, the exact mean)."""
    from ddlpc_tpu_torch.ops.quantize import levels_for

    if cfg.mode == "none":
        name, itemsize = "float32", 4
    else:
        wdt = wire_dtype(axis_size, int(levels_for(cfg)))
        name, itemsize = str(wdt).replace("torch.", ""), torch.empty(0, dtype=wdt).element_size()
    chunk = -(-num_elements // axis_size)
    hops = 2 * (axis_size - 1)
    return {
        "elements": num_elements,
        "axis_size": axis_size,
        "wire_dtype": name,
        "hops_per_replica": hops,
        "bytes_per_hop": chunk * itemsize,
        "wire_bytes_per_replica": hops * chunk * itemsize,
        "fp32_bytes_per_replica": hops * chunk * 4,
        "compression_ratio": 4.0 / itemsize,
    }


def ring_allreduce_mean_(
    flat: torch.Tensor,
    n_elements: int,
    cfg: CompressionConfig,
    axis_size: int,
    local: dict,
    mean: dict,
) -> torch.Tensor:
    """Mean the first ``n_elements`` of ``flat`` over the replicas, IN PLACE,
    with the quantized chunks on every hop; returns ``flat``.  ``local``
    and ``mean`` are the two stages' rounding arguments
    (``grad_sync._stage_draws``: ``{}``, ``{"key": ...}`` or ``{"noise":
    field}``).  One replica applies the two loss points as two
    fake-quantizes."""
    from ddlpc_tpu_torch.ops import cuda_quantize, philox
    from ddlpc_tpu_torch.ops.quantize import (
        levels_for,
        safe_divisor,
        snap_to_lattice,
        times_reciprocal,
    )
    from ddlpc_tpu_torch.parallel import mesh

    if axis_size == 1:
        cuda_quantize.fake_quantize_fused(flat, cfg, out=flat, **local)
        return cuda_quantize.fake_quantize_fused(flat, cfg, out=flat, **mean)
    levels = float(levels_for(cfg))
    wdt = wire_dtype(axis_size, int(levels))
    mesh.check_world(axis_size)
    chunk = -(-n_elements // axis_size)
    x = flat[: axis_size * chunk]
    rank = mesh.replica_index()

    scale = mesh.all_reduce_(cuda_quantize.absmax(x), "max", role="wire")
    if "noise" in local:
        local = {"noise": local["noise"][: x.numel()]}
    q = cuda_quantize.encode_to_wire(x, safe_divisor(scale), cfg, wdt, **local).view(axis_size, chunk)

    # Reduce-scatter, N−1 hops: after hop k the partial at rank r covers
    # chunk (r + 1 − k) mod N summed over ranks r−k..r; after N−1 hops
    # rank r holds the whole sum of chunk (r + 2) mod N.
    partial = q[(rank + 1) % axis_size].float()
    for k in range(1, axis_size):
        hop = mesh.ring_shift(partial.to(wdt), role="wire")
        partial = hop.float() + q[(rank + 1 - k) % axis_size].float()
    own = (rank + 2) % axis_size

    # The server's loss point: the sum's mean, in lattice units, snapped
    # once.  The division by the program constant N is XLA's multiply by
    # its fp32 reciprocal (ROADMAP C6).
    noise = None
    if "key" in mean:
        noise = philox.uniform(mean["key"], 0, chunk, device=flat.device)
    elif "noise" in mean:
        noise = mean["noise"][:chunk]
    mean_q = snap_to_lattice(times_reciprocal(partial, float(axis_size)), levels, noise).to(wdt)

    # All-gather, N−1 hops of the snapped chunks.
    out = torch.empty((axis_size, chunk), dtype=wdt, device=flat.device)
    out[own] = mean_q
    travelling = mean_q
    for k in range(1, axis_size):
        travelling = mesh.ring_shift(travelling, role="wire")
        out[(rank - k + 2) % axis_size] = travelling
    cuda_quantize.decode_from_wire(out.view(-1), times_reciprocal(scale, levels), out=x)
    return flat
