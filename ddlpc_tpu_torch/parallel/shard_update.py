"""ZeRO-1/2/3: the weight update sharded across replicas — the port's copy
of the parts of ``ddlpc_tpu/parallel/shard_update.py`` its train step runs.

- ``zero1``: the moments persist as chunks.  The gradient sync stays the
  full all-reduce (every codec and transport, the ring included); each
  replica updates its chunk of the params and one all-gather publishes
  them.
- ``zero2``: the gradient sync is a reduce-scatter, so replica ``r`` gets
  only its chunk of the mean; the update and the publish as zero1.
- ``zero3``: the params persist as chunks too.  The step all-gathers them
  into a temporary full buffer for the forward and backward, and the
  fresh chunks are not gathered at its end.

Chunk layout.  The JAX package chunks each leaf (``chunk_leaf``: flatten,
zero-pad to a multiple of N, view as ``[N, K]``).  The port chunks each
region of its flat buffer (``train_step.FlatParams``: the whole buffer, or
one region a gradient bucket) the same way.  Per element the two are the
same arithmetic (an exact integer sum on the narrow wire, one multiply by
a scalar, a max over the bucket, an elementwise update); only which
replica owns which element differs.  A region holds ``N·K`` elements with
K rounded up to a multiple of 32 (:func:`flat_chunk_rows`), so every
chunk starts 128-byte aligned (the codec kernels' vector loads need 16)
and the collectives read and write the buffers with no copy.  The zero
tail stays zero: its max-abs is 0, its lattice point is 0 under either
rounding, and every optimizer's update of a zero gradient from zero
state at a zero param is 0.
"""

from __future__ import annotations

import torch

from ddlpc_tpu_torch.config import CompressionConfig

CHUNK_LAYOUTS = ("zero1", "zero2", "zero3")
_ALIGN_ELEMENTS = 32  # 128 bytes of fp32


def normalize_shard_update(value) -> str:
    """The historical bool (``True`` = the sharded program, zero2) or a
    level string, as one level string."""
    if value is True:
        return "zero2"
    if value is False or value is None or value == "off":
        return "off"
    if value in CHUNK_LAYOUTS:
        return value
    raise ValueError(
        f"unknown shard_update level {value!r} "
        f"(expected off|zero1|zero2|zero3 or a bool)"
    )


def chunk_rows(n_elements: int, n_shards: int) -> int:
    """K of the JAX package's per-leaf layout: ``ceil(n / N)``."""
    return -(-n_elements // n_shards)


def flat_chunk_rows(n_elements: int, n_shards: int) -> int:
    """K of the port's flat layout: ``ceil(n / N)`` rounded up to a
    multiple of 32 elements; ``n`` itself for one shard (nothing pads)."""
    if n_shards == 1:
        return n_elements
    k = chunk_rows(n_elements, n_shards)
    return -(-k // _ALIGN_ELEMENTS) * _ALIGN_ELEMENTS


def region_rows(n_elements: int, n_shards: int, aligned: bool) -> int:
    """K of one region of the flat buffers: :func:`flat_chunk_rows`, or,
    where the buffer holds several regions (gradient buckets), always a
    multiple of 32 elements, so that every region starts 128-byte aligned
    on one replica too."""
    if not aligned:
        return flat_chunk_rows(n_elements, n_shards)
    return -(-chunk_rows(n_elements, n_shards) // _ALIGN_ELEMENTS) * _ALIGN_ELEMENTS


def flat_layout(sizes, n_shards: int, bucket_mb: float = 0.0):
    """The flat buffers' layout for leaves of ``sizes`` elements (fp32, in
    flatten order): ``(offsets, regions, total)``, each leaf's offset, each
    gradient bucket's region ``(start, leaf elements, rows)`` — its leaves
    contiguous from ``start``, then a zero tail up to ``n_shards · rows``
    elements — and the buffers' length."""
    from ddlpc_tpu_torch.parallel.bucketing import bucket_index_groups

    groups = bucket_index_groups([4 * n for n in sizes], bucket_mb)
    offsets = [0] * len(sizes)
    regions = []
    start = 0
    for idxs in groups:
        o = start
        for i in idxs:
            offsets[i] = o
            o += sizes[i]
        rows = region_rows(o - start, n_shards, aligned=len(groups) > 1)
        regions.append((start, o - start, rows))
        start += n_shards * rows
    return offsets, regions, start


def local_chunk(buf: torch.Tensor, n_shards: int, index: int) -> torch.Tensor:
    """Replica ``index``'s chunk of a flat buffer of ``N·K`` elements, a
    view: row ``index`` of its ``[N, K]`` view."""
    if buf.dim() != 1 or buf.numel() % n_shards:
        raise ValueError(
            f"a flat buffer of N·K elements is needed, got {tuple(buf.shape)} "
            f"for N={n_shards}"
        )
    return buf.view(n_shards, buf.numel() // n_shards)[index]


def resolve_shard_update(
    mode: str,
    compression: CompressionConfig,
    data_size: int,
    spatial: bool,
    grad_clip_norm: float = 0.0,
) -> str:
    """``ParallelConfig.shard_update`` as a ZeRO level (``'off' | 'zero1' |
    'zero2' | 'zero3'``), decision for decision as the JAX package resolves
    it (``ddlpc_tpu/parallel/shard_update.py:191``).

    ``auto`` and ``on`` are ``zero2``.  ``auto`` falls back to ``off`` on
    one replica and where the scatter path cannot reproduce the
    replicated one bit for bit: ``transport='ring'``, the pallas backend
    with ``quantize_mean``, and ``grad_clip_norm > 0`` (a clip inside the
    update would see one shard's norm).  An explicit level raises there
    instead; on one replica it is ``off``."""
    if mode not in ("auto", "on", "off", "zero1", "zero2", "zero3"):
        raise ValueError(
            f"unknown shard_update {mode!r} (expected 'auto', 'on', 'off', "
            f"'zero1', 'zero2' or 'zero3')"
        )
    if mode == "off":
        return "off"
    level = "zero2" if mode in ("auto", "on") else mode
    incompatible = None
    if not spatial:
        scatter_based = level in ("zero2", "zero3")
        if scatter_based and compression.mode != "none":
            if compression.transport == "ring":
                incompatible = (
                    "transport='ring' — the ring all-reduce owns its own "
                    "quantized reduce-scatter/all-gather over whole leaves "
                    "(shard_update='zero1' composes with the ring)"
                )
            elif compression.quantize_mean and compression.codec_backend == "pallas":
                # The port's Philox draw could be sliced; the decision is
                # the JAX package's, whose TPU hardware-PRNG draw cannot.
                incompatible = (
                    "codec_backend='pallas' with quantize_mean — the "
                    "kernel's hardware-PRNG noise field cannot be sliced to "
                    "a shard of the mean; use codec_backend='xla' or "
                    "shard_update='zero1'"
                )
        if incompatible is None and grad_clip_norm:
            incompatible = (
                "grad_clip_norm > 0 — a clip by global norm inside the "
                "update would clip each replica's 1/N shard by its own "
                "partial norm, not the global norm; disable clipping"
            )
    if mode != "auto":
        if incompatible:
            raise ValueError(
                f"shard_update={mode!r} cannot compose with {incompatible}; "
                f"set shard_update='off' (or 'auto', which resolves it)"
            )
        return level if data_size > 1 else "off"
    return level if data_size > 1 and incompatible is None else "off"
