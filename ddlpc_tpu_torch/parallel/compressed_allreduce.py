"""The integer wire's dtype — the port's copy of ``wire_dtype`` from
``ddlpc_tpu/parallel/compressed_allreduce.py:64``.  The ring transport
itself is not ported (``compression.transport='ring'`` raises)."""

from __future__ import annotations

import torch


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
        f"{levels} levels on {axis_size} replicas need an int32 wire (peak "
        f"partial sum {peak}): the same bytes as the fp32 all-reduce"
    )
