"""Size-targeted gradient buckets — the port's copy of
``ddlpc_tpu/parallel/bucketing.py``.

The leaves are walked in the JAX package's flatten order (which
``train_step.FlatParams`` lays its buffers out in) and greedily grouped:
a new bucket opens whenever adding the next leaf would exceed
``bucket_mb`` MiB and the current bucket is not empty.  Each bucket is
then a contiguous range of leaves, and of the flat buffer, and it is the
unit of the codec's loss: its own max-abs scale, its own collective.

Stdlib only, as in the JAX package: the byte accounting
(``obs/comm.py``) computes the same partition without touching a tensor.
"""

from __future__ import annotations

from typing import List, Sequence

MIB = float(1 << 20)


def assign_buckets(leaf_bytes: Sequence[int], bucket_mb: float) -> List[int]:
    """Bucket index per leaf (flatten order) for a greedy ``bucket_mb`` MiB
    target.  ``bucket_mb <= 0`` puts every leaf in bucket 0.  A leaf larger
    than the target gets a bucket of its own (never split); indices are
    contiguous from 0."""
    if bucket_mb <= 0 or not leaf_bytes:
        return [0] * len(leaf_bytes)
    target = bucket_mb * MIB
    out: List[int] = []
    bucket = 0
    acc = 0.0
    for nbytes in leaf_bytes:
        if acc > 0 and acc + nbytes > target:
            bucket += 1
            acc = 0.0
        out.append(bucket)
        acc += nbytes
    return out


def bucket_index_groups(leaf_bytes: Sequence[int], bucket_mb: float) -> List[List[int]]:
    """Leaf indices grouped per bucket, in bucket order."""
    assignment = assign_buckets(leaf_bytes, bucket_mb)
    n_buckets = (max(assignment) + 1) if assignment else 1
    groups: List[List[int]] = [[] for _ in range(n_buckets)]
    for i, b in enumerate(assignment):
        groups[b].append(i)
    return groups


def bucket_count(leaf_bytes: Sequence[int], bucket_mb: float) -> int:
    """How many buckets :func:`assign_buckets` produces."""
    assignment = assign_buckets(leaf_bytes, bucket_mb)
    return (max(assignment) + 1) if assignment else 1
