"""Halo exchange for H-sharded convolutions — the port's copy of
``ddlpc_tpu/parallel/halo.py``.

A tile too large for one device is sharded along H over the ``space``
axis (``parallel/mesh.py``), and each 'SAME' conv needs ``k//2`` rows of
its neighbours.  :func:`halo_exchange` sends a shard's top ``halo`` rows
to its upper neighbour and its bottom rows to its lower one and
concatenates what arrives; the global edges receive zeros, as JAX's
``ppermute`` gives a device with no source, which composes exactly with
'SAME' zero padding.  Where the JAX package lets XLA's partitioner insert
these exchanges, the port's spatial U-Net and U-Net++ call this one
(``models/layers.Conv``).  ``edge="clamp"`` fills the global edges' halo
with the shard's own edge row instead (replicate padding), which composes
with the edge clamp of a bilinear resize (``layers.upsample_2x``).

The exchange is differentiable: its backward is the adjoint, as JAX
transposes ``ppermute`` — each halo row's cotangent goes back to the
shard it came from and is added into that row; under ``edge="clamp"`` the
cotangent of a global edge's halo is added into the edge row.

Under gloo with ranks time-sharing a card the rows go through the host
(``mesh.exchange``); NCCL sends them card to card with ``batch_isend_irecv``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ddlpc_tpu_torch.parallel import mesh


def _neighbours():
    """Global ranks of this rank's upper and lower space neighbours (None
    at the global edges)."""
    ranks, s = mesh.grid().ranks("space"), mesh.space_index()
    return (ranks[s - 1] if s > 0 else None), (ranks[s + 1] if s + 1 < len(ranks) else None)


def _swap(top: torch.Tensor, bottom: torch.Tensor):
    """Send ``top`` up and ``bottom`` down; returns ``(from_up, from_down)``,
    zeros where there is no neighbour."""
    up, down = _neighbours()
    from_up, from_down = torch.zeros_like(bottom), torch.zeros_like(top)
    sends, recvs = [], []
    if up is not None:
        sends.append((top, up))
        recvs.append((from_up, up))
    if down is not None:
        sends.append((bottom, down))
        recvs.append((from_down, down))
    mesh.exchange(sends, recvs, axis="space")
    return from_up, from_down


EDGES = ("zeros", "clamp")


def _edge_rows(x: torch.Tensor, axis: int, at: int, halo: int) -> torch.Tensor:
    """Row ``at`` of ``x`` along ``axis``, repeated ``halo`` times."""
    shape = list(x.shape)
    shape[axis] = halo
    return x.narrow(axis, at, 1).expand(shape)


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, halo: int, axis: int, edge: str) -> torch.Tensor:
        ctx.halo, ctx.axis = halo, axis
        top = x.narrow(axis, 0, halo).contiguous()
        bottom = x.narrow(axis, x.shape[axis] - halo, halo).contiguous()
        from_up, from_down = _swap(top, bottom)
        up, down = _neighbours()
        # Under "clamp" the global edges repeat the shard's own edge row.
        ctx.clamp_up = edge == "clamp" and up is None
        ctx.clamp_down = edge == "clamp" and down is None
        if ctx.clamp_up:
            from_up = _edge_rows(x, axis, 0, halo)
        if ctx.clamp_down:
            from_down = _edge_rows(x, axis, x.shape[axis] - 1, halo)
        return torch.cat([from_up, x, from_down], dim=axis)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        halo, axis = ctx.halo, ctx.axis
        n = g.shape[axis] - 2 * halo
        g_up = g.narrow(axis, 0, halo).contiguous()  # of the rows the upper shard sent
        g_down = g.narrow(axis, halo + n, halo).contiguous()
        back_from_up, back_from_down = _swap(g_up, g_down)
        gx = g.narrow(axis, halo, n).clone()
        gx.narrow(axis, 0, halo).add_(back_from_up)
        gx.narrow(axis, n - halo, halo).add_(back_from_down)
        # Replicate padding's adjoint: a clamped halo's cotangent goes
        # into the edge row it copied.
        if ctx.clamp_up:
            gx.narrow(axis, 0, 1).add_(g_up.sum(axis, keepdim=True))
        if ctx.clamp_down:
            gx.narrow(axis, n - 1, 1).add_(g_down.sum(axis, keepdim=True))
        return gx, None, None, None


def halo_exchange(
    x: torch.Tensor, halo: int, spatial_axis: int = 2, edge: str = "zeros"
) -> torch.Tensor:
    """Concatenate ``halo`` rows of each space neighbour onto this shard
    along ``spatial_axis`` (2 for the port's NCHW, 1 for NHWC): ``[.., H_local
    + 2·halo, ..]``.  The outer halo of the first and last shard is zeros
    (``edge="zeros"``, 'SAME' zero padding) or that shard's own edge row
    repeated (``edge="clamp"``, replicate padding).  Every rank of the
    space group must call it."""
    if edge not in EDGES:
        raise ValueError(f"unknown halo edge {edge!r} ({' | '.join(EDGES)})")
    if halo <= 0:
        return x
    if x.shape[spatial_axis] < halo:
        raise ValueError(
            f"local spatial extent {x.shape[spatial_axis]} smaller than halo "
            f"{halo}; use fewer shards or larger tiles"
        )
    if mesh.space_size() == 1:
        if edge == "clamp":
            last = x.shape[spatial_axis] - 1
            return torch.cat([_edge_rows(x, spatial_axis, 0, halo), x,
                              _edge_rows(x, spatial_axis, last, halo)], dim=spatial_axis)
        pad = [0, 0] * (x.dim() - 1 - spatial_axis) + [halo, halo]
        return F.pad(x, pad)
    return _HaloExchange.apply(x, halo, spatial_axis, edge)


def sharded_same_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """A 'SAME' conv, stride 1, over an H-sharded NCHW input: the halo
    exchange, then the conv VALID along H and 'SAME' along W.  ``kernel``
    is OIHW with odd sizes (an even kernel pads 'SAME' asymmetrically,
    which a symmetric halo would get wrong).  Equals the unsharded conv's
    rows of this shard."""
    kh, kw = kernel.shape[2], kernel.shape[3]
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"sharded_same_conv requires odd kernel dims, got {(kh, kw)}")
    padded = halo_exchange(x, kh // 2, spatial_axis=2)
    return F.conv2d(padded, kernel, padding=(0, kw // 2))
