"""Halo exchange for H-sharded convolutions — the port's copy of
``ddlpc_tpu/parallel/halo.py``.

A tile too large for one device is sharded along H over the ``space``
axis (``parallel/mesh.py``), and each 'SAME' conv needs ``k//2`` rows of
its neighbours.  :func:`halo_exchange` sends a shard's top rows to the
shards above and its bottom rows to the shards below and concatenates
what arrives; the global edges receive zeros, as JAX's ``ppermute`` gives
a device with no source, which composes exactly with 'SAME' zero padding.
Where the JAX package lets XLA's partitioner insert these exchanges, the
port's spatial models call this one (``models/layers.Conv``,
``layers.max_pool_same``, ``layers.upsample``).  Beyond JAX's primitive:

- separate top and bottom counts, for the one-sided halo of a stride-2
  'SAME' window (flax pads it (0, 1) on an even grid);
- ``multi_hop``: a count larger than a shard's rows takes rows from as
  many shards along the space group as it spans, each row sent straight
  from the shard that owns it (a dilation-18 conv on 8 rows a shard reads
  three shards away), and fills past the global edge;
- the fill past the global edges: zeros (a conv), ``-inf`` (a max pool),
  or the shard's own edge row repeated (``clamp``, replicate padding,
  which composes with the edge clamp of a bilinear resize).

The exchange is differentiable: its backward is the adjoint, as JAX
transposes ``ppermute`` — each halo row's cotangent goes back to the
shard it came from, across as many shards as it came, and is added into
that row; under ``edge="clamp"`` the cotangent of a global edge's halo is
added into the edge row; a fill's cotangent is dropped.

Under gloo with ranks time-sharing a card the rows go through the host
(``mesh.exchange``); NCCL sends them card to card with ``batch_isend_irecv``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ddlpc_tpu_torch.parallel import mesh

EDGES = ("zeros", "-inf", "clamp")


def _hop_counts(rows: int, need: int) -> list:
    """Rows taken from the shard ``k + 1`` away, for ``k = 0, 1, …``: whole
    shards of ``rows`` rows until ``need`` rows are covered."""
    return [min(rows, need - k * rows) for k in range(-(-need // rows))]


def _edge_rows(x: torch.Tensor, axis: int, at: int, halo: int) -> torch.Tensor:
    """Row ``at`` of ``x`` along ``axis``, repeated ``halo`` times."""
    shape = list(x.shape)
    shape[axis] = halo
    return x.narrow(axis, at, 1).expand(shape)


def _rows_of(x: torch.Tensor, axis: int, count: int, value: float) -> torch.Tensor:
    shape = list(x.shape)
    shape[axis] = count
    return x.new_full(shape, value)


def _post(to_below: list, from_above: list, to_above: list, from_below: list) -> None:
    """One exchange over the space group, every hop in one
    ``mesh.exchange``: entry ``k − 1`` of each list goes to, or is filled
    from, the shard ``k`` below or above; a shard past the global edge is
    skipped (its receive buffer keeps what it holds)."""
    ranks, s = mesh.grid().ranks("space"), mesh.space_index()
    sends, recvs = [], []
    for k in range(1, max(len(to_below), len(to_above)) + 1):
        for bufs, peer, out in ((to_below, s + k, sends), (from_above, s - k, recvs),
                                (to_above, s - k, sends), (from_below, s + k, recvs)):
            if k <= len(bufs) and 0 <= peer < len(ranks):
                out.append((bufs[k - 1], ranks[peer]))
    mesh.exchange(sends, recvs, axis="space")


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, top: int, bottom: int, axis: int, edge: str) -> torch.Tensor:
        n = x.shape[axis]
        ups, downs = _hop_counts(n, top), _hop_counts(n, bottom)
        ctx.axis, ctx.ups, ctx.downs = axis, ups, downs
        fill = float("-inf") if edge == "-inf" else 0.0
        # from_up[k - 1]: the bottom rows of the shard k above (my top
        # halo); from_down[k - 1]: the top rows of the shard k below.
        from_up = [_rows_of(x, axis, c, fill) for c in ups]
        from_down = [_rows_of(x, axis, c, fill) for c in downs]
        # My bottom rows are the top halo of the shards below, my top rows
        # the bottom halo of those above.
        _post([x.narrow(axis, n - c, c).contiguous() for c in ups], from_up,
              [x.narrow(axis, 0, c).contiguous() for c in downs], from_down)
        # Under "clamp" the global edges repeat the shard's own edge row.
        s, last = mesh.space_index(), mesh.space_size() - 1
        ctx.clamp_up = edge == "clamp" and s == 0 and bool(ups)
        ctx.clamp_down = edge == "clamp" and s == last and bool(downs)
        if ctx.clamp_up:
            from_up[0] = _edge_rows(x, axis, 0, ups[0])
        if ctx.clamp_down:
            from_down[0] = _edge_rows(x, axis, n - 1, downs[0])
        return torch.cat([*reversed(from_up), x, *from_down], dim=axis)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        axis, ups, downs = ctx.axis, ctx.ups, ctx.downs
        top = sum(ups)
        n = g.shape[axis] - top - sum(downs)
        # The halo's cotangents by hop, each going back to the shard that
        # sent its rows; what comes back is the cotangent of my bottom
        # rows from the shards below and of my top rows from those above
        # (zeros at the global edges).
        g_up = [g.narrow(axis, top - sum(ups[: k + 1]), c).contiguous() for k, c in enumerate(ups)]
        g_down = [g.narrow(axis, top + n + sum(downs[:k]), c).contiguous()
                  for k, c in enumerate(downs)]
        back_bottom = [torch.zeros_like(t) for t in g_up]
        back_top = [torch.zeros_like(t) for t in g_down]
        _post(g_down, back_top, g_up, back_bottom)
        gx = g.narrow(axis, top, n).clone()
        for k in range(max(len(ups), len(downs))):
            if k < len(downs):
                gx.narrow(axis, 0, downs[k]).add_(back_top[k])
            if k < len(ups):
                gx.narrow(axis, n - ups[k], ups[k]).add_(back_bottom[k])
        # Replicate padding's adjoint: a clamped halo's cotangent goes
        # into the edge row it copied.
        if ctx.clamp_up:
            gx.narrow(axis, 0, 1).add_(g_up[0].sum(axis, keepdim=True))
        if ctx.clamp_down:
            gx.narrow(axis, n - 1, 1).add_(g_down[0].sum(axis, keepdim=True))
        return gx, None, None, None, None


def halo_exchange(
    x: torch.Tensor, halo, spatial_axis: int = 2, edge: str = "zeros",
    multi_hop: bool = False,
) -> torch.Tensor:
    """Concatenate rows of this shard's space neighbours onto it along
    ``spatial_axis`` (2 for the port's NCHW, 1 for NHWC): ``halo`` rows a
    side, or ``halo = (top, bottom)`` rows above and below, giving
    ``[.., top + H_local + bottom, ..]``.  Past the global edges the halo
    is ``edge``: zeros ('SAME' zero padding), ``-inf`` (a max pool's
    padding) or the shard's own edge row repeated (``clamp``, replicate
    padding).  A count larger than the local rows raises, as the JAX
    package's exchange does, unless ``multi_hop`` (not under ``clamp``):
    then the rows come from as many shards as they span.  Every rank of
    the space group must call it."""
    if edge not in EDGES:
        raise ValueError(f"unknown halo edge {edge!r} ({' | '.join(EDGES)})")
    top, bottom = (halo, halo) if isinstance(halo, int) else (int(halo[0]), int(halo[1]))
    if min(top, bottom) < 0:
        raise ValueError(f"negative halo {(top, bottom)}")
    if top == bottom == 0:
        return x
    rows = x.shape[spatial_axis]
    if max(top, bottom) > rows and (not multi_hop or edge == "clamp"):
        raise ValueError(
            f"local spatial extent {rows} smaller than halo "
            f"{max(top, bottom)}; use fewer shards or larger tiles"
        )
    if mesh.space_size() == 1:
        if edge == "clamp":
            return torch.cat([_edge_rows(x, spatial_axis, 0, top), x,
                              _edge_rows(x, spatial_axis, rows - 1, bottom)], dim=spatial_axis)
        pad = [0, 0] * (x.dim() - 1 - spatial_axis) + [top, bottom]
        return F.pad(x, pad, value=float("-inf") if edge == "-inf" else 0.0)
    return _HaloExchange.apply(x, top, bottom, spatial_axis, edge)


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
