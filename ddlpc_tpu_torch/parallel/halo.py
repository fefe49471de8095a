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

Uneven shards.  The input keeps the JAX package's layout (rank ``s`` holds
rows ``[s·H/S, (s+1)·H/S)``), but a level of ``G`` rows that ``S`` does not
divide is laid out by :func:`row_layout`: rank ``s`` holds
``[⌊s·G/S⌋, ⌊(s+1)·G/S⌋)``, some ranges possibly empty.  ``⌊⌊x⌋/n⌋ =
⌊x/n⌋``, so a stride-``n`` op whose input is resharded to the boundaries
rounded down to multiples of ``n`` (:func:`aligned`) leaves the canonical
layout of ``G/n`` rows, and an up-sampling by ``r`` is resharded from
``r`` times its input's layout to the canonical one of ``r·G`` rows
(:func:`scaled`).  :func:`reshard` moves the rows in one exchange and its
backward moves each row's cotangent back to its owner: it sums nothing, so
both directions are exact.  Where ``S`` divides ``G`` every layout here is
the even one, the reshard is the identity and the halo takes its
equal-shard path, so even shards keep their messages and bits.  Given a
layout, :func:`halo_exchange` takes each halo row from the rank that holds
it, past empty ranks, and the clamp and fill from the global edges' rows.

Under gloo with ranks time-sharing a card the rows go through the host
(``mesh.exchange``); NCCL sends them card to card with ``batch_isend_irecv``.
"""

from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from ddlpc_tpu_torch.parallel import mesh

EDGES = ("zeros", "-inf", "clamp")

# What the reshards moved in this process: calls that sent or received a
# row, bytes sent, seconds in their exchanges (host clock; under gloo a
# card's rows are copied through the host inside them).  Read and reset by
# the caller.
RESHARD_STATS = {"calls": 0, "bytes": 0, "seconds": 0.0}


def row_layout(rows: int, space: int) -> tuple:
    """The boundaries ``(b_0, …, b_S)`` of ``rows`` global rows over
    ``space`` ranks: rank ``s`` holds ``[b_s, b_{s+1})``, ``b_s = ⌊s·rows/
    space⌋`` — the JAX package's even shards where ``space`` divides
    ``rows``, else ranges that differ by at most one row (empty where
    ``rows < space``)."""
    return tuple(s * rows // space for s in range(space + 1))


def aligned(layout: tuple, n: int) -> tuple:
    """``layout`` with every boundary rounded down to a multiple of ``n``
    (the last, the global row count, must be one): each range then starts
    on a stride-``n`` op's phase.  Of :func:`row_layout` ``(G, S)`` it is
    ``n ×`` :func:`row_layout` ``(G/n, S)``."""
    if layout[-1] % n:
        raise ValueError(f"{layout[-1]} global rows do not divide by the stride {n}")
    return tuple(n * (b // n) for b in layout)


def scaled(layout: tuple, r: int) -> tuple:
    """The layout of an op that maps each row to ``r`` rows (an
    up-sampling, depth-to-space)."""
    return tuple(b * r for b in layout)


def is_even(layout) -> bool:
    """Whether every rank holds the same number of rows (None: the caller
    knows no layout, which is the even one)."""
    return layout is None or len({b - a for a, b in zip(layout, layout[1:])}) == 1


def _owner(layout: tuple, row: int) -> int:
    """The rank whose range holds global ``row`` (the last of equal
    boundaries: empty ranges hold nothing)."""
    s = 0
    while layout[s + 1] <= row:
        s += 1
    return s


def _move(x: torch.Tensor, src: tuple, dst: tuple, axis: int) -> torch.Tensor:
    """This rank's rows of ``dst`` from its rows of ``src``: what another
    rank holds comes in one ``mesh.exchange``, each range from its one
    owner."""
    ranks, s = mesh.grid().ranks("space"), mesh.space_index()
    sends, recvs, pieces = [], [], []
    for t in range(len(ranks)):
        lo, hi = max(src[s], dst[t]), min(src[s + 1], dst[t + 1])
        if lo < hi and t != s:
            sends.append((x.narrow(axis, lo - src[s], hi - lo).contiguous(), ranks[t]))
        lo, hi = max(src[t], dst[s]), min(src[t + 1], dst[s + 1])
        if lo < hi:
            if t == s:
                pieces.append(x.narrow(axis, lo - src[s], hi - lo))
            else:
                shape = list(x.shape)
                shape[axis] = hi - lo
                pieces.append(x.new_empty(shape))
                recvs.append((pieces[-1], ranks[t]))
    if sends or recvs:
        t0 = time.perf_counter()
        mesh.exchange(sends, recvs, axis="space")
        RESHARD_STATS["calls"] += 1
        RESHARD_STATS["bytes"] += sum(t.numel() * t.element_size() for t, _ in sends)
        RESHARD_STATS["seconds"] += time.perf_counter() - t0
    if not pieces:
        shape = list(x.shape)
        shape[axis] = 0
        return x.new_empty(shape)
    return torch.cat(pieces, dim=axis)


class _Reshard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, src: tuple, dst: tuple, axis: int) -> torch.Tensor:
        ctx.src, ctx.dst, ctx.axis = src, dst, axis
        return _move(x, src, dst, axis)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _move(g.contiguous(), ctx.dst, ctx.src, ctx.axis), None, None, None


def reshard(x: torch.Tensor, src: tuple, dst: tuple, axis: int = 2) -> torch.Tensor:
    """This rank's rows of layout ``dst`` (boundaries of global rows, as
    :func:`row_layout` gives them) from its rows ``x`` of layout ``src``,
    along ``axis``: every rank sends the rows of its range that lie in
    another's target range, in one exchange.  Differentiable: the backward
    sends each row's cotangent back to the rank it came from.  The
    identity, with no exchange, where the layouts are equal.  Every rank
    of the space group must call it."""
    if src == dst or mesh.space_size() == 1:
        return x
    if src[-1] != dst[-1] or len(src) != mesh.space_size() + 1:
        raise ValueError(f"cannot reshard layout {src} to {dst} over "
                         f"{mesh.space_size()} ranks")
    return _Reshard.apply(x, tuple(src), tuple(dst), axis % x.dim())


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


def _halo_rows(layout: tuple, s: int, top: int, bottom: int, edge: str) -> list:
    """The global rows of rank ``s``'s halo, above then below its range
    (none for an empty range): a row past the global edges is ``None``
    (the fill) or, under ``clamp``, the edge row it repeats."""
    lo, hi, total = layout[s], layout[s + 1], layout[-1]
    if lo == hi:
        return []
    rows = list(range(lo - top, lo)) + list(range(hi, hi + bottom))
    if edge == "clamp":
        return [min(max(r, 0), total - 1) for r in rows]
    return [r if 0 <= r < total else None for r in rows]


class _LayoutHalo(torch.autograd.Function):
    """The halo of an uneven layout: each halo row comes from the rank
    that holds it (one message a peer, in the order the receiver needs
    them), the fills are made locally; the backward sends each halo row's
    cotangent back and adds what comes back into the rows sent
    (``index_add_``, so a clamped row repeated sums its copies)."""

    @staticmethod
    def forward(ctx, x, layout: tuple, top: int, bottom: int, axis: int, edge: str):
        ranks, s = mesh.grid().ranks("space"), mesh.space_index()
        fill = float("-inf") if edge == "-inf" else 0.0
        need = [_halo_rows(layout, t, top, bottom, edge) for t in range(len(ranks))]
        # to[t]: my local rows that rank t's halo takes, in its order.
        to = {t: [r - layout[s] for r in need[t] if r is not None and _owner(layout, r) == s]
              for t in range(len(ranks)) if t != s}
        to = {t: idx for t, idx in to.items() if idx}
        mine = need[s]
        owners = [None if r is None else _owner(layout, r) for r in mine]
        frm = {u: owners.count(u) for u in set(owners) if u is not None and u != s}
        sends = [(x.index_select(axis, torch.tensor(idx, device=x.device)), ranks[t])
                 for t, idx in sorted(to.items())]
        bufs = {}
        for u, n in sorted(frm.items()):
            shape = list(x.shape)
            shape[axis] = n
            bufs[u] = x.new_empty(shape)
        mesh.exchange(sends, [(b, ranks[u]) for u, b in sorted(bufs.items())], axis="space")
        rows, taken = [], {u: 0 for u in bufs}
        for r, u in zip(mine, owners):
            if u is None:
                rows.append(_rows_of(x, axis, 1, fill))
            elif u == s:
                rows.append(x.narrow(axis, r - layout[s], 1))
            else:
                rows.append(bufs[u].narrow(axis, taken[u], 1))
                taken[u] += 1
        ctx.axis, ctx.top, ctx.n = axis, top, x.shape[axis]
        ctx.layout, ctx.mine, ctx.owners, ctx.to = layout, mine, owners, to
        if not rows:
            return x.clone()
        return torch.cat([*rows[:top], x, *rows[top:]], dim=axis)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        axis, top, n, layout = ctx.axis, ctx.top, ctx.n, ctx.layout
        ranks, s = mesh.grid().ranks("space"), mesh.space_index()
        if not ctx.mine:
            return g.clone(), None, None, None, None, None
        gx = g.narrow(axis, top, n).clone()
        halo = torch.cat([g.narrow(axis, 0, top), g.narrow(axis, top + n, g.shape[axis] - top - n)],
                         dim=axis)
        back = {}
        for i, (r, u) in enumerate(zip(ctx.mine, ctx.owners)):
            if u is not None:
                back.setdefault(u, ([], []))
                back[u][0].append(i)
                back[u][1].append(r - layout[u])
        dev = g.device
        sends = [(halo.index_select(axis, torch.tensor(pos, device=dev)), ranks[u])
                 for u, (pos, _) in sorted(back.items()) if u != s]
        recvs = {}
        for t, idx in sorted(ctx.to.items()):
            shape = list(g.shape)
            shape[axis] = len(idx)
            recvs[t] = g.new_empty(shape)
        mesh.exchange(sends, [(b, ranks[t]) for t, b in sorted(recvs.items())], axis="space")
        if s in back:
            pos, local = back[s]
            gx.index_add_(axis, torch.tensor(local, device=dev),
                          halo.index_select(axis, torch.tensor(pos, device=dev)))
        for t, b in sorted(recvs.items()):
            gx.index_add_(axis, torch.tensor(ctx.to[t], device=dev), b)
        return gx, None, None, None, None, None


def halo_exchange(
    x: torch.Tensor, halo, spatial_axis: int = 2, edge: str = "zeros",
    multi_hop: bool = False, layout: tuple | None = None,
) -> torch.Tensor:
    """Concatenate rows of this shard's space neighbours onto it along
    ``spatial_axis`` (2 for the port's NCHW, 1 for NHWC): ``halo`` rows a
    side, or ``halo = (top, bottom)`` rows above and below, giving
    ``[.., top + H_local + bottom, ..]``.  Past the global edges the halo
    is ``edge``: zeros ('SAME' zero padding), ``-inf`` (a max pool's
    padding) or the shard's own edge row repeated (``clamp``, replicate
    padding).  A count larger than the local rows raises, as the JAX
    package's exchange does, unless ``multi_hop`` (not under ``clamp``):
    then the rows come from as many shards as they span.  ``layout`` (the
    boundaries of this level's global rows, :func:`row_layout`) where the
    ranks' rows differ: each halo row then comes from the rank that holds
    it, however far, empty ranges are passed over, a rank with no rows
    takes no halo, and ``clamp`` repeats the global edge rows.  Every rank
    of the space group must call it."""
    if edge not in EDGES:
        raise ValueError(f"unknown halo edge {edge!r} ({' | '.join(EDGES)})")
    top, bottom = (halo, halo) if isinstance(halo, int) else (int(halo[0]), int(halo[1]))
    if min(top, bottom) < 0:
        raise ValueError(f"negative halo {(top, bottom)}")
    if top == bottom == 0:
        return x
    rows = x.shape[spatial_axis]
    if mesh.space_size() > 1 and not is_even(layout):
        return _LayoutHalo.apply(x, tuple(layout), top, bottom, spatial_axis % x.dim(), edge)
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
