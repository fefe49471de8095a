"""The world: process group, process grid, rank device and collectives —
the port's counterpart of ``ddlpc_tpu/parallel/mesh.py``.

One process per device of the JAX package's mesh, as ``torchrun
--nproc-per-node W`` starts them: every process reads ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK`` from its environment (the variables
``initialize_distributed`` of the JAX package reads under other names) and
joins one ``torch.distributed`` group.  :func:`init_grid` lays the ranks
out as ``make_mesh`` lays out devices, ``pipe × data × space`` with
``pipe`` outermost and ``space`` innermost, and builds the process groups
of each axis (:class:`Grid`): the ``data`` groups carry the gradient wire,
the ``space`` groups the halo rows and the spatial BatchNorm statistics,
a stage's (data, space) group its loss and gradient sums.  Without a grid
(or with ``pipe = space = 1``) the world is one flat data axis, as before.

The backend is the caller's explicit choice, never switched on its own:
NCCL when each rank has a card of its own, gloo otherwise (the CPU, or
several ranks time-sharing one card, which NCCL refuses).

The collectives here are the ones the gradient sync and the train step
use, and the ring transport's point-to-point hop (:func:`ring_shift`).
Neither backend sums int16 (NCCL has no such type; gloo raises "Invalid
scalar type"), so an int16 operand is widened to int32 for a collective
that sums and narrowed back: exact, because every sum the codec puts on
that wire is bounded by ``world · levels ≤ 32767``.  That moves twice the
bytes of the JAX package's s16 ``psum``.

The census (:func:`census`): while it is on, every collective issued here
records one row (:func:`_record`): the op, the axis, the dtype that goes to
``torch.distributed`` (after the int16 widening), the elements and bytes,
and the caller's ``role``, ``wire`` where the gradient sync or a ZeRO
level's params all-gather issues it (the call sites pass it), ``aux`` for
everything else (sync-BN, the batch statistics' mean, the metrics, the
trainer's header).  It also counts the codec's entry calls
(``ops/cuda_quantize.py``).  Off, each collective tests one flag and
records nothing.  ``analysis/program.py`` holds a step's census to its
closed forms.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def world_from_env() -> Tuple[int, int, int]:
    """``(rank, world_size, local_rank)`` from the environment; a process
    started without them is the whole world ``(0, 1, 0)``."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", str(rank)))
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"RANK={rank} is not in a world of WORLD_SIZE={world}")
    return rank, world, local


def default_backend(device: torch.device) -> str:
    """NCCL for a card, gloo for the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def rank_device(device: str) -> torch.device:
    """The device of this rank: ``cuda`` is ``cuda:{LOCAL_RANK}`` and raises
    when this host has no such card; ``cuda:i`` pins every rank to card
    ``i``; ``cpu`` is the CPU.  Nothing is picked on the caller's behalf."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        local = world_from_env()[2]
        count = torch.cuda.device_count()
        if local >= count:
            raise RuntimeError(
                f"--device cuda puts rank LOCAL_RANK={local} on cuda:{local}, "
                f"but this host has {count} card(s); pass --device cuda:0 "
                f"(with --dist-backend gloo) to time-share one card"
            )
        dev = torch.device("cuda", local)
    return dev


def initialize_distributed(backend: str, init_method: Optional[str] = None) -> None:
    """Join the world the environment describes.  A no-op for a world of 1
    and when this process already joined one.  ``init_method`` defaults to
    ``env://`` (``MASTER_ADDR``/``MASTER_PORT``, which torchrun sets); a
    ``file://`` path needs no port."""
    if dist.is_initialized():
        return
    rank, world, _ = world_from_env()
    if world == 1:
        return
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected one of {BACKENDS})")
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank, world_size=world
    )


def destroy_distributed() -> None:
    """Leave the world, if this process joined one, and forget its grid."""
    reset_grid()
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclass
class Grid:
    """The ranks of a ``pipe × data × space`` world laid out as the JAX
    package's ``make_mesh`` lays out devices: global rank
    ``(p·data + d)·space + s`` holds mesh position ``(p, d, s)``.  The
    groups are ``torch.distributed`` process groups, or None where the
    group is the whole world (``dist``'s default) or a single rank."""

    pipe: int
    data: int
    space: int
    rank: int
    groups: dict = field(default_factory=dict)
    stage_groups: List = field(default_factory=list)

    @property
    def coords(self) -> Tuple[int, int, int]:
        """``(pipe, data, space)`` indices of this rank."""
        return coords_of(self.rank, self.data, self.space)

    def global_rank(self, p: int, d: int, s: int) -> int:
        return (p * self.data + d) * self.space + s

    def ranks(self, axis: str, rank: Optional[int] = None) -> List[int]:
        """The global ranks of ``rank``'s (default: this one's) group along
        ``axis`` (``data``, ``space``, ``stage`` or ``world``), in group
        order."""
        p, d, s = coords_of(self.rank if rank is None else rank, self.data, self.space)
        if axis == "data":
            return [self.global_rank(p, i, s) for i in range(self.data)]
        if axis == "space":
            return [self.global_rank(p, d, i) for i in range(self.space)]
        if axis == "stage":
            return [self.global_rank(p, i, j) for i in range(self.data) for j in range(self.space)]
        if axis == "world":
            return list(range(self.pipe * self.data * self.space))
        raise ValueError(f"unknown grid axis {axis!r} (data | space | stage | world)")


def coords_of(rank: int, data: int, space: int) -> Tuple[int, int, int]:
    return rank // (data * space), (rank // space) % data, rank % space


def grid_shape(world: int, pipe: int = 1, data: int = -1, space: int = 1) -> Tuple[int, int, int]:
    """``(pipe, data, space)`` for a world of ``world`` processes, raising
    where ``make_mesh`` raises: ``data=-1`` absorbs what ``space × pipe``
    leaves.  Unlike JAX's mesh, which leaves spare devices idle with a
    warning, a process grid must hold every process."""
    space, pipe = max(1, space), max(1, pipe)
    if world % (space * pipe):
        raise ValueError(
            f"space_axis_size={space} × pipeline_stages={pipe} does not "
            f"divide device count {world}"
        )
    if data == -1:
        data = world // (space * pipe)
    if pipe * data * space > world:
        raise ValueError(
            f"mesh {pipe}×{data}×{space} (pipe×data×space) needs "
            f"{pipe * data * space} devices, only {world} available"
        )
    if pipe * data * space < world:
        raise ValueError(
            f"mesh {pipe}×{data}×{space} (pipe×data×space) uses "
            f"{pipe * data * space} of {world} processes; start exactly that many"
        )
    return pipe, data, space


_GRID: Optional[Grid] = None


def init_grid(pipe: int = 1, data: int = -1, space: int = 1) -> Grid:
    """Lay the world out as ``pipe × data × space`` (:func:`grid_shape`)
    and build every axis's process groups; every rank must call it with
    the same sizes (``dist.new_group`` is collective).  The grid becomes
    the one :func:`data_size`, :func:`replica_index` and the collectives
    read."""
    global _GRID
    world, rank = world_size(), world_rank()
    pipe, data, space = grid_shape(world, pipe, data, space)
    grid = Grid(pipe, data, space, rank)
    if pipe * space > 1:
        for axis, count in (("data", pipe * space), ("space", pipe * data), ("stage", pipe)):
            mine = grid.ranks(axis)
            seen = set()
            for r in range(world):
                ranks = tuple(grid.ranks(axis, r))
                if ranks in seen:
                    continue
                seen.add(ranks)
                g = dist.new_group(list(ranks)) if len(ranks) > 1 else None
                if axis == "stage":
                    grid.stage_groups.append(g)
                if list(ranks) == mine:
                    grid.groups[axis] = g
            assert len(seen) == count
    _GRID = grid
    return grid


def reset_grid() -> None:
    """Forget the grid (the world is one flat data axis again)."""
    global _GRID
    _GRID = None


def grid() -> Grid:
    """The grid; without :func:`init_grid`, the world as one data axis."""
    if _GRID is not None:
        return _GRID
    return Grid(1, world_size(), 1, world_rank())


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    """This process's global rank (0 without a group): the one rank that
    writes checkpoints and logs."""
    return dist.get_rank() if dist.is_initialized() else 0


def data_size() -> int:
    """Replicas along the data axis: the world without a grid, 1 without a
    group."""
    return grid().data


def replica_index() -> int:
    """This process's index along the data axis, 0 without a group."""
    return grid().coords[1]


def space_size() -> int:
    return grid().space


def space_index() -> int:
    return grid().coords[2]


def pipe_size() -> int:
    return grid().pipe


def pipe_index() -> int:
    return grid().coords[0]


def axis_size(axis: str) -> int:
    g = grid()
    return {"data": g.data, "space": g.space, "stage": g.data * g.space,
            "world": g.pipe * g.data * g.space}[axis]


def process_group(axis: str = "data"):
    """The ``torch.distributed`` group of this rank along ``axis``; None
    is the default group (the whole world, or the data axis without a
    grid)."""
    if axis == "world" or _GRID is None:
        return None
    return _GRID.groups.get(axis)


def check_world(axis_size: int) -> None:
    """Raise unless the data axis has exactly ``axis_size`` ranks."""
    if data_size() != axis_size:
        raise ValueError(
            f"axis_size={axis_size} but the process group has {data_size()} "
            "rank(s) along the data axis (initialize_distributed joins the "
            "world first, init_grid lays it out)"
        )


def _widened(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32) if t.dtype == torch.int16 else t


ROLES = ("wire", "aux")
# HLO's names for the dtypes a collective may carry (JAX's census names).
DTYPE_NAMES = {
    torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16", torch.int32: "s32",
    torch.int64: "s64", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.float32: "f32", torch.float64: "f64", torch.bool: "pred",
}


@dataclass
class Census:
    """What a stretch of a run issued: ``rows``, one a collective, and
    ``codec``, the codec's entry calls by ``cuda_quantize.LAUNCHES`` name
    (on a CPU tensor the calls that would launch)."""

    rows: List[Dict[str, object]] = field(default_factory=list)
    codec: Dict[str, int] = field(default_factory=dict)
    # The optimizer-boundary gradient of the last sync (note_grads).
    grads: List[torch.Tensor] = field(default_factory=list)


_CENSUS: Optional[Census] = None


@contextlib.contextmanager
def census() -> Iterator[Census]:
    """Take a census of the collectives and codec calls issued inside the
    block (not nested); yields it, and turns it off again on the way out."""
    global _CENSUS
    from ddlpc_tpu_torch.ops import cuda_quantize

    if _CENSUS is not None:
        raise RuntimeError("a census is already on")
    _CENSUS = Census(codec={k: 0 for k in cuda_quantize.LAUNCHES})
    cuda_quantize.CALLS = _CENSUS.codec
    try:
        yield _CENSUS
    finally:
        _CENSUS = None
        cuda_quantize.CALLS = None


def census_on() -> bool:
    return _CENSUS is not None


def note_grads(grads: Sequence[torch.Tensor]) -> None:
    """Keep the gradient a sync left for the update (the whole mean, or
    this replica's chunks of it) in the census, where one is on."""
    if _CENSUS is not None:
        _CENSUS.grads = list(grads)


def _record(op: str, t: torch.Tensor, axis: Optional[str], role: str,
            reduce: Optional[str] = None, widened_from: Optional[torch.dtype] = None,
            elements: Optional[int] = None) -> None:
    """One census row: ``t`` is the tensor handed to ``torch.distributed``
    (the full operand of a reduction, the full output of an all-gather),
    ``elements`` overrides its count (the sum of an exchange's sends)."""
    if role not in ROLES:
        raise ValueError(f"unknown collective role {role!r} (expected one of {ROLES})")
    n = t.numel() if elements is None else elements
    row = {"op": op, "axis": axis or "world", "dtype": DTYPE_NAMES[t.dtype], "elements": n,
           "bytes": n * t.element_size(), "role": role, "reduce": reduce}
    if widened_from is not None:
        row["widened_from"] = DTYPE_NAMES[widened_from]
    _CENSUS.rows.append(row)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce_(t: torch.Tensor, op: str = "sum", axis: str = "data",
                role: str = "aux") -> torch.Tensor:
    """Reduce ``t`` over this rank's ``axis`` group IN PLACE (``op``
    ``sum`` or ``max``); returns ``t``.  The identity on a group of one.
    ``role`` is the census' (``wire`` or ``aux``)."""
    if axis_size(axis) == 1:
        return t
    wide = _widened(t)
    if _CENSUS is not None:
        _record("all_reduce", wide, axis, role, op, t.dtype if wide is not t else None)
    dist.all_reduce(wide, op=_OPS[op], group=process_group(axis))
    if wide is not t:
        t.copy_(wide)
    return t


def reduce_scatter(t: torch.Tensor, role: str = "aux") -> torch.Tensor:
    """Sum ``t`` (``N · K`` elements, ``N`` the data axis) over the data
    axis and return this rank's ``K``-element chunk of the sum, a new
    tensor."""
    world = data_size()
    if t.numel() % world:
        raise ValueError(f"{t.numel()} elements do not split into {world} chunks")
    if world == 1:
        return t.clone()
    wide = _widened(t)
    if _CENSUS is not None:
        _record("reduce_scatter", wide, "data", role, "sum", t.dtype if wide is not t else None)
    out = torch.empty(t.numel() // world, dtype=wide.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, wide, group=process_group("data"))
    return out.to(t.dtype)


def all_gather_(buf: torch.Tensor, role: str = "aux") -> torch.Tensor:
    """Fill ``buf`` (``N · K`` elements, ``N`` the data axis) IN PLACE with
    every replica's ``K``-element chunk, each replica's own chunk being
    the one at its index; returns ``buf``."""
    world = data_size()
    k = buf.numel() // world
    if k * world != buf.numel():
        raise ValueError(f"{buf.numel()} elements do not split into {world} chunks")
    if world == 1:
        return buf
    r = replica_index()
    if _CENSUS is not None:
        _record("all_gather", buf, "data", role)
    dist.all_gather_into_tensor(buf, buf[r * k : (r + 1) * k], group=process_group("data"))
    return buf


def exchange(sends: Sequence[Tuple[torch.Tensor, int]], recvs: Sequence[Tuple[torch.Tensor, int]],
             axis: Optional[str] = None, role: str = "aux") -> None:
    """Post every send ``(tensor, global rank)`` and receive ``(buffer,
    global rank)`` together and wait for all of them, so that no order of
    ranks can deadlock.  gloo takes CPU tensors only: a card's tensors go
    through host copies (the receive buffers are filled in place either
    way); bfloat16 travels as its int16 bits.  Buffers may differ in
    size; an empty one posts nothing (its peer, which sizes the same
    message alike, posts nothing either).  ``axis`` names the group the
    peers share (None: the world).  Its census row counts the elements
    sent, in the first send's dtype."""
    sends = [(t, peer) for t, peer in sends if t.numel()]
    recvs = [(t, peer) for t, peer in recvs if t.numel()]
    if not sends and not recvs:
        return
    if _CENSUS is not None and sends:
        _record("exchange", sends[0][0], axis, role, elements=sum(t.numel() for t, _ in sends))
    _exchange(sends, recvs, axis)


def _exchange(sends, recvs, axis: Optional[str]) -> None:
    host = dist.get_backend() == "gloo" and any(t.is_cuda for t, _ in (*sends, *recvs))
    group = process_group(axis) if axis else None

    def bits(t: torch.Tensor) -> torch.Tensor:
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    ops, stage = [], []
    for t, peer in sends:
        buf = bits(t.contiguous())
        ops.append(dist.P2POp(dist.isend, buf.cpu() if host else buf, peer, group))
    for t, peer in recvs:
        buf = torch.empty(t.shape, dtype=bits(t).dtype) if host else bits(t)
        stage.append((t, buf))
        ops.append(dist.P2POp(dist.irecv, buf, peer, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for t, buf in stage:
        if host:
            bits(t).copy_(buf)


def ring_shift(t: torch.Tensor, role: str = "aux") -> torch.Tensor:
    """One hop of a unidirectional ring along the data axis: send ``t`` to
    replica ``r + 1`` and return what replica ``r − 1`` sent (a new tensor
    of ``t``'s shape and dtype, on its device).  The send and the receive
    are posted together, so no order of ranks can deadlock.  The bytes
    sent are ``t``'s own, in its dtype; gloo moves a card's tensor through
    a host copy (its point-to-point ops take CPU tensors)."""
    ranks, r = grid().ranks("data"), replica_index()
    world = len(ranks)
    recv = torch.empty_like(t)
    if t.numel():
        if _CENSUS is not None:
            _record("ring_shift", t, "data", role)
        _exchange([(t, ranks[(r + 1) % world])], [(recv, ranks[(r - 1) % world])], None)
    return recv


def broadcast_(t: torch.Tensor, src: int = 0, role: str = "aux") -> torch.Tensor:
    """Overwrite ``t`` IN PLACE with global rank ``src``'s; returns ``t``."""
    if dist.is_initialized():
        if _CENSUS is not None:
            _record("broadcast", t, "world", role)
        dist.broadcast(t, src)
    return t


def spawn_world(
    argv: Sequence[str],
    world: int,
    deadline_s: float,
    env: Optional[dict] = None,
    cwd: Optional[str] = None,
) -> None:
    """Run ``argv`` as ``world`` local processes, one rank each (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` set as torchrun sets them), and wait for
    all of them.  A rank that exits non-zero, or a world still running at
    ``deadline_s``, has every rank killed and raises: one rank that fails
    leaves the others blocked inside a collective."""
    base = dict(os.environ if env is None else env)
    procs = []
    try:
        for r in range(world):
            e = dict(base, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                     LOCAL_WORLD_SIZE=str(world))
            procs.append(subprocess.Popen(list(argv), env=e, cwd=cwd))
        end = time.monotonic() + deadline_s
        while True:
            rcs = [p.poll() for p in procs]
            failed = [(r, rc) for r, rc in enumerate(rcs) if rc not in (None, 0)]
            if failed:
                raise RuntimeError(
                    f"rank {failed[0][0]} exited with {failed[0][1]}; the world was killed"
                )
            if all(rc == 0 for rc in rcs):
                return
            if time.monotonic() > end:
                raise TimeoutError(
                    f"world of {world} still running after {deadline_s} s; killed"
                )
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
