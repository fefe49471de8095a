"""The data-parallel world: process group, rank device and collectives — the
port's counterpart of ``ddlpc_tpu/parallel/mesh.py``.

One process per replica, as ``torchrun --nproc-per-node W`` starts them:
every process reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` from its
environment (the variables ``initialize_distributed`` of the JAX package
reads under other names) and joins one ``torch.distributed`` group.  The
JAX package's ``data`` mesh axis is this group; there is no space or pipe
axis in the port.

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
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import Optional, Sequence, Tuple

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
    """Leave the world, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def data_size() -> int:
    """Replicas in the world: the group's size, 1 without a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def replica_index() -> int:
    """This process's replica index, 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def check_world(axis_size: int) -> None:
    """Raise unless the process group has exactly ``axis_size`` ranks."""
    if data_size() != axis_size:
        raise ValueError(
            f"axis_size={axis_size} but the process group has {data_size()} "
            "rank(s) (initialize_distributed joins the world first)"
        )


def _widened(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32) if t.dtype == torch.int16 else t


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce_(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` over the world IN PLACE (``op`` ``sum`` or ``max``);
    returns ``t``."""
    wide = _widened(t)
    dist.all_reduce(wide, op=_OPS[op])
    if wide is not t:
        t.copy_(wide)
    return t


def reduce_scatter(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` (``world · K`` elements) over the world and return this
    rank's ``K``-element chunk of the sum, a new tensor."""
    world = data_size()
    if t.numel() % world:
        raise ValueError(f"{t.numel()} elements do not split into {world} chunks")
    wide = _widened(t)
    out = torch.empty(t.numel() // world, dtype=wide.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, wide)
    return out.to(t.dtype)


def all_gather_(buf: torch.Tensor) -> torch.Tensor:
    """Fill ``buf`` (``world · K`` elements) IN PLACE with every rank's
    ``K``-element chunk, each rank's own chunk being the one at its
    index; returns ``buf``."""
    world = data_size()
    k = buf.numel() // world
    if k * world != buf.numel():
        raise ValueError(f"{buf.numel()} elements do not split into {world} chunks")
    r = replica_index()
    dist.all_gather_into_tensor(buf, buf[r * k : (r + 1) * k])
    return buf


def ring_shift(t: torch.Tensor) -> torch.Tensor:
    """One hop of a unidirectional ring: send ``t`` to rank ``r + 1`` and
    return what rank ``r − 1`` sent (a new tensor of ``t``'s shape and
    dtype, on its device).  The send and the receive are posted together,
    so no order of ranks can deadlock.  The bytes sent are ``t``'s own, in
    its dtype; gloo moves a card's tensor through a host copy (its
    point-to-point ops take CPU tensors)."""
    world, rank = data_size(), replica_index()
    host = t.is_cuda and dist.get_backend() == "gloo"
    send = t.cpu() if host else t.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, (rank + 1) % world),
           dist.P2POp(dist.irecv, recv, (rank - 1) % world)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(t.device) if host else recv


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Overwrite ``t`` IN PLACE with rank ``src``'s; returns ``t``."""
    if dist.is_initialized():
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
