"""The DWZ1 wire codec: block-parallel deflate and its framing — the port's
copy of ``ddlpc_tpu/utils/wire.py``.

The payload is split into fixed blocks, each deflated independently, so
compression and decompression both run across a thread pool.  Two
implementations write the same frames: the native library
(``kernels/host/wire.cc``, ``utils/native.load_wire``, built with ``g++``
at first use), which :func:`compress`, :func:`decompress` and
:func:`decompress_into` take by default, and Python's ``zlib`` (which
releases the GIL on large buffers), the plain version that the tests hold
the native one against.  :func:`set_native` picks one for the process
(the trainer: ``data.native_gather``); the frames are the same bytes
where both link the same zlib.

Frame layout (little-endian)::

    magic  4B  b"DWZ1"
    nblk   u32 number of blocks
    per block: raw_len u32, comp_len u32, comp bytes

``compress_chunks`` streams independent payloads (a checkpoint's chunks)
into frames in order while the next ones compress, and with
``adaptive=True`` stores a chunk that deflate would barely shrink
(:func:`probe_level`).
"""

from __future__ import annotations

import concurrent.futures
import os
import struct
import zlib
from typing import List, Optional, Tuple

from ddlpc_tpu_torch.utils import native

MAGIC = b"DWZ1"
BLOCK_SIZE = 1 << 20  # 1 MiB
LEVEL = 1
_MAX_WORKERS = min(12, os.cpu_count() or 1)

_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
# The native codec (a ``native.NativeWire``), False for Python's zlib, or
# None until the first call resolves it to the native one.
_native = None


def set_native(enabled: bool) -> None:
    """Take the native library (built now if need be; raises
    ``native.NativeBuildError`` when it cannot be) or Python's zlib."""
    global _native
    _native = native.load_wire() if enabled else False


def _get_native():
    global _native
    if _native is None:
        _native = native.load_wire()
    return _native or None


def _get_pool() -> concurrent.futures.ThreadPoolExecutor:
    global _pool
    if _pool is None:
        _pool = concurrent.futures.ThreadPoolExecutor(_MAX_WORKERS)
    return _pool


def compress(data: bytes, level: int = LEVEL, block_size: int = BLOCK_SIZE) -> bytes:
    """Frame + deflate ``data`` in parallel blocks."""
    lib = _get_native()
    if lib is not None:
        return lib.compress(data, level, block_size)
    view = memoryview(data)
    blocks = [view[i : i + block_size] for i in range(0, len(data), block_size)]
    if len(blocks) <= 1:
        comps = [zlib.compress(b, level) for b in blocks]
    else:
        comps = list(_get_pool().map(lambda b: zlib.compress(b, level), blocks))
    out = [MAGIC, struct.pack("<I", len(blocks))]
    for raw, comp in zip(blocks, comps):
        out.append(struct.pack("<II", len(raw), len(comp)))
        out.append(comp)
    return b"".join(out)


def _blocks(data: bytes) -> List[Tuple[int, int, bytes]]:
    """``(raw offset, raw_len, comp bytes)`` of each block of a frame, with
    every header checked against the frame's size."""
    if len(data) < 4:
        raise ValueError("truncated frame: missing magic")
    if data[:4] != MAGIC:
        raise ValueError("bad wire magic; not a DWZ1 frame")
    if len(data) < 8:
        raise ValueError("truncated frame: missing block count")
    (nblk,) = struct.unpack_from("<I", data, 4)
    if nblk > (len(data) - 8) // 8:
        raise ValueError("truncated frame: block count exceeds frame size")
    off = 8
    raw_off = 0
    out = []
    for _ in range(nblk):
        if off + 8 > len(data):
            raise ValueError("truncated frame: missing block header")
        raw_len, comp_len = struct.unpack_from("<II", data, off)
        off += 8
        if off + comp_len > len(data):
            raise ValueError("truncated frame: missing block payload")
        # Deflate cannot expand beyond ~1032:1; a header claiming more is
        # forged.
        if raw_len > comp_len * 1040 + 1024:
            raise ValueError(
                f"corrupt frame: block claims {raw_len} bytes from {comp_len}"
            )
        out.append((raw_off, raw_len, data[off : off + comp_len]))
        raw_off += raw_len
        off += comp_len
    if off != len(data):
        raise ValueError(f"trailing garbage in frame: {len(data) - off} bytes")
    return out


def _inflate(raw_len: int, comp: bytes) -> bytes:
    # Capped at the header's claimed size (+1 to detect excess), so a
    # deflate bomb allocates no more than the header admits to.
    d = zlib.decompressobj()
    raw = d.decompress(comp, raw_len + 1)
    if len(raw) != raw_len or not d.eof or d.unused_data:
        raise ValueError(
            f"block decompressed to {len(raw)}{'+' if not d.eof else ''}, "
            f"header says {raw_len}"
        )
    return raw


def _map(fn, jobs: list) -> list:
    if len(jobs) <= 1:
        return [fn(j) for j in jobs]
    return list(_get_pool().map(fn, jobs))


def decompress(data: bytes) -> bytes:
    """Inverse of :func:`compress`; blocks decompressed in parallel."""
    lib = _get_native()
    if lib is not None:
        return lib.decompress(data)
    return b"".join(_map(lambda b: _inflate(b[1], b[2]), _blocks(data)))


def decompress_into(data: bytes, out: memoryview) -> int:
    """Inflate a DWZ1 frame straight into ``out`` (a writable uint8 view);
    returns the byte count written.  The chunked checkpoint reader inflates
    every chunk into its leaf's buffer this way."""
    lib = _get_native()
    if lib is not None:
        raw = lib.decompress(data)
        if len(raw) > len(out):
            raise ValueError(f"frame inflates to {len(raw)} bytes, buffer holds {len(out)}")
        out[: len(raw)] = raw
        return len(raw)
    blocks = _blocks(data)
    total = sum(raw_len for _, raw_len, _ in blocks)
    if total > len(out):
        raise ValueError(f"frame inflates to {total} bytes, buffer holds {len(out)}")

    def one(block):
        dst, raw_len, comp = block
        out[dst : dst + raw_len] = _inflate(raw_len, comp)

    _map(one, blocks)
    return total


def probe_level(
    sample, level: int = LEVEL, threshold: float = 0.85, probe_bytes: int = 1 << 16
) -> int:
    """Adaptive level for entropy-dense payloads: deflate a small prefix of
    ``sample``; if it barely shrinks (ratio > ``threshold``), return 0 —
    zlib *stored* blocks, at about memcpy speed — else ``level``.  Trained
    fp32 weights shrink only a few percent at level 1 while costing most
    of a save's time; zeroed or quantized tensors shrink 3-200×.  Either
    way the output is a valid deflate stream that every reader inflates."""
    probe = bytes(memoryview(sample)[:probe_bytes])
    if not probe:
        return level
    return 0 if len(zlib.compress(probe, level)) > threshold * len(probe) else level


_stream_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None


def _get_stream_pool() -> concurrent.futures.ThreadPoolExecutor:
    # Distinct from _pool on purpose: a stream task calls compress(), which
    # fans blocks out onto _pool and waits; running the waiters on _pool
    # itself could deadlock with every slot held by a waiter.
    global _stream_pool
    if _stream_pool is None:
        _stream_pool = concurrent.futures.ThreadPoolExecutor(
            2, thread_name_prefix="wire-stream"
        )
    return _stream_pool


def compress_chunks(chunks, level: int = LEVEL, block_size: int = BLOCK_SIZE,
                    window: int = 2, adaptive: bool = False):
    """Compress an iterable of independent payloads into DWZ1 frames,
    yielding them strictly in input order while up to ``window`` later
    chunks compress in the background, so that a writer streams frames to
    disk while the next chunks deflate.  With ``adaptive=True`` each chunk
    is stored or deflated by :func:`probe_level`."""

    def job(chunk):
        lv = probe_level(chunk, level) if adaptive else level
        return compress(bytes(chunk), lv, block_size)

    pool = _get_stream_pool()
    pending: list = []
    try:
        for chunk in chunks:
            pending.append(pool.submit(job, chunk))
            while len(pending) > window:
                yield pending.pop(0).result()
        while pending:
            yield pending.pop(0).result()
    finally:
        for f in pending:
            f.cancel()


def pack_message(payload: bytes) -> bytes:
    """Length-prefix a payload with its u32 length, little-endian (the
    reference's framing, кластер.py:119)."""
    return struct.pack("<I", len(payload)) + payload


def unpack_message(buf: bytes) -> Tuple[bytes, bytes]:
    """``(payload, rest)`` of a length-prefixed buffer; raises
    ``ValueError`` where the prefix or the payload is cut short."""
    if len(buf) < 4:
        raise ValueError("truncated frame: missing length prefix")
    (n,) = struct.unpack_from("<I", buf, 0)
    if len(buf) < 4 + n:
        raise ValueError(f"truncated frame: need {n} payload bytes, have {len(buf) - 4}")
    return bytes(buf[4 : 4 + n]), bytes(buf[4 + n :])
