"""Checkpoint/resume — the port's copy of ``ddlpc_tpu/train/checkpoint.py``.
Two formats, one reader, which dispatches on the file a step has:

- **chunked** (the default, ``ckpt_<step>.dwc``, DWC2), below;
- **monolithic** (legacy, ``ckpt_<step>.msgpack.z``): the whole state tree
  as one flax msgpack blob (``utils/flax_msgpack.py``, byte for byte what
  flax's ``msgpack_serialize`` writes), compressed as one DWZ1 frame
  (``utils/wire.py``).  Written under ``format="monolithic"`` and always
  restorable, so a JAX run's legacy blobs resume, serve and predict in
  the port, and the port's restore in JAX.

A blob holds the state tree that flax's ``to_state_dict(TrainState)``
gives the JAX package — ``step``, ``params``, ``batch_stats`` and
``opt_state``, optax's chain of the optimizer's stages (Adam's
``opt_state/0/{count,mu,nu}`` and ``opt_state/1`` as an empty-dict leaf;
SGD's ``trace``, a schedule's ``count``, the empty states of clipping and
weight decay: ``convert.optax_tree``) — in the flax layout, so the same
blob restores in either package.  Its leaves, in sorted path order, are cut into chunks of at most
``chunk_bytes`` raw bytes, each compressed independently into a DWZ1 frame
(``utils/wire.py``; adaptive: stored when deflate would barely shrink it)
and streamed to disk.  A JSON manifest (leaf paths, dtypes, shapes, each
chunk's offset, lengths and the CRC32 of its frame as stored, and the
lineage record) follows the frames, and a fixed footer locates it and
carries the manifest's own CRC32::

    b"DWCK0001" | frames ... | manifest JSON | <Q offset, I length, I crc32, b"DWC2">

Integrity: a flipped bit anywhere in a blob is detected at restore (a
monolithic blob by its frame's deflate checksums and the strict decoder);
the blob is then quarantined (renamed ``*.bad``, kept as evidence, never
counted again) and the restore falls back to the next-newest checkpoint,
raising only when nothing restorable remains.

Durability and atomicity: the JSON sidecar is written, fsynced and renamed
first, then the blob (tmp + fsync + rename), then the directory is
fsynced, then older checkpoints are pruned to ``keep`` — never the newest
one whose footer verifies.  A crash between the two renames leaves only an
orphan ``.json``, which the next prune sweeps.  Only replica 0 writes.

The training thread pays for :func:`snapshot_state` alone — one copy of
each flat buffer to host memory (``convert.gather_canonical``); the
layout conversion, compression and I/O run on the writer thread
(``train/async_checkpoint.py``).

The chaos harness (``resilience/chaos.py``, inert unless ``DDLPC_CHAOS``
is set) acts where the JAX writer calls it: ``disk_full@K`` raises ENOSPC
before the Kth blob write, ``flip_ckpt@K`` flips a byte of the Kth blob
after its rename.

The JAX package's version-1 chunked blobs, without CRCs, are read but not
written.
"""

from __future__ import annotations

import json
import os
import re
import struct
import tempfile
import time
import warnings
import zlib
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ddlpc_tpu_torch import convert
from ddlpc_tpu_torch.obs import lineage as _lineage
from ddlpc_tpu_torch.resilience.chaos import active as _chaos_active
from ddlpc_tpu_torch.utils import flax_msgpack, wire

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.(?:msgpack\.z|dwc)$")
_META_RE = re.compile(r"^ckpt_(\d+)\.json$")

# Header magic, then the frames, then the manifest, then a footer that
# locates it.  Footer v1 (b"DWCK") carries no CRC; footer v2 (b"DWC2") the
# manifest's CRC32, and v2 manifests a CRC32 per frame.  Readers dispatch
# on the tail.
_DWC_MAGIC = b"DWCK0001"
_DWC_FOOTER = struct.Struct("<QI4s")  # manifest_offset u64, manifest_len u32, b"DWCK"
_DWC2_FOOTER = struct.Struct("<QII4s")  # + manifest_crc32 u32, b"DWC2"
CHUNK_BYTES = 4 << 20
_BLOB_SUFFIXES = (".dwc", ".msgpack.z")

# What a corrupt or truncated blob raises anywhere in the read path.
# OSErrors are left out on purpose: an unreadable disk is the environment's
# fault, which a fallback to an older checkpoint must not hide.
CorruptionError = (
    ValueError,
    KeyError,
    IndexError,
    TypeError,
    struct.error,
    zlib.error,
    EOFError,
    OverflowError,
)


# ---------------------------------------------------------------------------
# the state tree


def flatten_tree(tree: Any, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    """A nested state dict → ``{path: leaf}`` in sorted path order, as the
    JAX package flattens flax's state dict.  An empty dict is a leaf (optax's
    ``EmptyState``); numpy scalars become 0-d arrays; a torch tensor is kept
    (bfloat16 has no numpy dtype) on the CPU."""
    out: Dict[Tuple[str, ...], Any] = {}
    if isinstance(tree, dict):
        if not tree:
            out[prefix] = {}
        for k in sorted(tree):
            out.update(flatten_tree(tree[k], prefix + (str(k),)))
    elif isinstance(tree, np.generic):
        out[prefix] = np.array(tree)
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().cpu()
    else:
        out[prefix] = tree
    return out


def unflatten(flat: dict) -> dict:
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return root


@dataclass
class Snapshot:
    """A train state's canonical copy in host memory: the model's state dict,
    the optimizer's state (``convert.gather_canonical``) and the step."""

    state_dict: Dict[str, torch.Tensor]
    adam: dict
    step: int

    def tree(self) -> dict:
        """The flax ``TrainState`` state dict of this snapshot."""
        return convert.flax_tree(self.state_dict, self.adam, self.step)

    def flat(self) -> dict:
        """:meth:`tree`, flattened for :func:`save_snapshot`."""
        return flatten_tree(self.tree())


def snapshot_state(state, host: Optional[dict] = None, to_host: bool = True) -> Optional[Snapshot]:
    """The training thread's part of a save: the canonical state copied to
    host memory, one copy of each flat buffer (into ``host``'s reusable
    buffers when given, else into new ones).  Under the chunked ZeRO levels
    the moments (and under zero3 the params) are all-gathered first, a
    collective every replica joins; a replica that does not write passes
    ``to_host=False`` and gets None."""
    sd, adam = convert.gather_canonical(state, host=host, to_host=to_host)
    return Snapshot(sd, adam, int(state.step)) if to_host else None


# ---------------------------------------------------------------------------
# chunked writer / reader


def _leaf_array(path: Tuple[str, ...], leaf) -> Tuple[np.ndarray, str]:
    """``(array of the leaf's raw bytes, dtype name)``; bfloat16 travels as
    its uint16 bit pattern under the name ``bfloat16``."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.contiguous().view(torch.int16).numpy().view(np.uint16), "bfloat16"
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    if arr.dtype == object:
        raise TypeError(
            f"checkpoint leaf {'/'.join(path)} has object dtype — not "
            f"serializable as raw bytes"
        )
    return arr, arr.dtype.name


def _dtype(name: str) -> np.dtype:
    """The numpy dtype a leaf is read into (bfloat16 as uint16)."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _leaf_chunks(arr: np.ndarray, chunk_bytes: int) -> List[memoryview]:
    """Zero-copy uint8 views over ``arr``'s raw bytes, ≤ chunk_bytes each."""
    mv = memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    return [mv[i : i + chunk_bytes] for i in range(0, len(mv), chunk_bytes)] or [mv]


def _write_chunked(f, snap: dict, chunk_bytes: int, compression: str,
                   lineage: Optional[dict] = None) -> None:
    """Stream the flat snapshot through the wire codec into open file ``f``."""
    if compression not in ("adaptive", "always", "store"):
        raise ValueError(f"unknown checkpoint compression {compression!r}")
    level = 0 if compression == "store" else wire.LEVEL
    f.write(_DWC_MAGIC)
    offset = len(_DWC_MAGIC)
    leaves = []
    array_entries = []  # (manifest entry, chunk views)
    for path, leaf in snap.items():
        if isinstance(leaf, dict):
            leaves.append({"path": list(path), "kind": "empty_dict"})
            continue
        if leaf is None or isinstance(leaf, (bool, int, float, str)):
            leaves.append({"path": list(path), "kind": "json", "value": leaf})
            continue
        arr, dtype = _leaf_array(path, leaf)
        entry = {
            "path": list(path),
            "kind": "array",
            "dtype": dtype,
            "shape": list(arr.shape),
            "chunks": [],  # [offset, comp_len, raw_len, frame_crc32]
        }
        leaves.append(entry)
        array_entries.append((entry, _leaf_chunks(arr, chunk_bytes)))
    frames = wire.compress_chunks(
        (c for _, chunks in array_entries for c in chunks),
        level=level, adaptive=(compression == "adaptive"),
    )
    for entry, chunks in array_entries:
        for chunk in chunks:
            frame = next(frames)
            f.write(frame)
            # The CRC of the frame as stored: verification runs at read
            # speed with no inflate, and any flip on disk trips it.
            entry["chunks"].append([offset, len(frame), len(chunk), zlib.crc32(frame)])
            offset += len(frame)
    doc: dict = {"version": 3, "leaves": leaves}
    if lineage is not None:
        doc["lineage"] = lineage
    manifest = json.dumps(doc).encode()
    f.write(manifest)
    f.write(_DWC2_FOOTER.pack(offset, len(manifest), zlib.crc32(manifest), b"DWC2"))


def _footer(data: bytes, size: int) -> Tuple[int, int, Optional[int], int]:
    """``(manifest offset, length, crc or None, footer size)`` from a blob's
    tail ``data`` (whose last byte is the blob's byte ``size - 1``)."""
    tail = data[-4:]
    if tail == b"DWC2":
        man_off, man_len, man_crc, _ = _DWC2_FOOTER.unpack_from(data, len(data) - _DWC2_FOOTER.size)
        footer = _DWC2_FOOTER.size
    elif tail == b"DWCK":
        man_off, man_len, _ = _DWC_FOOTER.unpack_from(data, len(data) - _DWC_FOOTER.size)
        man_crc, footer = None, _DWC_FOOTER.size
    else:
        raise ValueError("truncated or corrupt checkpoint footer")
    if man_off + man_len > size - footer:
        raise ValueError("truncated or corrupt checkpoint footer")
    return man_off, man_len, man_crc, footer


def _parse_dwc(data: bytes, path: str) -> Tuple[dict, int]:
    """``(manifest, manifest offset)`` of a whole ``.dwc`` byte string; a
    v2 footer's CRC is checked before a byte of the manifest is trusted."""
    if len(data) < len(_DWC_MAGIC) + _DWC_FOOTER.size or not data.startswith(_DWC_MAGIC):
        raise ValueError(f"{path}: not a DWCK chunked checkpoint")
    try:
        man_off, man_len, man_crc, _ = _footer(data, len(data))
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    man_bytes = data[man_off : man_off + man_len]
    if man_crc is not None and zlib.crc32(man_bytes) != man_crc:
        raise ValueError(f"{path}: corrupt checkpoint manifest (CRC mismatch)")
    return json.loads(man_bytes), man_off


def _entry_chunks(entry: dict) -> Iterator[Tuple[int, int, int, Optional[int]]]:
    """(offset, comp_len, raw_len, crc or None) of each chunk; v1 manifests
    carry no CRC."""
    for row in entry["chunks"]:
        off, comp_len, raw_len = row[:3]
        yield off, comp_len, raw_len, (row[3] if len(row) > 3 else None)


def _checked_frames(data: bytes, path: str, entry: dict, man_off: int) -> Iterator[Tuple[bytes, int]]:
    """``(frame, raw_len)`` of each chunk of an array leaf, once the
    manifest adds up to the leaf's shape and each frame's CRC holds."""
    name = "/".join(entry["path"])
    nbytes = int(np.prod(tuple(entry["shape"]), dtype=np.int64)) * _dtype(entry["dtype"]).itemsize
    raw_total = sum(raw for _, _, raw, _ in _entry_chunks(entry))
    if raw_total != nbytes:
        raise ValueError(
            f"{path}: leaf {name} manifest is inconsistent ({raw_total} chunk "
            f"bytes vs {nbytes} from shape) — corrupt manifest"
        )
    for off, comp_len, raw_len, crc in _entry_chunks(entry):
        if off + comp_len > man_off:
            raise ValueError(f"{path}: chunk overruns manifest")
        frame = data[off : off + comp_len]
        if crc is not None and zlib.crc32(frame) != crc:
            raise ValueError(f"{path}: corrupt chunk at offset {off} (CRC mismatch) in leaf {name}")
        yield frame, raw_len


def _read_chunked(path: str) -> dict:
    """The nested state tree of a ``.dwc`` blob: numpy arrays, and torch
    bfloat16 tensors for bfloat16 leaves."""
    with open(path, "rb") as f:
        data = f.read()
    manifest, man_off = _parse_dwc(data, path)
    flat = {}
    for entry in manifest["leaves"]:
        key = tuple(entry["path"])
        if entry["kind"] == "empty_dict":
            flat[key] = {}
            continue
        if entry["kind"] == "json":
            flat[key] = entry["value"]
            continue
        dtype = _dtype(entry["dtype"])
        shape = tuple(entry["shape"])
        frames = list(_checked_frames(data, path, entry, man_off))
        buf = np.empty(sum(raw for _, raw in frames), np.uint8)
        mv = memoryview(buf)
        pos = 0
        for frame, raw_len in frames:
            n = wire.decompress_into(frame, mv[pos : pos + raw_len])
            if n != raw_len:
                raise ValueError(f"{path}: chunk inflated to {n} bytes, manifest says {raw_len}")
            pos += raw_len
        arr = buf.view(dtype).reshape(shape)
        if entry["dtype"] == "bfloat16":
            arr = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        flat[key] = arr
    return unflatten(flat)


def verify_checkpoint(path: str) -> dict:
    """Integrity-check a blob without restoring it: the footer, the
    manifest's CRC and every frame's CRC, in one read and no inflate (v1
    blobs get the structural checks only; a monolithic blob is inflated).
    Raises a :data:`CorruptionError` on corruption; returns a summary."""
    if path.endswith(".dwc"):
        with open(path, "rb") as f:
            data = f.read()
        manifest, man_off = _parse_dwc(data, path)
        checked = chunks = 0
        for entry in manifest["leaves"]:
            if entry["kind"] != "array":
                continue
            for _ in _checked_frames(data, path, entry, man_off):
                chunks += 1
            checked += sum(crc is not None for *_, crc in _entry_chunks(entry))
        return {
            "format": "chunked",
            "manifest_version": int(manifest.get("version", 1)),
            "chunks": chunks,
            "verified_chunks": checked,
        }
    with open(path, "rb") as f:
        blob = wire.decompress(f.read())
    return {"format": "monolithic", "bytes": len(blob), "verified_chunks": 0}


def _read_manifest_tail(path: str) -> dict:
    """The manifest of a ``.dwc`` blob, reading only the file's tail."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        if f.read(len(_DWC_MAGIC)) != _DWC_MAGIC:
            raise ValueError(f"{path}: not a DWCK chunked checkpoint")
        f.seek(max(0, size - _DWC2_FOOTER.size))
        man_off, man_len, man_crc, _ = _footer(f.read(), size)
        f.seek(man_off)
        man_bytes = f.read(man_len)
    if man_crc is not None and zlib.crc32(man_bytes) != man_crc:
        raise ValueError(f"{path}: corrupt checkpoint manifest (CRC mismatch)")
    return json.loads(man_bytes)


def _footer_ok(path: str) -> bool:
    """Cheap liveness check for prune: footer + manifest (CRC'd on v2)
    parse, reading only the tail of the file."""
    try:
        _read_manifest_tail(path)
        return True
    except (OSError, *CorruptionError):
        return False


def read_manifest_lineage(path: str) -> Optional[dict]:
    """The lineage record in a ``.dwc`` blob's manifest, or None (no
    lineage key, or any read or parse failure: lineage never turns a
    restorable blob into an error)."""
    try:
        lin = _read_manifest_tail(path).get("lineage")
    except (OSError, *CorruptionError):
        return None
    return lin if isinstance(lin, dict) else None


def _step_files_verify(ckpt_dir: str, step: int) -> bool:
    """Do a step's blob and sidecar pass verification?  A restore error on
    files that verify is the caller's, and must not quarantine them."""
    try:
        path, _ = checkpoint_path(ckpt_dir, step)
        verify_checkpoint(path)
        meta_path = os.path.join(ckpt_dir, f"ckpt_{step}.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                json.load(f)
        return True
    except (OSError, *CorruptionError):
        return False


def quarantine_checkpoint(ckpt_dir: str, step: int) -> List[str]:
    """Rename a corrupt step's blob (and sidecar) to ``*.bad``: invisible to
    :func:`latest_step`, never counted toward ``keep``, never retried, kept
    on disk as evidence.  Returns the renamed paths."""
    renamed = []
    for suffix in (*_BLOB_SUFFIXES, ".json"):
        path = os.path.join(ckpt_dir, f"ckpt_{step}{suffix}")
        if os.path.exists(path):
            os.replace(path, path + ".bad")
            renamed.append(path + ".bad")
    return renamed


# ---------------------------------------------------------------------------
# save / restore


def save_checkpoint(
    ckpt_dir: str,
    state,
    step: Optional[int] = None,
    metadata: Optional[dict] = None,
    keep: int = 3,
    format: str = "chunked",
    chunk_bytes: int = CHUNK_BYTES,
    compression: str = "adaptive",
) -> Optional[str]:
    """Write a train state as checkpoint ``step`` (default: its own step)
    synchronously; every replica calls it (the chunked levels gather), replica 0
    writes and gets the path, the others None."""
    from ddlpc_tpu_torch.parallel.mesh import world_rank

    writer = world_rank() == 0
    snap = snapshot_state(state, to_host=writer)
    if not writer:
        return None
    return save_snapshot(
        ckpt_dir, snap.flat(), int(state.step) if step is None else step, metadata=metadata,
        keep=keep, format=format, chunk_bytes=chunk_bytes, compression=compression,
    )


def save_snapshot(
    ckpt_dir: str,
    snap: dict,
    step: int,
    metadata: Optional[dict] = None,
    keep: int = 3,
    format: str = "chunked",
    chunk_bytes: int = CHUNK_BYTES,
    compression: str = "adaptive",
) -> str:
    """Write a flat host snapshot ``{path: leaf}`` (:meth:`Snapshot.flat`,
    :func:`flatten_tree`) as checkpoint ``step``; the body the async
    writer runs.  Sidecar first, then the blob, then the
    directory fsync, then the prune: a crash at any point leaves every
    earlier checkpoint restorable and no partial blob under a final name."""
    if format not in ("chunked", "monolithic"):
        raise ValueError(f"unknown checkpoint format {format!r}")
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"ckpt_{step}.dwc" if format == "chunked" else f"ckpt_{step}.msgpack.z"
    # Every save carries a lineage record, its saved_at stamped at the
    # durable write.
    lin = (metadata or {}).get("lineage")
    if not isinstance(lin, dict):
        lin = _lineage.make_lineage(step)
    lin = dict(lin, step=int(step), saved_at=time.time())
    meta = dict(metadata or {}, step=step, lineage=lin)
    meta_tmp = os.path.join(ckpt_dir, f".meta_{step}.tmp")
    try:
        with open(meta_tmp, "w") as f:
            json.dump(meta, f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.replace(meta_tmp, os.path.join(ckpt_dir, f"ckpt_{step}.json"))
    except BaseException:
        if os.path.exists(meta_tmp):
            os.unlink(meta_tmp)
        raise
    chaos = _chaos_active()
    if chaos is not None:
        # A scheduled disk-full raises here, inside the write path proper,
        # where a real ENOSPC would (the async writer re-raises it on the
        # training thread).
        chaos.on_checkpoint_save()
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            if format == "chunked":
                _write_chunked(f, snap, chunk_bytes, compression, lineage=lin)
            else:
                f.write(wire.compress(flax_msgpack.pack(unflatten(snap))))
            f.flush()
            # fsync before the rename: a rename alone survives a process
            # crash, not a power loss, after which the prune may already
            # have deleted the older checkpoints.
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(ckpt_dir, name))
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    dir_fd = os.open(ckpt_dir, os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)
    _prune(ckpt_dir, keep)
    final = os.path.join(ckpt_dir, name)
    if chaos is not None:
        # Post-rename bit-flip: corrupts the durable blob, the case the CRCs
        # and the restore's fallback must survive.
        chaos.on_checkpoint_written(final)
    return final


def _steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted({int(m.group(1)) for m in map(_CKPT_RE.match, os.listdir(ckpt_dir)) if m})


def _newest_verifiable_step(ckpt_dir: str, live: List[int]) -> Optional[int]:
    """Newest step whose blob passes the footer check — where a restore
    would land if the newer ones are corrupt."""
    for step in reversed(live):
        try:
            path, fmt = checkpoint_path(ckpt_dir, step)
        except FileNotFoundError:
            continue
        if fmt != "chunked" or _footer_ok(path):
            return step
    return None


def _prune(ckpt_dir: str, keep: int) -> None:
    live = _steps(ckpt_dir)
    doomed = live[:-keep] if keep > 0 else []
    if doomed:
        # Never delete the newest verifiable checkpoint: if every blob in
        # the kept window is corrupt, the one a restore falls back to must
        # survive the prune.
        protect = _newest_verifiable_step(ckpt_dir, live)
        doomed = [s for s in doomed if s != protect]
    for step in doomed:
        for suffix in (*_BLOB_SUFFIXES, ".json"):
            path = os.path.join(ckpt_dir, f"ckpt_{step}{suffix}")
            if os.path.exists(path):
                os.unlink(path)
    # Sweep a sidecar orphaned by a crash between the two renames, and the
    # debris of a write killed mid-way (single writer: this save's own
    # renames are done, so any .tmp left is dead).
    alive = set(live) - set(doomed)
    for name in os.listdir(ckpt_dir):
        m = _META_RE.match(name)
        if (m and int(m.group(1)) not in alive) or name.endswith(".tmp"):
            os.unlink(os.path.join(ckpt_dir, name))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def checkpoint_path(ckpt_dir: str, step: int) -> Tuple[str, str]:
    """(path, format) of a step's blob; chunked preferred when both exist."""
    for suffix, fmt in ((".dwc", "chunked"), (".msgpack.z", "monolithic")):
        path = os.path.join(ckpt_dir, f"ckpt_{step}{suffix}")
        if os.path.exists(path):
            return path, fmt
    raise FileNotFoundError(f"no blob for step {step} in {ckpt_dir}")


def peek_metadata(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """A checkpoint's JSON sidecar, without touching the blob."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    meta_path = os.path.join(ckpt_dir, f"ckpt_{step}.json")
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def _read_monolithic(path: str) -> dict:
    """The nested state tree of a ``.msgpack.z`` blob, as
    :func:`_read_chunked` gives it: numpy arrays (0-d for scalars), torch
    bfloat16 tensors, empty dicts and plain values."""
    with open(path, "rb") as f:
        tree = flax_msgpack.unpack(wire.decompress(f.read()))
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: a monolithic checkpoint holds a dict, not {type(tree).__name__}")
    return unflatten(flatten_tree(tree))


def _restore_step(ckpt_dir: str, step: int) -> Tuple[dict, dict]:
    path, fmt = checkpoint_path(ckpt_dir, step)
    tree = _read_chunked(path) if fmt == "chunked" else _read_monolithic(path)
    meta_path = os.path.join(ckpt_dir, f"ckpt_{step}.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    # Every restore's metadata carries a lineage: the sidecar's, else the
    # manifest's (a monolithic blob has none), else the explicit unknown
    # marker.
    if not isinstance(meta.get("lineage"), dict):
        lin = read_manifest_lineage(path) if fmt == "chunked" else None
        meta = dict(meta, lineage=lin or _lineage.unknown_lineage(step))
    return tree, meta


def restore_checkpoint(
    ckpt_dir: str,
    step: Optional[int] = None,
    fallback: bool = True,
) -> Tuple[dict, dict]:
    """``(state tree, metadata)`` of checkpoint ``step`` (the newest when
    None); ``convert.load_state_tree`` places the tree in a train state.

    A corrupt or truncated blob is quarantined with a warning and, unless
    ``step`` was asked for or ``fallback`` is False, the restore moves to
    the next-newest checkpoint; when nothing restorable remains it raises.
    An error on files that verify is the caller's and is raised as is."""
    explicit = step is not None
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    quarantined: List[int] = []
    while True:
        try:
            tree, meta = _restore_step(ckpt_dir, step)
        except CorruptionError as e:
            if _step_files_verify(ckpt_dir, step):
                raise
            bad = quarantine_checkpoint(ckpt_dir, step)
            warnings.warn(
                f"checkpoint step {step} in {ckpt_dir} is corrupt "
                f"({type(e).__name__}: {e}); quarantined "
                f"{[os.path.basename(b) for b in bad]}"
                + ("" if explicit else " — falling back to the next-newest"),
                RuntimeWarning,
                stacklevel=2,
            )
            quarantined.append(step)
            nxt = None if explicit or not fallback else latest_step(ckpt_dir)
            if nxt is None:
                raise ValueError(
                    f"checkpoint step {step} is corrupt and no fallback "
                    f"remains in {ckpt_dir} (quarantined steps: {quarantined}): {e}"
                ) from e
            step = nxt
            continue
        if quarantined:
            meta = dict(meta, quarantined_steps=quarantined)
        return tree, meta
