"""The msgpack subset that flax's ``msgpack_serialize`` writes, encoded and
decoded in plain Python — the port's own codec for the JAX package's
monolithic checkpoints (``ckpt_<step>.msgpack.z``), so that the port
needs neither ``msgpack`` nor flax.

:func:`pack` gives, for the same tree, the bytes of
``flax.serialization.msgpack_serialize``: that is, of
``msgpack.packb(tree, default=_msgpack_ext_pack, strict_types=True)``
after flax has rebuilt every dict with its keys sorted and split each array
larger than :data:`MAX_CHUNK_SIZE` bytes into a chunked dict.  The subset:

- nil, bool, ints in the smallest form msgpack's packer picks, float64,
  str and bin (``use_bin_type=True``);
- map and array, in their fix, 16 and 32 forms (a list is an array; a
  tuple, as under ``strict_types``, is refused);
- ext 1, an array: the msgpack of ``(shape, dtype name, raw C-order
  bytes)``; ext 3, a numpy scalar, the same of its 0-d array; ext 2, a
  complex number, the msgpack of ``(real, imag)``;
- ``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
  "chunks": {"0": flat slice, ...}}`` for an array above
  :data:`MAX_CHUNK_SIZE` bytes that is a dict's value (or the whole tree),
  which :func:`unpack` joins back.

Arrays are numpy arrays or torch tensors; ``bfloat16``, which numpy lacks,
is a torch tensor on both sides (packed as its bit pattern under the name
``bfloat16``, as flax packs ``jnp.bfloat16``).

:func:`unpack` is strict where msgpack is lenient: truncated input,
trailing bytes, a length the data does not hold, an array whose bytes do
not fill its shape, a non-string map key or an ext code outside 1–3 raise
``ValueError`` (a member of ``train/checkpoint.py``'s ``CorruptionError``),
and no array is ever returned short.  Both directions copy each array's
bytes once.
"""

from __future__ import annotations

import struct
import sys
from typing import Any, List, Tuple

import numpy as np

MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------------
# arrays


def _torch_tensor(x) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def _is_array(x) -> bool:
    return isinstance(x, np.ndarray) or _torch_tensor(x)


def _array_parts(x) -> Tuple[Tuple[int, ...], str, memoryview]:
    """``(shape, dtype name, raw C-order bytes)`` of an array leaf, the bytes
    a zero-copy view where the array is contiguous."""
    if _torch_tensor(x):
        import torch

        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            arr, name = t.view(torch.int16).numpy(), "bfloat16"
        else:
            arr = t.numpy()
            name = arr.dtype.name
    else:
        if x.dtype.hasobject or x.dtype.isalignedstruct:
            raise ValueError(
                "Object and structured dtypes not supported for serialization of ndarrays."
            )
        arr, name = np.ascontiguousarray(x), x.dtype.name
    return tuple(int(d) for d in x.shape), name, memoryview(arr.reshape(-1).view(np.uint8))


def _nbytes(x) -> int:
    if _torch_tensor(x):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _itemsize(x) -> int:
    return x.element_size() if _torch_tensor(x) else x.dtype.itemsize


def _chunk(x) -> dict:
    """flax's ``_chunk``: the flat array cut into slices of at most
    :data:`MAX_CHUNK_SIZE` bytes, keyed ``"0"``, ``"1"``, ...."""
    size = max(1, int(MAX_CHUNK_SIZE / _itemsize(x)))
    flat = x.reshape(-1)
    n = flat.shape[0]
    return {
        _CHUNKED: True,
        "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
        "chunks": {str(j): flat[i : i + size] for j, i in enumerate(range(0, n, size))},
    }


def _big(x) -> bool:
    return _is_array(x) and _nbytes(x) > MAX_CHUNK_SIZE


def _prepare(tree):
    """What flax packs: every dict rebuilt with its keys sorted (its
    ``jax.tree_util`` identity map), then each oversized array that is a
    dict's value (or the root) chunked."""

    def rebuild(node):
        if type(node) is dict:
            return {k: rebuild(node[k]) for k in sorted(node)}
        if type(node) in (list, tuple):
            return type(node)(rebuild(v) for v in node)
        return node

    def chunk(node):
        if type(node) is dict:
            return {k: _chunk(v) if _big(v) else chunk(v) for k, v in node.items()}
        return node

    tree = rebuild(tree)
    return _chunk(tree) if _big(tree) else chunk(tree)


# ---------------------------------------------------------------------------
# pack


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return struct.pack("B", v)
    if -0x20 <= v < 0:
        return struct.pack("b", v)
    if 0x80 <= v <= 0xFF:
        return struct.pack("BB", 0xCC, v)
    if -0x80 <= v < 0:
        return struct.pack(">Bb", 0xD0, v)
    if 0xFF < v <= 0xFFFF:
        return struct.pack(">BH", 0xCD, v)
    if -0x8000 <= v < -0x80:
        return struct.pack(">Bh", 0xD1, v)
    if 0xFFFF < v <= 0xFFFFFFFF:
        return struct.pack(">BI", 0xCE, v)
    if -0x80000000 <= v < -0x8000:
        return struct.pack(">Bi", 0xD2, v)
    if 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        return struct.pack(">BQ", 0xCF, v)
    if -0x8000000000000000 <= v < -0x80000000:
        return struct.pack(">Bq", 0xD3, v)
    raise OverflowError("Integer value out of range")


def _header(n: int, fix: int, fix_max: int, f8, f16: int, f32: int, what: str) -> bytes:
    """A length header: the fix form up to ``fix_max``, then the 8-bit form
    (where ``f8`` is not None), the 16-bit and the 32-bit."""
    if n <= fix_max:
        return struct.pack("B", fix + n)
    if f8 is not None and n <= 0xFF:
        return struct.pack(">BB", f8, n)
    if n <= 0xFFFF:
        return struct.pack(">BH", f16, n)
    if n <= 0xFFFFFFFF:
        return struct.pack(">BI", f32, n)
    raise ValueError(f"{what} is too large")


def _str_header(n: int) -> bytes:
    return _header(n, 0xA0, 0x1F, 0xD9, 0xDA, 0xDB, "String")


def _bin_header(n: int) -> bytes:
    return _header(n, 0, -1, 0xC4, 0xC5, 0xC6, "Bin")  # bin has no fix form


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = struct.pack("B", fixed[n])
    elif n <= 0xFF:
        head = struct.pack(">BB", 0xC7, n)
    elif n <= 0xFFFF:
        head = struct.pack(">BH", 0xC8, n)
    else:
        head = struct.pack(">BI", 0xC9, n)
    return head + struct.pack("b", code)


def _plain(obj, out: List) -> None:
    """msgpack's packer without ``strict_types`` or a default, for the ext
    payloads flax packs itself (a shape tuple, a name, bytes, floats)."""
    if type(obj) is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out += [_str_header(len(raw)), raw]
    elif isinstance(obj, (tuple, list)):
        out.append(_header(len(obj), 0x90, 0x0F, None, 0xDC, 0xDD, "Array"))
        for v in obj:
            _plain(v, out)
    else:
        raise TypeError(f"Cannot serialize {obj!r}")


def _array_ext(code: int, x, out: List) -> None:
    shape, name, raw = _array_parts(x)
    head: List = [b"\x93"]  # the tuple (shape, dtype name, bytes)
    _plain(shape, head)
    _plain(name, head)
    head.append(_bin_header(raw.nbytes))
    prefix = b"".join(head)
    out += [_ext_header(code, len(prefix) + raw.nbytes), prefix, raw]


def _pack(obj, out: List) -> None:
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        out.append(_int(obj))
    elif t in (bytes, bytearray):
        out += [_bin_header(len(obj)), bytes(obj)]
    elif t is str:
        raw = obj.encode("utf-8")
        out += [_str_header(len(raw)), raw]
    elif t is memoryview:
        out += [_bin_header(obj.nbytes), obj]
    elif t is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif t is list:
        out.append(_header(len(obj), 0x90, 0x0F, None, 0xDC, 0xDD, "Array"))
        for v in obj:
            _pack(v, out)
    elif t is dict:
        out.append(_header(len(obj), 0x80, 0x0F, None, 0xDE, 0xDF, "Dict"))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif _is_array(obj):
        _array_ext(EXT_NDARRAY, obj, out)
    elif isinstance(obj, np.generic):
        _array_ext(EXT_NPSCALAR, np.asarray(obj), out)
    elif isinstance(obj, complex):
        payload: List = []
        _plain((obj.real, obj.imag), payload)
        data = b"".join(payload)
        out += [_ext_header(EXT_COMPLEX, len(data)), data]
    else:
        raise TypeError(f"Cannot serialize {obj!r}")


def pack(tree: Any) -> bytes:
    """``tree`` (dicts with string keys, lists, None, bools, ints, floats,
    strs, bytes, arrays, numpy scalars, complex numbers) as the bytes flax's
    ``msgpack_serialize`` writes for it."""
    out: List = []
    _pack(_prepare(tree), out)
    return b"".join(out)


# ---------------------------------------------------------------------------
# unpack


class _Reader:
    def __init__(self, data):
        self.mv = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if n < 0 or end > len(self.mv):
            raise ValueError(
                f"truncated msgpack data: {n} bytes wanted at offset {self.pos} "
                f"of {len(self.mv)}"
            )
        view = self.mv[self.pos : end]
        self.pos = end
        return view

    def unpack(self, fmt: str):
        s = struct.Struct(fmt)
        return s.unpack(self.take(s.size))

    def length(self, width: int) -> int:
        return self.unpack({1: ">B", 2: ">H", 4: ">I"}[width])[0]


_SIZED = {  # type byte: (kind, bytes of its length or value)
    0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
    0xC7: ("ext", 1), 0xC8: ("ext", 2), 0xC9: ("ext", 4),
    0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
    0xDC: ("array", 2), 0xDD: ("array", 4), 0xDE: ("map", 2), 0xDF: ("map", 4),
}
_NUMBERS = {
    0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _read(r: _Reader):
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_read(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return str(r.take(b & 0x1F), "utf-8")
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _NUMBERS:
        return r.unpack(_NUMBERS[b])[0]
    if b in _FIXEXT:
        code = r.unpack(">b")[0]
        return _ext(code, r.take(_FIXEXT[b]))
    if b in _SIZED:
        kind, width = _SIZED[b]
        n = r.length(width)
        if kind == "bin":
            return bytes(r.take(n))
        if kind == "str":
            return str(r.take(n), "utf-8")
        if kind == "ext":
            code = r.unpack(">b")[0]
            return _ext(code, r.take(n))
        if kind == "array":
            return [_read(r) for _ in range(n)]
        return _read_map(r, n)
    raise ValueError(f"invalid msgpack type byte 0x{b:02x} at offset {r.pos - 1}")


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r)
        if type(k) not in (str, bytes):
            raise ValueError(f"msgpack map key {k!r} is not a string")
        out[k] = _read(r)
    return out


def _array(data: memoryview):
    """An ext 1/3 payload as a fresh array (bfloat16 as a torch tensor)."""
    r = _Reader(data)
    if r.take(1)[0] != 0x93:
        raise ValueError("an array ext must hold (shape, dtype, bytes)")
    shape, name = _read(r), _read(r)
    b = r.take(1)[0]
    if b not in (0xC4, 0xC5, 0xC6):
        raise ValueError("an array ext's bytes must be bin")
    raw = r.take(r.length(_SIZED[b][1]))
    if r.pos != len(r.mv):
        raise ValueError(f"{len(r.mv) - r.pos} trailing bytes in an array ext")
    if type(shape) is not list or any(type(d) is not int or d < 0 for d in shape):
        raise ValueError(f"bad array shape {shape!r}")
    if type(name) is bytes:
        name = name.decode("ascii")
    if type(name) is not str:
        raise ValueError(f"bad array dtype {name!r}")
    dtype = np.dtype(np.uint16 if name == "bfloat16" else name)
    if dtype.hasobject:
        raise ValueError(f"object dtype {name!r} in an array ext")
    n = 1
    for d in shape:
        n *= d
    if raw.nbytes != n * dtype.itemsize:
        raise ValueError(
            f"array of shape {tuple(shape)} {name} needs {n * dtype.itemsize} bytes, "
            f"the ext holds {raw.nbytes}"
        )
    arr = np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
    if name == "bfloat16":
        import torch

        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return arr


def _ext(code: int, data: memoryview):
    if code == EXT_NDARRAY:
        return _array(data)
    if code == EXT_NPSCALAR:
        arr = _array(data)
        return arr if _torch_tensor(arr) else arr[()]
    if code == EXT_COMPLEX:
        r = _Reader(data)
        pair = _read(r)
        if r.pos != len(r.mv) or type(pair) is not list or len(pair) != 2:
            raise ValueError("a complex ext must hold (real, imag)")
        return complex(pair[0], pair[1])
    raise ValueError(f"unknown msgpack ext code {code}")


def _unchunk(d: dict):
    shape = d.get("shape")
    chunks = d.get("chunks")
    if type(shape) is not dict or type(chunks) is not dict:
        raise ValueError("a chunked array needs a shape and chunks")
    dims = tuple(shape[str(i)] for i in range(len(shape)))
    parts = [chunks[str(i)] for i in range(len(chunks))]
    if not parts or not all(_is_array(p) and p.ndim == 1 for p in parts):
        raise ValueError("a chunked array's chunks must be flat arrays")
    if _torch_tensor(parts[0]):
        import torch

        flat = torch.cat(parts)
    else:
        flat = np.concatenate(parts)
    n = 1
    for d_ in dims:
        n *= d_
    if flat.shape[0] != n:
        raise ValueError(f"chunked array of shape {dims} holds {flat.shape[0]} elements")
    return flat.reshape(dims)


def _unchunk_tree(d):
    """flax's ``_unchunk_array_leaves_in_place``: dicts only, lists are
    not entered."""
    if type(d) is dict:
        if _CHUNKED in d:
            return _unchunk(d)
        return {k: _unchunk_tree(v) for k, v in d.items()}
    return d


def unpack(data) -> Any:
    """The tree flax's ``msgpack_restore`` gives for ``data`` (arrays fresh
    and writable, a numpy scalar for ext 3), or ``ValueError``."""
    r = _Reader(data)
    tree = _read(r)
    if r.pos != len(r.mv):
        raise ValueError(f"{len(r.mv) - r.pos} trailing bytes after the msgpack object")
    return _unchunk_tree(tree)
