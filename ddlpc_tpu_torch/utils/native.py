"""The port's host C++ libraries, built with ``g++`` at first use and loaded
with ``ctypes`` — the port's copy of ``ddlpc_tpu/utils/native.py``.

- ``libdwz`` (``kernels/host/wire.cc``): the DWZ1 block-parallel deflate
  codec; :class:`NativeWire` has the ``compress``/``decompress`` that
  ``utils/wire.py`` calls.
- ``libdwbatch`` (``kernels/host/batch.cc``): the fused gather–pack of a
  super-batch; :class:`NativeBatch` is what ``data/loader.ShardedLoader``
  calls to fill its pinned ring slots.

Each library is compiled by ``g++ -O3 -std=c++17 -fPIC -shared`` into
``kernels/build/`` (listed in ``.gitignore``) under a name keyed by a hash
of its source and flags, as ``kernels/build.py`` does for ``nvcc``: an
edited source rebuilds, an unchanged one loads at once.  There is no
fallback: a build or load that fails raises :class:`NativeBuildError`,
which names ``--set data.native_gather=False``, the setting that keeps a
run on numpy's gather and Python's zlib.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_SRC = os.path.join(_HERE, "kernels", "host")
BUILD_DIR = os.path.join(_HERE, "kernels", "build")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
LIBRARIES = {  # name: (source, link flags), as csrc/Makefile links them
    "libdwz": ("wire.cc", ("-lz", "-lpthread")),
    "libdwbatch": ("batch.cc", ("-lpthread",)),
}
MAX_THREADS = min(12, os.cpu_count() or 1)

_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    """A host library did not build or load."""


def library_path(name: str) -> str:
    source, link = LIBRARIES[name]
    h = hashlib.sha256(" ".join(CXX_FLAGS + link).encode())
    with open(os.path.join(HOST_SRC, source), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile library ``name`` unless its keyed file exists; returns the
    path.  Raises :class:`NativeBuildError` with the compiler's output."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    source, link = LIBRARIES[name]
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out[:-3]}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *CXX_FLAGS, os.path.join(HOST_SRC, source), "-o", tmp, *link]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(_failed(name, f"{' '.join(cmd)}: {e}")) from e
    if r.returncode != 0:
        raise NativeBuildError(_failed(name, f"{' '.join(cmd)}\n{r.stdout}{r.stderr}"))
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def _failed(name: str, detail: str) -> str:
    return (
        f"the port's host library {name} did not build ({detail}); a run "
        f"with --set data.native_gather=False takes numpy's gather and "
        f"Python's zlib instead"
    )


def _load(name: str) -> ctypes.CDLL:
    with _lock:
        path = build(name)
        try:
            return ctypes.CDLL(path)
        except OSError as e:
            raise NativeBuildError(_failed(name, f"loading {path}: {e}")) from e


class NativeWire:
    """``dwz_compress``/``dwz_decompress``: DWZ1 frames, block-parallel."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        out_ptr = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
        lib.dwz_compress.restype = ctypes.c_int
        lib.dwz_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_size_t,
            ctypes.c_int, out_ptr, ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.dwz_decompress.restype = ctypes.c_int
        lib.dwz_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, out_ptr,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.dwz_free.restype = None
        lib.dwz_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]

    def _take(self, out, out_len) -> bytes:
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            self._lib.dwz_free(out)

    def compress(self, data: bytes, level: int, block_size: int) -> bytes:
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_size_t()
        rc = self._lib.dwz_compress(
            bytes(data), len(data), level, block_size, MAX_THREADS,
            ctypes.byref(out), ctypes.byref(out_len),
        )
        if rc != 0:
            raise RuntimeError(f"dwz_compress failed with code {rc}")
        return self._take(out, out_len)

    def decompress(self, data: bytes) -> bytes:
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_size_t()
        rc = self._lib.dwz_decompress(
            bytes(data), len(data), MAX_THREADS, ctypes.byref(out), ctypes.byref(out_len)
        )
        if rc == -5:
            raise ValueError("bad wire magic; not a DWZ1 frame")
        if rc == -6:
            raise ValueError("truncated frame")
        if rc == -7:
            raise ValueError("trailing garbage in frame")
        if rc != 0:
            raise ValueError(f"corrupt frame (dwz_decompress code {rc})")
        return self._take(out, out_len)


def check_label_range(lo, hi) -> None:
    """The compact-cast label contract: int8 labels with the -1 void
    sentinel (the kernel's rc -3)."""
    if lo < -1 or hi > 127:
        raise ValueError(
            f"compact=True needs labels in [-1, 127] for int8, got range [{lo}, {hi}]"
        )


class NativeBatch:
    """``dwb_gather_pack``: gather (and, with ``compact``, cast) tiles into
    caller-owned buffers in one multithreaded memory pass; ctypes releases
    the GIL for the call."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.dwb_gather_pack.restype = ctypes.c_int
        lib.dwb_gather_pack.argtypes = [
            ctypes.c_void_p,  # images fp32 [n_src, img_elems]
            ctypes.c_void_p,  # labels int32 [n_src, lab_elems]
            ctypes.c_void_p,  # indices int64 [n_out]
            ctypes.c_size_t,  # n_out
            ctypes.c_size_t,  # n_src
            ctypes.c_size_t,  # img_elems
            ctypes.c_size_t,  # lab_elems
            ctypes.c_int,     # compact
            ctypes.c_void_p,  # img_out
            ctypes.c_void_p,  # lab_out
            ctypes.POINTER(ctypes.c_int32),  # lab_range[2]
            ctypes.c_int,     # max_threads
        ]

    def gather_pack(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        indices: np.ndarray,
        img_out: np.ndarray,
        lab_out: np.ndarray,
        compact: bool = False,
    ) -> None:
        """``images[indices]``/``labels[indices]`` into the preallocated
        outputs (bf16/int8 when ``compact``).  Every check that guards a raw
        pointer in C raises here first."""
        n_out = len(indices)
        n_src = images.shape[0]
        img_elems = int(np.prod(images.shape[1:], dtype=np.int64))
        lab_elems = int(np.prod(labels.shape[1:], dtype=np.int64))
        if not (images.dtype == np.float32 and labels.dtype == np.int32
                and images.flags.c_contiguous and labels.flags.c_contiguous
                and len(labels) == n_src):
            raise ValueError("sources must be C-contiguous float32 images and int32 labels")
        if not (indices.dtype == np.int64 and indices.flags.c_contiguous):
            raise ValueError("indices must be a C-contiguous int64 array")
        if not (img_out.flags.c_contiguous and lab_out.flags.c_contiguous):
            raise ValueError("destinations must be C-contiguous")
        img_item, lab_item = (2, 1) if compact else (4, 4)
        if (img_out.nbytes != n_out * img_elems * img_item
                or lab_out.nbytes != n_out * lab_elems * lab_item):
            raise ValueError(
                f"destination sizes ({img_out.nbytes}, {lab_out.nbytes} bytes) do not "
                f"match {n_out} tiles of ({img_elems}, {lab_elems}) elements"
            )
        lab_range = (ctypes.c_int32 * 2)()
        rc = self._lib.dwb_gather_pack(
            images.ctypes.data, labels.ctypes.data, indices.ctypes.data,
            n_out, n_src, img_elems, lab_elems, int(compact),
            img_out.ctypes.data, lab_out.ctypes.data, lab_range, MAX_THREADS,
        )
        if rc == -3:
            check_label_range(lab_range[0], lab_range[1])
        if rc == -2:
            raise IndexError(f"gather index out of range for dataset of {n_src} tiles")
        if rc != 0:
            raise RuntimeError(f"dwb_gather_pack failed with code {rc}")


@functools.lru_cache(maxsize=None)
def load_wire() -> NativeWire:
    """The wire codec, built on first use; raises :class:`NativeBuildError`."""
    return NativeWire(_load("libdwz"))


@functools.lru_cache(maxsize=None)
def load_batch() -> NativeBatch:
    """The batch gather, built on first use; raises :class:`NativeBuildError`."""
    return NativeBatch(_load("libdwbatch"))
