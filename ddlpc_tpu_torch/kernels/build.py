"""Build and load the port's CUDA kernels.

Each source under ``kernels/csrc/`` is compiled at first use by its own
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -c``, all of them started
together, and the objects are linked into one shared library with a plain
C interface, loaded with ``ctypes``.  The library lands in
``kernels/build/`` (listed in ``.gitignore``) under a name keyed by a hash
of the sources, the headers and the flags, so an edited source rebuilds
and an unchanged one loads at once.  There is no fallback: a missing
``nvcc`` or a failed build raises.

Run ``python -m ddlpc_tpu_torch.kernels.build`` to build ahead of time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
SOURCES = ("quantize.cu", "stochastic.cu", "absmax.cu")
HEADERS = ("codec.cuh",)
# Never --use_fast_math: the codec's bit-identity needs IEEE division.
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-c")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

_P = ctypes.c_void_p
_SIGNATURES = {
    # (x, q, n, scale, levels, stream)
    "ddlpc_encode_i8": (_P, _P, ctypes.c_int64, _P, ctypes.c_float, _P),
    "ddlpc_encode_i16": (_P, _P, ctypes.c_int64, _P, ctypes.c_float, _P),
    "ddlpc_encode_f16": (_P, _P, ctypes.c_int64, _P, ctypes.c_float, _P),
    # (q, out, n, inv, stream)
    "ddlpc_decode_i8": (_P, _P, ctypes.c_int64, _P, _P),
    "ddlpc_decode_i16": (_P, _P, ctypes.c_int64, _P, _P),
    "ddlpc_decode_f16": (_P, _P, ctypes.c_int64, _P, _P),
    # (x, out, n, amax, levels, half_wire, stream)
    "ddlpc_fake_quantize": (_P, _P, ctypes.c_int64, _P, ctypes.c_float, ctypes.c_int, _P),
    # (x, n, out, scratch, scratch_words, stream)
    "ddlpc_absmax": (_P, ctypes.c_int64, _P, _P, ctypes.c_int64, _P),
    # (x, q, n, scale, levels, key0, key1, offset, stream)
    **{
        f"ddlpc_encode_sr_{w}": (
            _P, _P, ctypes.c_int64, _P, ctypes.c_float,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int64, _P,
        )
        for w in ("i8", "i16", "f16")
    },
    # (x, out, n, amax, levels, half_wire, key0, key1, offset, stream)
    "ddlpc_fake_quantize_sr": (
        _P, _P, ctypes.c_int64, _P, ctypes.c_float, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int64, _P,
    ),
    # (x, u, q, n, scale, levels, stream)
    **{
        f"ddlpc_encode_noise_{w}": (_P, _P, _P, ctypes.c_int64, _P, ctypes.c_float, _P)
        for w in ("i8", "i16", "f16")
    },
    # (x, u, out, n, amax, levels, half_wire, stream)
    "ddlpc_fake_quantize_noise": (
        _P, _P, _P, ctypes.c_int64, _P, ctypes.c_float, ctypes.c_int, _P,
    ),
}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the
    toolkit's standard location; raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on the PATH): the port's "
        "CUDA kernels are built from source at first use"
    )


def source_key() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libddlpc_kernels_{source_key()}.so")


def _run(cmds: list) -> list:
    """Start every command at once; wait for all; raise on the first that
    failed, with its output."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(c)}\n{out}")
    return outs


def build(verbose: bool = False) -> str:
    """Compile the sources if the keyed library is missing; returns its
    path.  Raises ``RuntimeError`` with the compiler's output on failure."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{out[:-3]}.{os.getpid()}"
    objs = [f"{tag}.{os.path.splitext(name)[0]}.o" for name in SOURCES]
    extra = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    logs = _run([
        [nvcc, *COMPILE_FLAGS, *extra, "-o", obj, os.path.join(CSRC, name)]
        for name, obj in zip(SOURCES, objs)
    ])
    tmp = f"{tag}.tmp"
    logs += _run([[nvcc, *LINK_FLAGS, "-o", tmp, *objs]])
    for obj in objs:
        os.remove(obj)
    if verbose:
        print("".join(logs), file=sys.stderr)
        print(f"built {out} in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every entry
    point's argument types (ctypes would otherwise pass pointers as 32-bit
    ints and cut them)."""
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


if __name__ == "__main__":
    print(build(verbose="-v" in sys.argv[1:]))
