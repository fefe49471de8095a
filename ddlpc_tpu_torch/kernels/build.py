"""Build and load the port's CUDA kernels.

The sources under ``kernels/csrc/`` are compiled at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into one shared
library with a plain C interface, loaded with ``ctypes``.  The library
lands in ``kernels/build/`` (listed in ``.gitignore``) under a name keyed
by a hash of the sources and the flags, so an edited source rebuilds and an
unchanged one loads at once.  There is no fallback: a missing ``nvcc`` or a
failed build raises.

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
SOURCES = ("quantize.cu",)
# Never --use_fast_math: the codec's bit-identity needs IEEE division.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

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
    # (x, out, n, scale, step, levels, half_wire, stream)
    "ddlpc_fake_quantize": (
        _P, _P, ctypes.c_int64, _P, _P, ctypes.c_float, ctypes.c_int, _P,
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libddlpc_kernels_{source_key()}.so")


def build(verbose: bool = False) -> str:
    """Compile the sources if the keyed library is missing; returns its
    path.  Raises ``RuntimeError`` with the compiler's output on failure."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += [os.path.join(CSRC, s) for s in SOURCES]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n{r.stdout}{r.stderr}"
        )
    if verbose:
        print(r.stdout + r.stderr, file=sys.stderr)
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
