"""The port's host C++ libraries (``ddlpc_tpu_torch/kernels/host/``, built
by ``utils/native.py``) against the JAX package's (``csrc/``, built by
``ddlpc_tpu/utils/native.py``), on the CPU.  Exact throughout:

- ``dwb_gather_pack`` writes the same bytes as JAX's ``NativeBatch`` and as
  numpy's gather (bf16 under ``compact`` as ``ml_dtypes``' cast), and
  raises the same errors;
- the native DWZ1 frames are JAX's native frames byte for byte, and each
  side reads the other's and Python's.  At deflate level 1 they are also
  the Python path's bytes.  At level 0 (stored blocks, the checkpoint's
  choice for dense fp32) zlib cuts the stored blocks where the caller's
  output buffer ends: ``compress2`` offers the whole bound at once, while
  Python's ``zlib.compress`` grows its buffer in steps, so the frames
  differ in their block framing and inflate to the same bytes;
- a checkpoint blob written through the native wire is the JAX native
  blob, and, where every chunk is deflated, the Python path's blob;
- a library that does not build raises, naming the setting that avoids it.
"""

import ctypes
import os
import shutil
import subprocess
import time

import ml_dtypes
import numpy as np
import pytest

from ddlpc_tpu.train import checkpoint as jckpt
from ddlpc_tpu.utils import native as jnative
from ddlpc_tpu.utils import wire as jwire
from ddlpc_tpu_torch.convert import load_state_tree
from ddlpc_tpu_torch.train import checkpoint as tckpt
from ddlpc_tpu_torch.utils import native
from ddlpc_tpu_torch.utils import wire as twire
from test_torch_checkpoint import jax_state, metadata, port_state
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

SIZES = (0, 1, 1 << 10, (1 << 16) + 3, (1 << 20) + 17, 3 << 20)


# ``csrc/Makefile``'s flags.  The JAX package's own loader runs ``make`` in
# place in ``csrc/`` and caches a failure for the life of the process, so
# pytest workers that reach it together race one another's half-written
# ``.so``; each worker here builds its own copy instead.
_CXX = ["g++", "-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]
_JAX_LIBS = (("wire.cc", "libdwz.so", jnative.NativeWire, ["-lz", "-lpthread"]),
             ("batch.cc", "libdwbatch.so", jnative.NativeBatch, ["-lpthread"]))


@pytest.fixture(scope="module")
def jax_libs(tmp_path_factory):
    """The JAX package's ``NativeWire`` and ``NativeBatch`` over libraries
    built from ``csrc/`` into this worker's own directory (a temporary name,
    then ``os.replace``), never through ``ddlpc_tpu.utils.native.load``."""
    out = tmp_path_factory.mktemp("jax_native")
    csrc = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
    libs = []
    for source, name, wrapper, ldlibs in _JAX_LIBS:
        path, tmp = str(out / name), str(out / f".{name}.{os.getpid()}.tmp")
        build = subprocess.run(_CXX + [os.path.join(csrc, source), "-o", tmp] + ldlibs,
                               capture_output=True, text=True, timeout=300)
        if build.returncode:
            pytest.fail(f"csrc/{source} did not build with this g++:\n{build.stderr}")
        os.replace(tmp, path)
        libs.append(wrapper(ctypes.CDLL(path)))
    return tuple(libs)


def _batch_inputs():
    rng = np.random.default_rng(0)
    imgs = (rng.standard_normal((20, 7, 5, 3))
            * 10.0 ** rng.integers(-30, 30, (20, 7, 5, 3))).astype(np.float32)
    imgs.reshape(-1)[:8] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-40, 3.14159]
    labs = rng.integers(-1, 128, (20, 7, 5)).astype(np.int32)
    idx = rng.integers(0, 20, 13).astype(np.int64)  # repeats, as a wrap-fill has
    return imgs, labs, idx


@pytest.mark.parametrize("compact", [False, True])
def test_gather_pack_equals_jax_and_numpy(jax_libs, compact):
    imgs, labs, idx = _batch_inputs()
    img_dt, lab_dt = (ml_dtypes.bfloat16, np.int8) if compact else (np.float32, np.int32)
    outs = []
    for lib in (native.load_batch(), jax_libs[1]):
        io = np.empty((13, 7, 5, 3), img_dt)
        lo = np.empty((13, 7, 5), lab_dt)
        lib.gather_pack(imgs, labs, idx, io, lo, compact)
        outs.append((io.tobytes(), lo.tobytes()))
    assert outs[0] == outs[1]
    assert outs[0] == (imgs[idx].astype(img_dt).tobytes(), labs[idx].astype(lab_dt).tobytes())


def test_gather_pack_errors_match_jax(jax_libs):
    imgs = np.zeros((4, 2, 2, 3), np.float32)
    labs = np.zeros((4, 2, 2), np.int32)
    wide = labs.copy()
    wide[0] = 200
    for lib in (native.load_batch(), jax_libs[1]):
        io, lo = np.empty((1, 2, 2, 3), np.float32), np.empty((1, 2, 2), np.int32)
        with pytest.raises(IndexError, match="out of range for dataset of 4 tiles"):
            lib.gather_pack(imgs, labs, np.array([9], np.int64), io, lo, False)
        with pytest.raises(IndexError, match="out of range"):
            lib.gather_pack(imgs, labs, np.array([-1], np.int64), io, lo, False)
        ib, lb = np.empty((1, 2, 2, 3), ml_dtypes.bfloat16), np.empty((1, 2, 2), np.int8)
        with pytest.raises(ValueError, match=r"\[-1, 127\].*\[200, 200\]"):
            lib.gather_pack(imgs, wide, np.array([0], np.int64), ib, lb, True)
        with pytest.raises(ValueError, match="int64"):
            lib.gather_pack(imgs, labs, np.array([0], np.int32), io, lo, False)
        with pytest.raises(ValueError, match="do not match"):
            lib.gather_pack(imgs, labs, np.array([0, 1], np.int64), io, lo, False)


def _payload(n: int, kind: str) -> bytes:
    rng = np.random.default_rng(n)
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    return bytes(n) if kind == "zeros" else rng.integers(0, 4, n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("kind", ["random", "zeros", "small_alphabet"])
@pytest.mark.parametrize("n", SIZES)
def test_native_frames_equal_jax_native_and_read_each_way(jax_libs, monkeypatch, n, kind):
    monkeypatch.setattr(jwire, "_native", False)
    monkeypatch.setattr(twire, "_native", False)
    raw = _payload(n, kind)
    ours = native.load_wire()
    for level in (0, 1):
        frame = ours.compress(raw, level, twire.BLOCK_SIZE)
        assert frame == jax_libs[0].compress(raw, level, jwire.BLOCK_SIZE)
        python = twire.compress(raw, level)
        assert python == jwire.compress(raw, level)
        if level == 1 or n <= 1 << 10:
            assert frame == python
        for decode in (ours.decompress, jax_libs[0].decompress, twire.decompress, jwire.decompress):
            assert decode(frame) == raw and decode(python) == raw


def test_wire_takes_the_native_library_unless_switched_off(monkeypatch):
    raw = _payload(3 << 20, "random")
    monkeypatch.setattr(twire, "_native", None)
    assert twire.compress(raw, 0) == native.load_wire().compress(raw, 0, twire.BLOCK_SIZE)
    twire.set_native(False)
    python = twire.compress(raw, 0)
    assert python != native.load_wire().compress(raw, 0, twire.BLOCK_SIZE)  # block framing
    twire.set_native(True)
    assert twire.decompress(python) == raw
    buf = np.zeros(len(raw), np.uint8)
    assert twire.decompress_into(python, memoryview(buf)) == len(raw) and buf.tobytes() == raw
    with pytest.raises(ValueError, match="buffer holds"):
        twire.decompress_into(python, memoryview(buf)[:10])


@pytest.mark.parametrize(
    "frame,match",
    [(b"DW", "truncated"), (b"XXXX\0\0\0\0", "bad wire magic"),
     (b"DWZ1\x05\0\0\0", "truncated"), (jwire.compress(b"abc") + b"!", "trailing garbage")],
)
def test_native_decoder_refuses_malformed_frames(frame, match):
    with pytest.raises(ValueError, match=match):
        native.load_wire().decompress(frame)


@pytest.mark.parametrize("compression", ["adaptive", "always", "store"])
def test_checkpoint_blob_through_the_native_wire(tmp_path, monkeypatch, jax_libs, compression):
    """Pinned clock, same state: the port's native blob is the JAX native
    blob; with every chunk deflated it is the Python path's blob too, and
    with stored chunks it restores to the same bits."""
    monkeypatch.setattr(time, "time", lambda: 1.8e9)
    js = jax_state()
    state = port_state()
    monkeypatch.setattr(jwire, "_native", jax_libs[0])
    jckpt.save_checkpoint(str(tmp_path / "src"), js, step=3)
    load_state_tree(state, tckpt.restore_checkpoint(str(tmp_path / "src"))[0])
    meta = metadata(3)
    blobs = {}
    for tag, ours, theirs in (("native", native.load_wire(), jax_libs[0]), ("python", False, False)):
        monkeypatch.setattr(twire, "_native", ours)
        monkeypatch.setattr(jwire, "_native", theirs)
        jd, td = str(tmp_path / f"j{tag}"), str(tmp_path / f"t{tag}")
        jckpt.save_checkpoint(jd, js, step=3, metadata=meta, compression=compression)
        tckpt.save_checkpoint(td, state, metadata=meta, compression=compression)
        blobs[tag] = [open(os.path.join(d, "ckpt_3.dwc"), "rb").read() for d in (jd, td)]
        assert blobs[tag][0] == blobs[tag][1], tag
    if compression == "always":
        assert blobs["native"][1] == blobs["python"][1]
    monkeypatch.setattr(twire, "_native", native.load_wire())
    trees = [tckpt.flatten_tree(tckpt.restore_checkpoint(str(tmp_path / f"t{tag}"))[0])
             for tag in ("native", "python")]
    assert list(trees[0]) == list(trees[1])
    for k in trees[0]:
        a, b = trees[0][k], trees[1][k]
        if isinstance(a, dict):  # optax's empty state
            assert a == b == {}, k
            continue
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), k


def test_failed_build_raises_naming_the_setting(tmp_path, monkeypatch):
    src = tmp_path / "host"
    shutil.copytree(native.HOST_SRC, src)
    with open(src / "batch.cc", "a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(native, "HOST_SRC", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    native.load_batch.cache_clear()
    try:
        with pytest.raises(native.NativeBuildError, match="--set data.native_gather=False"):
            native.load_batch()
    finally:
        native.load_batch.cache_clear()


def test_the_failed_build_message_names_an_override_that_switches_the_gather_off():
    """The override that ``NativeBuildError`` names, read by the CLI's own
    ``--set`` parser (``ast.literal_eval``: a bare ``false`` would be the
    truthy string "false"), turns the native gather off."""
    import re

    from ddlpc_tpu_torch.train.__main__ import parse_args

    override = re.search(r"--set (\S+)", native._failed("libx", "boom")).group(1)
    cfg, *_ = parse_args(["--device", "cpu", "--set", override])
    assert cfg.data.native_gather is False
