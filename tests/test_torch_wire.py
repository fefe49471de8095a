"""The port's DWZ1 wire codec against the JAX package's, on the CPU.

Both run Python's zlib here (each package's native library is switched
off for the test by its ``wire._native = False``, which edits no file), so
every frame must be the same bytes, and each side must read the other's.
``tests/test_torch_native.py`` holds the native libraries.  Adaptive chunk compression stores random data and deflates
zeros.
"""

import numpy as np
import pytest

from ddlpc_tpu.utils import wire as jwire
from ddlpc_tpu_torch.utils import wire as twire
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

SIZES = (0, 1, 1 << 10, (1 << 20) + 17, 3 << 20)


@pytest.fixture(autouse=True)
def python_zlib_path(monkeypatch):
    monkeypatch.setattr(jwire, "_native", False)
    monkeypatch.setattr(twire, "_native", False)


def _payload(n: int, kind: str) -> bytes:
    rng = np.random.default_rng(n)
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "zeros":
        return bytes(n)
    return rng.integers(0, 4, n, dtype=np.uint8).tobytes()  # low entropy


@pytest.mark.parametrize("kind", ["random", "zeros", "small_alphabet"])
@pytest.mark.parametrize("n", SIZES)
def test_frames_byte_identical_and_read_each_way(n, kind):
    raw = _payload(n, kind)
    for level in (0, 1):
        tframe = twire.compress(raw, level)
        jframe = jwire.compress(raw, level)
        assert tframe == jframe
        assert jwire.decompress(tframe) == raw
        assert twire.decompress(jframe) == raw
        buf = np.zeros(n, np.uint8)
        assert twire.decompress_into(jframe, memoryview(buf)) == n
        assert buf.tobytes() == raw


def test_compress_chunks_adaptive_matches_jax():
    payloads = [_payload(n, "random") for n in SIZES] + [bytes(1 << 20), _payload(1 << 16, "x")]
    tframes = list(twire.compress_chunks(iter(payloads), adaptive=True))
    jframes = list(jwire.compress_chunks(iter(payloads), adaptive=True))
    assert tframes == jframes
    for raw, frame in zip(payloads, tframes):
        assert jwire.decompress(frame) == raw


def test_adaptive_stores_random_and_deflates_zeros():
    noise = np.random.default_rng(2).standard_normal(1 << 18).astype(np.float32).tobytes()
    assert twire.probe_level(noise) == 0
    assert twire.probe_level(bytes(1 << 16)) == twire.LEVEL
    assert twire.probe_level(b"") == twire.LEVEL
    stored, zeros = twire.compress_chunks([noise, bytes(len(noise))], adaptive=True)
    assert len(stored) >= len(noise)  # stored blocks: no smaller than the data
    assert len(zeros) < len(noise) // 100


@pytest.mark.parametrize(
    "frame,match",
    [(b"DW", "missing magic"), (b"XXXX\0\0\0\0", "bad wire magic"),
     (b"DWZ1\x05\0\0\0", "block count"), (twire.compress(b"abc") + b"!", "trailing garbage")],
)
def test_malformed_frames_raise(frame, match):
    with pytest.raises(ValueError, match=match):
        twire.decompress(frame)
    with pytest.raises(ValueError):
        jwire.decompress(frame)


def test_decompress_into_refuses_a_short_buffer():
    frame = twire.compress(bytes(100))
    with pytest.raises(ValueError, match="buffer"):
        twire.decompress_into(frame, memoryview(np.zeros(10, np.uint8)))
