"""The monolithic checkpoint format in the port, against the JAX package's
and flax's, on the CPU.

- ``utils/flax_msgpack.pack`` is byte for byte flax's
  ``serialization.msgpack_serialize`` on mixed trees: every dtype a state
  holds, 0-d leaves and numpy scalars, empty dicts, None, optax's nesting,
  ints, strs, bytes, lists and maps at every length boundary of their
  forms, and the chunked split (both sides' ``MAX_CHUNK_SIZE``
  monkeypatched down).  ``unpack`` gives what ``msgpack_restore`` gives,
  and refuses truncated, trailing, mis-sized and unknown input.
- A JAX-written ``ckpt_<step>.msgpack.z`` of a tiny U-Net state restores in
  the port bit for bit, and the port's in JAX's ``restore_checkpoint``; the
  compressed blob's bytes equal JAX's for the same snapshot.
- The format's behaviour: a mixed-format directory resumes from its newest
  step (in the reader and in the trainer), the prune keeps the newest
  blobs of both formats, corruption quarantines and falls back, a legacy
  blob without its sidecar gets ``lineage_unknown``, the async writer,
  and the serving engine's restore, reload and ``predict.py``.

Python's zlib on both sides (``wire._native = False``, set by the test).
"""

import json
import os
import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization

from ddlpc_tpu.train import checkpoint as jckpt
from ddlpc_tpu.utils import wire as jwire
from ddlpc_tpu_torch.convert import load_state_tree
from ddlpc_tpu_torch.obs import lineage as tlineage
from ddlpc_tpu_torch.train import checkpoint as tckpt
from ddlpc_tpu_torch.train.async_checkpoint import AsyncCheckpointer
from ddlpc_tpu_torch.utils import flax_msgpack
from ddlpc_tpu_torch.utils import wire as twire
from test_torch_checkpoint import (
    assert_flat_equal,
    flip,
    jax_state,
    jax_target,
    metadata,
    port_state,
    small_tree,
)
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse


@pytest.fixture(autouse=True)
def python_zlib_path(monkeypatch):
    monkeypatch.setattr(jwire, "_native", False)
    monkeypatch.setattr(twire, "_native", False)


# ---------------------------------------------------------------------------
# the codec against flax


DTYPES = ("float32", "float16", "float64", "bfloat16", "int8", "int16", "int32", "int64",
          "uint8", "uint16", "uint32", "uint64", "bool", "complex64")
INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
        -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
LENGTHS = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


def _array(dtype: str, shape, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = np.asarray(rng.standard_normal(shape) * 100)
    if dtype == "bfloat16":
        return x.astype(ml_dtypes.bfloat16)
    if dtype == "complex64":
        return (x + 1j * np.flip(x)).astype(np.complex64)
    return x.astype(dtype)


def port_side(tree):
    """The same tree as the port holds it: bfloat16 arrays as torch
    tensors (numpy has no bfloat16)."""
    if isinstance(tree, dict):
        return {k: port_side(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [port_side(v) for v in tree]
    if isinstance(tree, np.ndarray) and tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.int16).copy()).view(torch.bfloat16)
    return tree


def assert_same_tree(got, want) -> None:
    """``got`` (the port's) equals ``want`` (flax's) leaf for leaf: types,
    dtypes, shapes and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            assert_same_tree(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same_tree(g, w)
    elif isinstance(want, (np.ndarray, np.generic)) and want.dtype == ml_dtypes.bfloat16:
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == np.shape(want)
        assert got.view(torch.int16).numpy().tobytes() == np.asarray(want).tobytes()
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype
        assert np.shape(got) == np.shape(want) and np.asarray(got).tobytes() == np.asarray(want).tobytes()
    else:
        assert type(got) is type(want) and got == want


def cases():
    out = {}
    for dtype in DTYPES:
        out[f"array_{dtype}"] = {"x": _array(dtype, (3, 5)), "e": _array(dtype, (0, 4))}
        out[f"zero_d_{dtype}"] = {"x": _array(dtype, ())}
        if dtype != "bfloat16":
            out[f"scalar_{dtype}"] = {"x": _array(dtype, (1,))[0]}
    out["ints"] = {"i": INTS, "pos": 2**63, "neg": -3}
    for n in LENGTHS:
        out[f"len_{n}"] = {"s": "é" * (n // 2) + "a" * (n % 2), "a": "x" * n, "b": b"y" * n,
                           "l": list(range(n % 300)), "m": {f"k{i}": i for i in range(n % 300)}}
    out["len_big_containers"] = {"l": [None] * 65536, "m": {str(i): i for i in range(65536)}}
    out["ext_sizes"] = {f"u{n}": np.arange(n, dtype=np.uint8) for n in range(0, 300, 7)}
    out["ext_big"] = {"x": _array("float32", (70000,))}
    out["plain"] = {"none": None, "t": True, "f": False, "fl": 2.5, "neg": -0.0, "c": complex(1, -2),
                    "empty": {}, "nested": {"z": {}, "a": [1, {"b": None}]}, "nan": float("inf")}
    out["unsorted_keys"] = {"b": 1, "a": {"d": 2, "c": 3}, "_": 0, "A": 4}
    return out


CASES = cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_pack_equals_flax_msgpack_serialize(name):
    tree = CASES[name]
    want = serialization.msgpack_serialize(tree)
    assert flax_msgpack.pack(port_side(tree)) == want
    assert_same_tree(flax_msgpack.unpack(want), serialization.msgpack_restore(want))


def test_pack_equals_flax_on_a_train_state():
    """optax's nesting: ``(ScaleByAdamState, EmptyState)`` as flax's state
    dict gives it, with the tiny U-Net's params and statistics."""
    tree = serialization.to_state_dict(jax_state())
    tree = jax_tree_to_numpy(tree)
    want = serialization.msgpack_serialize(tree)
    assert flax_msgpack.pack(tree) == want
    assert_same_tree(flax_msgpack.unpack(want), serialization.msgpack_restore(want))


def jax_tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.mark.parametrize("limit", [64, 1000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
def test_chunked_split_equals_flax(monkeypatch, limit, dtype):
    """Arrays above ``MAX_CHUNK_SIZE`` bytes split into chunked dicts as
    flax splits them (a dict's values and the root; not inside lists)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", limit)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", limit)
    tree = {"big": _array(dtype, (13, 29)), "small": _array(dtype, (3,)),
            "deep": {"big": _array(dtype, (2, 3, 101), seed=1)}, "list": [_array(dtype, (300,))]}
    want = serialization.msgpack_serialize(tree)
    assert flax_msgpack.pack(port_side(tree)) == want
    assert_same_tree(flax_msgpack.unpack(want), serialization.msgpack_restore(want))
    root = _array(dtype, (77, 5), seed=2)
    want = serialization.msgpack_serialize(root)
    assert flax_msgpack.pack(port_side(root)) == want
    assert_same_tree(flax_msgpack.unpack(want), serialization.msgpack_restore(want))


@pytest.mark.parametrize("tree, error", [
    ({"t": (1, 2)}, TypeError),  # strict_types: a tuple is not an array
    ({"o": object()}, TypeError),
    ({"big": 2**64}, OverflowError),
    ({"obj": np.array([None], dtype=object)}, ValueError),
])
def test_pack_refuses_what_flax_refuses(tree, error):
    with pytest.raises(error):
        serialization.msgpack_serialize(tree)
    with pytest.raises(error):
        flax_msgpack.pack(tree)


def _blob() -> bytes:
    return serialization.msgpack_serialize(
        {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": {"c": "word", "d": [1, 300]},
         "e": np.float32(2.0), "f": None})


def test_unpack_refuses_every_truncation_and_trailing_bytes():
    blob = _blob()
    for cut in range(len(blob)):
        with pytest.raises(ValueError):
            flax_msgpack.unpack(blob[:cut])
    with pytest.raises(ValueError, match="trailing"):
        flax_msgpack.unpack(blob + b"\x00")


def _ext(code: int, payload: bytes) -> bytes:
    return b"\xc7" + bytes([len(payload), code]) + payload


@pytest.mark.parametrize("blob, match", [
    (b"\x81\xa1k" + _ext(5, b"abc"), "ext code"),
    (b"\x81\x01\xc0", "not a string"),
    (b"\xc1", "type byte"),
    # shape (2, 3) float32 holds 24 bytes; the bin holds 8: never a short array
    (b"\x81\xa1k" + _ext(1, b"\x93\x92\x02\x03\xa7float32\xc4\x08" + bytes(8)), "needs 24 bytes"),
    (b"\x81\xa1k" + _ext(1, b"\x93\x92\x02\x03\xa7float32\xc4\x18" + bytes(25)), "trailing"),
    (b"\x81\xa1k" + _ext(1, b"\x93\x92\x02\x03\xa7float32\xa1x"), "must be bin"),
    (b"\xdb\x00\x00\x10\x00abc", "truncated"),
    (b"\xdd\xff\xff\xff\xff\x01", "truncated"),
])
def test_unpack_refuses_malformed_input(blob, match):
    with pytest.raises(ValueError, match=match):
        flax_msgpack.unpack(blob)


# ---------------------------------------------------------------------------
# across the packages


def test_jax_monolithic_blob_restores_into_the_port_bit_for_bit(tmp_path):
    js = jax_state()
    d = str(tmp_path / "ck")
    path = jckpt.save_checkpoint(d, js, step=3, metadata={"epoch": 1}, format="monolithic")
    assert path.endswith("ckpt_3.msgpack.z")
    assert tckpt.verify_checkpoint(path) == jckpt.verify_checkpoint(path)
    assert tckpt.verify_checkpoint(path)["format"] == "monolithic"
    tree, meta = tckpt.restore_checkpoint(d)
    assert meta["epoch"] == 1 and meta["step"] == 3
    # The tree the chunked reader would give for the same state.
    jckpt.save_checkpoint(str(tmp_path / "dwc"), js, step=3)
    assert_flat_equal(tckpt.flatten_tree(tree),
                      tckpt.flatten_tree(tckpt.restore_checkpoint(str(tmp_path / "dwc"))[0]))
    state = port_state()
    load_state_tree(state, tree)
    assert state.step == 3 and state.opt_state.count == 3
    assert_flat_equal(tckpt.flatten_tree(tckpt.snapshot_state(state).tree()), jckpt.snapshot_state(js))


def test_port_monolithic_blob_restores_through_jax_bit_for_bit(tmp_path):
    js = jax_state()
    state = port_state()
    jckpt.save_checkpoint(str(tmp_path / "src"), js, step=3)
    load_state_tree(state, tckpt.restore_checkpoint(str(tmp_path / "src"))[0])
    d = str(tmp_path / "port")
    path = tckpt.save_checkpoint(d, state, metadata={"epoch": 1}, format="monolithic")
    assert path.endswith("ckpt_3.msgpack.z")
    restored, meta = jckpt.restore_checkpoint(d, jax_target())
    assert meta["epoch"] == 1 and meta["step"] == 3
    assert_flat_equal(jckpt.snapshot_state(restored), jckpt.snapshot_state(js))


def test_monolithic_blob_and_sidecar_bytes_equal_jax(tmp_path, monkeypatch):
    """The same snapshot gives the same compressed blob (it carries no
    lineage) and, once ``saved_at`` is pinned, the same sidecar."""
    js = jax_state()
    state = port_state()
    jckpt.save_checkpoint(str(tmp_path / "src"), js, step=3)
    load_state_tree(state, tckpt.restore_checkpoint(str(tmp_path / "src"))[0])
    monkeypatch.setattr(time, "time", lambda: 1.8e9)
    jd, td, meta = str(tmp_path / "j"), str(tmp_path / "t"), metadata(3)
    jckpt.save_checkpoint(jd, js, step=3, metadata=meta, format="monolithic")
    tckpt.save_checkpoint(td, state, metadata=meta, format="monolithic")
    for name in ("ckpt_3.msgpack.z", "ckpt_3.json"):
        with open(os.path.join(jd, name), "rb") as a, open(os.path.join(td, name), "rb") as b:
            assert a.read() == b.read(), name


def test_bfloat16_leaf_each_way_monolithic(tmp_path):
    x = np.arange(33, dtype=np.float32).astype(ml_dtypes.bfloat16)
    jckpt.save_checkpoint(str(tmp_path / "j"), {"x": x}, step=1, format="monolithic")
    tree, _ = tckpt.restore_checkpoint(str(tmp_path / "j"))
    assert tree["x"].dtype == torch.bfloat16
    assert tree["x"].view(torch.int16).numpy().tobytes() == x.tobytes()
    tckpt.save_snapshot(str(tmp_path / "t"), tckpt.flatten_tree({"x": tree["x"]}), step=1,
                        format="monolithic")
    back, _ = jckpt.restore_checkpoint(str(tmp_path / "t"), {"x": np.zeros(33, ml_dtypes.bfloat16)})
    assert back["x"].dtype == x.dtype and back["x"].tobytes() == x.tobytes()


# ---------------------------------------------------------------------------
# the format's behaviour


def write_step(d: str, step: int, fmt: str, keep: int = 10) -> None:
    tckpt.save_snapshot(d, tckpt.flatten_tree(small_tree(step)), step=step,
                        metadata={"epoch": step}, keep=keep, format=fmt)


def test_mixed_directory_restores_its_newest_step(tmp_path):
    d = str(tmp_path / "ck")
    for step, fmt in ((1, "chunked"), (2, "monolithic"), (3, "chunked"), (4, "monolithic")):
        write_step(d, step, fmt)
        tree, meta = tckpt.restore_checkpoint(d)
        assert meta["step"] == step and tckpt.checkpoint_path(d, step)[1] == fmt
        np.testing.assert_array_equal(tree["w"], small_tree(step)["w"])
        assert tree["step"] == step
    # Both files of one step: the chunked one is read.
    write_step(d, 4, "chunked")
    assert tckpt.checkpoint_path(d, 4) == (os.path.join(d, "ckpt_4.dwc"), "chunked")


def test_prune_keeps_the_newest_blobs_in_both_formats(tmp_path):
    d = str(tmp_path / "ck")
    for step, fmt in ((1, "chunked"), (2, "monolithic"), (3, "chunked"), (4, "monolithic")):
        write_step(d, step, fmt, keep=2)
    assert sorted(os.listdir(d)) == ["ckpt_3.dwc", "ckpt_3.json", "ckpt_4.json", "ckpt_4.msgpack.z"]
    jd = str(tmp_path / "j")  # JAX's prune over the same sequence: the same files
    for step, fmt in ((1, "chunked"), (2, "monolithic"), (3, "chunked"), (4, "monolithic")):
        jckpt.save_snapshot(jd, dict(jckpt._flatten_state_dict(small_tree(step))), step=step,
                            metadata={"epoch": step}, keep=2, format=fmt)
    assert sorted(os.listdir(jd)) == sorted(os.listdir(d))


@pytest.mark.parametrize("where", [0, 12, -6])
def test_corrupt_monolithic_blob_quarantines_and_falls_back(tmp_path, where):
    d = str(tmp_path / "ck")
    write_step(d, 1, "chunked")
    write_step(d, 2, "monolithic")
    newest = os.path.join(d, "ckpt_2.msgpack.z")
    flip(newest, where)
    with pytest.raises(ValueError):
        tckpt.verify_checkpoint(newest)
    with pytest.raises(ValueError):  # JAX's verdict on the same blob
        jckpt.verify_checkpoint(newest)
    with pytest.warns(RuntimeWarning, match="quarantined"):
        tree, meta = tckpt.restore_checkpoint(d)
    assert meta["step"] == 1 and meta["quarantined_steps"] == [2]
    np.testing.assert_array_equal(tree["w"], small_tree(1)["w"])
    assert os.path.exists(newest + ".bad") and tckpt.latest_step(d) == 1


def test_legacy_blob_without_sidecar_gets_lineage_unknown(tmp_path):
    d = str(tmp_path / "ck")
    jckpt.save_checkpoint(d, jax_state(), step=3, metadata=metadata(3), format="monolithic")
    tree, meta = tckpt.restore_checkpoint(d)
    assert meta["lineage"]["run_id"] == "0123456789abcdef"  # the sidecar's
    os.remove(os.path.join(d, "ckpt_3.json"))
    tree, meta = tckpt.restore_checkpoint(d)
    assert tlineage.is_unknown(meta["lineage"]) and meta["lineage"]["step"] == 3
    jmeta = jckpt.restore_checkpoint(d, jax_target())[1]
    assert meta["lineage"] == jmeta["lineage"]


def test_async_writer_monolithic(tmp_path, monkeypatch):
    """Background and inline writes of the monolithic format: the same
    bytes, and the state back bit for bit."""
    monkeypatch.setattr(time, "time", lambda: 1.8e9)
    state = port_state()
    before = tckpt.flatten_tree(tckpt.snapshot_state(state).tree())
    blobs = []
    for background in (True, False):
        ac = AsyncCheckpointer(format="monolithic", background=background)
        ac.save(str(tmp_path / str(background)), state, step=5, metadata=metadata(5))
        ac.close()
        assert ac.last_path.endswith("ckpt_5.msgpack.z")
        blobs.append(open(ac.last_path, "rb").read())
    assert blobs[0] == blobs[1]
    tree, meta = tckpt.restore_checkpoint(str(tmp_path / "True"))
    assert meta["step"] == 5
    assert_flat_equal(tckpt.flatten_tree(tree), before)


def _monolithic_run(workdir: str, seed: int, step: int) -> None:
    """A JAX serving run (``make_tiny_run``) whose checkpoint is rewritten
    as a legacy monolithic blob by the JAX package."""
    from test_torch_serve import write_run

    write_run(workdir, seed=seed, step=step)
    d = os.path.join(workdir, "checkpoints")
    tree, meta = tckpt.restore_checkpoint(d, step=step)
    os.remove(os.path.join(d, f"ckpt_{step}.dwc"))
    jckpt.save_snapshot(d, dict(jckpt._flatten_state_dict(tree)), step=step, metadata=meta,
                        format="monolithic")


def test_serve_engine_restores_and_reloads_a_monolithic_run(tmp_path):
    from ddlpc_tpu.serve import engine as jengine
    from ddlpc_tpu_torch import predict as tpredict
    from ddlpc_tpu_torch.serve import engine as tengine
    from test_torch_serve import windows

    run = str(tmp_path / "run")
    _monolithic_run(run, seed=0, step=1)
    te = tengine.InferenceEngine.from_workdir(run, echo=False, device="cpu")
    je = jengine.InferenceEngine.from_workdir(run, echo=False)
    assert te.checkpoint_step == je.checkpoint_step == 1
    x = windows(2, seed=3)
    np.testing.assert_allclose(te.forward_windows(x), je.forward_windows(x), rtol=1e-5, atol=1e-5)
    _monolithic_run(run, seed=7, step=2)
    tmeta, jmeta = te.reload(), je.reload()
    assert tmeta["restore_format"] == jmeta["restore_format"] == "monolithic"
    assert te.checkpoint_step == 2 and te.version == 1
    np.testing.assert_allclose(te.forward_windows(x), je.forward_windows(x), rtol=1e-5, atol=1e-5)
    # predict.py restores through the same engine.
    _, _, _, channels = tpredict.load_run(run, device="cpu")
    assert channels == 3


def test_trainer_resumes_across_formats(tmp_path):
    """One process: a run of 3 epochs equals epoch 0 saved chunked, epoch 1
    resumed and saved monolithic, epoch 2 resumed from that newest
    monolithic step (the directory then mixes both formats), bit for bit."""
    from test_torch_resume import canonical, assert_same_state, make_trainer, records

    cfg = {
        "model": {"features": [8], "bottleneck_features": 8, "num_classes": 3,
                  "compute_dtype": "float32", "head_dtype": "float32"},
        "data": {"image_size": [32, 32], "synthetic_len": 12, "test_split": 4, "num_classes": 3},
        "train": {"epochs": 3, "micro_batch_size": 2, "sync_period": 2, "eval_every_epochs": 3},
        "compression": {"mode": "float16"},
    }
    config = tmp_path / "tiny.json"
    config.write_text(json.dumps(cfg))
    full = make_trainer(str(config), tmp_path / "full", resume=False)
    full.fit()
    split = tmp_path / "split"
    for epochs, fmt in ((1, "chunked"), (2, "monolithic"), (3, "chunked")):
        t = make_trainer(str(config), split, f"train.epochs={epochs}",
                         f"train.checkpoint_format={fmt}")
        assert t.start_epoch == epochs - 1
        t.fit()
    names = sorted(os.listdir(os.path.join(split, "checkpoints")))
    assert "ckpt_4.msgpack.z" in names and "ckpt_2.dwc" in names and "ckpt_6.dwc" in names
    want, got = records(tmp_path / "full"), records(split)
    assert [r["epoch"] for r in got] == [0, 1, 2]
    for w, g in zip(want, got):
        assert (w["loss"], w["grad_norm"]) == (g["loss"], g["grad_norm"])
    assert_same_state(canonical(full), canonical(t))
