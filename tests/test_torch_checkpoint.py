"""The port's chunked checkpoint (DWC2) against the JAX package's, on the CPU.

A tiny U-Net's train state — params, BatchNorm statistics, Adam ``count``,
``mu`` and ``nu``, ``step`` and optax's empty state — is written by one
package and restored by the other, leaf for leaf and bit for bit.  With
Python's zlib on both sides (``wire._native = False`` in both packages, set
by the test, which edits no file), the same state and metadata make the same
blob and sidecar bytes once the one field stamped at write time, the
lineage's ``saved_at``, is pinned.  Then the integrity machinery: CRC
corruption quarantines and falls back, nothing restorable raises, the
prune keeps the newest blob that verifies, a crash between the two renames
leaves only an orphan sidecar.
"""

import json
import os
import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from ddlpc_tpu.config import ExperimentConfig as JExperimentConfig
from ddlpc_tpu.config import ModelConfig as JModelConfig
from ddlpc_tpu.models import build_model as jbuild_model
from ddlpc_tpu.obs import lineage as jlineage
from ddlpc_tpu.parallel import train_step as jts
from ddlpc_tpu.train import checkpoint as jckpt
from ddlpc_tpu.utils import wire as jwire
from ddlpc_tpu_torch.config import ExperimentConfig, ModelConfig
from ddlpc_tpu_torch.convert import load_state_tree
from ddlpc_tpu_torch.models import build_model
from ddlpc_tpu_torch.obs import lineage as tlineage
from ddlpc_tpu_torch.parallel.train_step import create_train_state
from ddlpc_tpu_torch.train import checkpoint as tckpt
from ddlpc_tpu_torch.utils import wire as twire
from ddlpc_tpu_torch.train.async_checkpoint import AsyncCheckpointer
from ddlpc_tpu_torch.train.optim import Adam
from test_torch_model import flax_like_variables
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 2e-3
TINY = dict(
    features=(8, 16), bottleneck_features=16, width_divisor=1, stem="s2d",
    stem_factor=2, detail_head=True, num_classes=6,
    compute_dtype="float32", head_dtype="float32",
)
CHUNK = 4096  # several chunks a leaf, besides the default's one


@pytest.fixture(autouse=True)
def python_zlib_path(monkeypatch):
    monkeypatch.setattr(jwire, "_native", False)
    monkeypatch.setattr(twire, "_native", False)


def jax_state(seed: int = 0):
    """A JAX ``TrainState`` of the tiny U-Net three steps in: seeded
    weights and statistics, seeded Adam moments, count and step 3."""
    variables = flax_like_variables(jbuild_model(JModelConfig(**TINY)), seed)
    rng = np.random.default_rng(seed + 100)
    params = variables["params"]
    moments = [
        {k: np.asarray(v) for k, v in _leaves(params)}
        for _ in range(2)
    ]
    mu, nu = (
        _rebuild(params, {k: (rng.normal(size=v.shape) * scale).astype(np.float32)
                          for k, v in m.items()})
        for m, scale in zip(moments, (1e-3, 1e-6))
    )
    nu = _rebuild(params, {k: np.abs(v) for k, v in _leaves(nu)})
    adam = optax.ScaleByAdamState(count=jnp.int32(3), mu=mu, nu=nu)
    return jts.TrainState(
        step=jnp.int32(3), params=params, batch_stats=variables["batch_stats"],
        opt_state=(adam, optax.EmptyState()),
    )


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _rebuild(like, flat):
    out = {}
    for path, _ in _leaves(like):
        cur = out
        for k in path[:-1]:
            cur = cur.setdefault(k, {})
        cur[path[-1]] = flat[path]
    return out


def jax_target():
    """A restore target of the right structure (zeros)."""
    s = jax_state(1)
    zero = lambda t: _rebuild(t, {k: np.zeros_like(v) for k, v in _leaves(t)})  # noqa: E731
    return s.replace(
        step=jnp.int32(0), params=zero(s.params), batch_stats=zero(s.batch_stats),
        opt_state=(optax.ScaleByAdamState(jnp.int32(0), zero(s.opt_state[0].mu),
                                          zero(s.opt_state[0].nu)), optax.EmptyState()),
    )


def port_state():
    model = build_model(ModelConfig(**TINY))
    return create_train_state(model, Adam(LR))


def assert_flat_equal(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        if isinstance(a[k], dict):
            assert a[k] == b[k] == {}, k
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def metadata(step: int) -> dict:
    lin = tlineage.make_lineage(step, run_id="0123456789abcdef", config_hash_hex="fedcba9876543210")
    return {"epoch": 1, "input_channels": 3, "lineage": lin}


def test_jax_checkpoint_restores_into_the_port_bit_for_bit(tmp_path):
    js = jax_state()
    d = str(tmp_path / "ck")
    jckpt.save_checkpoint(d, js, step=3, metadata={"epoch": 1}, chunk_bytes=CHUNK)
    tree, meta = tckpt.restore_checkpoint(d)
    assert meta["epoch"] == 1 and meta["step"] == 3
    state = port_state()
    load_state_tree(state, tree)
    assert state.step == 3 and state.opt_state.count == 3
    # Back to the flax layout from the port's own buffers: every leaf the
    # same bits, the same dtype, the same order, the empty leaf kept.
    assert_flat_equal(tckpt.flatten_tree(tckpt.snapshot_state(state).tree()), jckpt.snapshot_state(js))


def test_port_checkpoint_restores_through_jax_bit_for_bit(tmp_path):
    js = jax_state()
    state = port_state()
    src = str(tmp_path / "jax")
    jckpt.save_checkpoint(src, js, step=3)
    load_state_tree(state, tckpt.restore_checkpoint(src)[0])
    d = str(tmp_path / "port")
    path = tckpt.save_checkpoint(d, state, metadata={"epoch": 1}, chunk_bytes=CHUNK)
    assert path.endswith("ckpt_3.dwc")
    restored, meta = jckpt.restore_checkpoint(d, jax_target())
    assert meta["epoch"] == 1 and meta["step"] == 3
    assert_flat_equal(jckpt.snapshot_state(restored), jckpt.snapshot_state(js))


@pytest.mark.parametrize("chunk_bytes", [CHUNK, tckpt.CHUNK_BYTES])
@pytest.mark.parametrize("compression", ["adaptive", "store"])
def test_blob_and_sidecar_bytes_equal_jax(tmp_path, monkeypatch, chunk_bytes, compression):
    """Same state, same metadata: the same bytes.  Without pinning the
    clock they differ in one field only, the lineage's ``saved_at``
    (stamped at the durable write), in the manifest and the sidecar."""
    js = jax_state()
    state = port_state()
    jckpt.save_checkpoint(str(tmp_path / "src"), js, step=3)
    load_state_tree(state, tckpt.restore_checkpoint(str(tmp_path / "src"))[0])
    meta = metadata(3)

    def both(tag: str):
        jd, td = str(tmp_path / f"j{tag}"), str(tmp_path / f"t{tag}")
        jckpt.save_checkpoint(jd, js, step=3, metadata=meta, chunk_bytes=chunk_bytes,
                              compression=compression)
        tckpt.save_checkpoint(td, state, metadata=meta, chunk_bytes=chunk_bytes,
                              compression=compression)
        return [[open(os.path.join(d, name), "rb").read() for d in (jd, td)]
                for name in ("ckpt_3.dwc", "ckpt_3.json")]

    (jblob, tblob), (jside, tside) = both("free")
    jm, tm = (tckpt._parse_dwc(b, "blob")[0] for b in (jblob, tblob))
    assert jm["lineage"].pop("saved_at") != tm["lineage"].pop("saved_at")
    assert jm == tm
    monkeypatch.setattr(time, "time", lambda: 1.8e9)
    (jblob, tblob), (jside, tside) = both("pinned")
    assert jblob == tblob
    assert jside == tside


def test_bfloat16_leaf_each_way(tmp_path):
    x = np.arange(33, dtype=np.float32).astype(ml_dtypes.bfloat16)
    jckpt.save_checkpoint(str(tmp_path / "j"), {"x": x}, step=1)
    tree, _ = tckpt.restore_checkpoint(str(tmp_path / "j"))
    assert tree["x"].dtype == torch.bfloat16
    assert tree["x"].view(torch.int16).numpy().tobytes() == x.tobytes()
    tckpt.save_snapshot(str(tmp_path / "t"), tckpt.flatten_tree({"x": tree["x"]}), step=1)
    back, _ = jckpt.restore_checkpoint(str(tmp_path / "t"), {"x": np.zeros(33, ml_dtypes.bfloat16)})
    assert back["x"].dtype == x.dtype and back["x"].tobytes() == x.tobytes()


# ---------------------------------------------------------------------------
# integrity


def small_tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((64, 64)).astype(np.float32),
            "b": rng.standard_normal(17).astype(np.float32), "step": seed}


def write_steps(d: str, steps, keep: int = 10) -> None:
    for s in steps:
        tckpt.save_snapshot(d, tckpt.flatten_tree(small_tree(s)), step=s,
                            metadata={"epoch": s}, keep=keep)


def flip(path: str, where: int) -> None:
    with open(path, "r+b") as f:
        f.seek(where if where >= 0 else os.path.getsize(path) + where)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))


@pytest.mark.parametrize("where", [12, -6, "manifest"])
def test_corruption_quarantines_and_falls_back(tmp_path, where):
    d = str(tmp_path / "ck")
    write_steps(d, [1, 2])
    newest = os.path.join(d, "ckpt_2.dwc")
    if where == "manifest":
        man_off = tckpt._DWC2_FOOTER.unpack(open(newest, "rb").read()[-tckpt._DWC2_FOOTER.size:])[0]
        where = man_off + 5
    flip(newest, where)
    with pytest.raises(ValueError):
        tckpt.verify_checkpoint(newest)
    assert tckpt.verify_checkpoint(os.path.join(d, "ckpt_1.dwc"))["verified_chunks"] == 2
    with pytest.warns(RuntimeWarning, match="quarantined"):
        tree, meta = tckpt.restore_checkpoint(d)
    assert meta["step"] == 1 and meta["quarantined_steps"] == [2]
    np.testing.assert_array_equal(tree["w"], small_tree(1)["w"])
    assert os.path.exists(newest + ".bad") and tckpt.latest_step(d) == 1
    # JAX's reader reaches the same verdict on the port's blob.
    with pytest.raises(ValueError):
        jckpt.verify_checkpoint(newest + ".bad")


def test_nothing_restorable_raises(tmp_path):
    d = str(tmp_path / "ck")
    write_steps(d, [1])
    flip(os.path.join(d, "ckpt_1.dwc"), 12)
    with pytest.warns(RuntimeWarning), pytest.raises(ValueError, match="no fallback remains"):
        tckpt.restore_checkpoint(d)
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "empty"))


def test_explicit_step_never_substitutes(tmp_path):
    d = str(tmp_path / "ck")
    write_steps(d, [1, 2])
    flip(os.path.join(d, "ckpt_2.dwc"), 12)
    with pytest.warns(RuntimeWarning), pytest.raises(ValueError):
        tckpt.restore_checkpoint(d, step=2)
    assert tckpt.restore_checkpoint(d, step=1)[1]["step"] == 1


def test_prune_keeps_the_newest_blob_that_verifies(tmp_path):
    d = str(tmp_path / "ck")
    write_steps(d, [1, 2, 3])
    for s in (2, 3):  # the kept window goes corrupt in its footers
        flip(os.path.join(d, f"ckpt_{s}.dwc"), -6)
    tckpt._prune(d, keep=2)  # keep 2 would delete step 1, the newest that verifies
    assert tckpt._steps(d) == [1, 2, 3]
    assert os.path.exists(os.path.join(d, "ckpt_1.json"))
    write_steps(d, [4], keep=1)  # a fresh newest that verifies: the rest may go
    assert tckpt._steps(d) == [4]


def test_crash_between_the_two_renames_leaves_only_an_orphan_sidecar(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    write_steps(d, [1])
    real = os.replace

    def crash_on_blob(src, dst):
        if dst.endswith(".dwc"):
            raise OSError("killed between the renames")
        return real(src, dst)

    monkeypatch.setattr(os, "replace", crash_on_blob)
    with pytest.raises(OSError, match="killed"):
        write_steps(d, [2])
    monkeypatch.setattr(os, "replace", real)
    assert sorted(os.listdir(d)) == ["ckpt_1.dwc", "ckpt_1.json", "ckpt_2.json"]
    assert tckpt.latest_step(d) == 1
    assert tckpt.restore_checkpoint(d)[1]["step"] == 1
    write_steps(d, [3])  # the next save's prune sweeps the orphan
    assert sorted(os.listdir(d)) == ["ckpt_1.dwc", "ckpt_1.json", "ckpt_3.dwc", "ckpt_3.json"]


def test_metadata_lineage_and_peek(tmp_path):
    d = str(tmp_path / "ck")
    write_steps(d, [4])
    meta = tckpt.peek_metadata(d)
    assert meta["step"] == 4 and not tlineage.is_unknown(meta["lineage"])
    assert tckpt.read_manifest_lineage(os.path.join(d, "ckpt_4.dwc")) == meta["lineage"]
    os.remove(os.path.join(d, "ckpt_4.json"))  # the manifest still carries it
    assert tckpt.restore_checkpoint(d)[1]["lineage"] == meta["lineage"]
    assert tlineage.is_unknown(tlineage.unknown_lineage(4)) and tlineage.is_unknown(None)


def test_config_hash_equals_jax():
    with open(os.path.join(REPO, "configs", "vaihingen_unet_tpu_flagship.json")) as f:
        text = f.read()
    assert tlineage.config_hash(text) == jlineage.config_hash(text)
    # The trainer's hash of the parsed config: the same on both sides.
    tcfg = json.dumps(ExperimentConfig.from_json(text).to_dict(), sort_keys=True)
    jcfg = json.dumps(JExperimentConfig.from_json(text).to_dict(), sort_keys=True)
    assert tlineage.config_hash(tcfg) == jlineage.config_hash(jcfg)


def test_async_snapshot_is_a_copy(tmp_path):
    """The step updates params and moments in place: a snapshot taken
    before it must not see the update, even while the write is queued."""
    state = port_state()
    d = str(tmp_path / "ck")
    before = state.params.data.clone()
    ac = AsyncCheckpointer(keep=2)
    ac.save(d, state, step=0)
    state.params.data.add_(1.0)
    state.opt_state.mu.add_(1.0)
    ac.close()
    tree, _ = tckpt.restore_checkpoint(d)
    after = port_state()
    load_state_tree(after, tree)
    assert torch.equal(after.params.data, before)
    assert not after.opt_state.mu.any()
    assert ac.last_write_s > 0 and ac.last_path.endswith("ckpt_0.dwc")


def test_inline_and_background_writes_are_the_same_blob(tmp_path, monkeypatch):
    """``checkpoint_async=false`` moves the write onto the training thread
    and changes nothing on disk."""
    monkeypatch.setattr(time, "time", lambda: 1.8e9)
    state, meta = port_state(), metadata(5)
    blobs = []
    for background in (True, False):
        ac = AsyncCheckpointer(background=background)
        ac.save(str(tmp_path / str(background)), state, step=5, metadata=meta)
        ac.close()
        blobs.append(open(ac.last_path, "rb").read())
    assert blobs[0] == blobs[1]
