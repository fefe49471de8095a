"""Stochastic rounding in the port against the JAX package, on the CPU.

The port draws its own noise (Philox4x32-10, ``ddlpc_tpu_torch/ops/philox.py``)
and cannot reproduce JAX's threefry or the TPU's hardware bits, so it is
held to the JAX package in two ways:

- bit for bit, given the same noise: the plain codec against
  ``snap_to_lattice(noise=)``, the noise path of the wrappers against the
  Pallas host-noise kernels in the interpreter (fake-quantize within 1 ulp:
  the Pallas kernel dequantizes as ``lattice / levels · scale``), the sync
  against ``sync_gradients(key=)`` in ``shard_map`` fed the fields JAX's
  key schedule draws (two tiny U-Net train steps against
  ``make_train_step(seed=)`` are in ``test_torch_train_step_stochastic.py``,
  so that each file's JAX compile stays short);
- in distribution, for its own draw: unbiasedness over keys at the
  Monte-Carlo tolerance of ``tests/test_stochastic_rounding.py``, the
  one-step error bound, determinism, the key schedule and the offset-slice
  property.
"""

import json
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddlpc_tpu.config import CompressionConfig as JCompression
from ddlpc_tpu.ops import pallas_quantize as jpallas
from ddlpc_tpu.ops import quantize as jq
from ddlpc_tpu_torch.config import CompressionConfig, ExperimentConfig
from ddlpc_tpu_torch.ops import cuda_quantize as cq
from ddlpc_tpu_torch.ops import philox
from ddlpc_tpu_torch.ops import quantize as tq
from ddlpc_tpu_torch.parallel import grad_sync as tsync
from ddlpc_tpu_torch.train.__main__ import main as cli_main
from ddlpc_tpu_torch.train.trainer import Trainer
from test_torch_codec import _exact, _jax_sync, _tree
from test_torch_train_step import LR, TINY, _OFF
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

MODES = ["int8", "float16"]
_WIRES = {"int8": (jnp.int8, torch.int8), "float16": (jnp.float16, torch.float16)}
_M32 = 0xFFFFFFFF


def _sto(mode: str):
    return JCompression(mode=mode, rounding="stochastic"), CompressionConfig(
        mode=mode, rounding="stochastic"
    )


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _philox_ref(counter, key):
    """Philox4x32-10 on Python ints, written from the paper's round."""
    c, k = list(counter), list(key)
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & _M32, (p0 >> 32) ^ c[3] ^ k[1], p0 & _M32]
        k = [(k[0] + 0x9E3779B9) & _M32, (k[1] + 0xBB67AE85) & _M32]
    return c


# --- (a) the generator ------------------------------------------------------


@pytest.mark.parametrize(
    "counter,key,want",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((_M32,) * 4, (_M32, _M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        (
            (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
            (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
        ),
    ],
)
def test_philox_known_answers(counter, key, want):
    got = philox.philox4x32(torch.tensor([counter], dtype=torch.int64), key)
    assert got[0].tolist() == list(want)
    assert _philox_ref(counter, key) == list(want)


@pytest.mark.parametrize("offset", [0, 1, 4, 5, 7, (1 << 34) + 3])
def test_stream_layout_and_offset_slices(offset):
    """Element e is word e % 4 of counter e // 4 (lo, hi, 0, 0), as its top
    24 bits · 2⁻²⁴; a draw at ``offset`` is the slice of the draw from 0,
    and so are the stochastic encode's lattice values."""
    key = (0x12345678, 0x9ABCDEF0)
    n = 37
    u = philox.uniform(key, offset, n)
    for i in range(n):
        e = offset + i
        word = _philox_ref((e // 4 & _M32, e // 4 >> 32, 0, 0), key)[e % 4]
        assert u[i].item() == (word >> 8) * 2.0**-24
    assert u.dtype == torch.float32 and 0.0 <= u.min() and u.max() < 1.0
    if offset < 8:
        full = philox.uniform(key, 0, n + offset)
        assert torch.equal(full[offset:], u)
        x = _t(np.random.default_rng(offset).normal(size=n + offset))
        safe = tq.safe_divisor(x.abs().amax().reshape(1))
        cfg = _sto("int8")[1]
        q_full = cq.encode_to_wire(x, safe, cfg, torch.int8, key=key)
        q_part = cq.encode_to_wire(x[offset:], safe, cfg, torch.int8, key=key, offset=offset)
        assert torch.equal(q_full[offset:], q_part)


# --- (b) the plain codec against snap_to_lattice(noise=) --------------------


def _lattice_case(mode: str, zero: bool):
    """Gradient-like values with exact lattice points and zeros (or all
    zeros: a zero scale), and a U[0,1) field of values k·2⁻²⁴ that includes
    0 and the largest value below 1."""
    rng = np.random.default_rng(11)
    levels = 10 if mode == "int8" else 100
    x = np.concatenate([
        rng.normal(size=300) * 0.3,
        np.arange(-levels, levels + 1) * (2.0 / levels),  # exact lattice points
        np.zeros(40),
    ]).astype(np.float32)
    x[0] = 2.0  # pins the scale
    if zero:
        x[:] = 0.0
    u = (rng.integers(0, 1 << 24, size=x.size) * 2.0**-24).astype(np.float32)
    u[:4] = [0.0, 1.0 - 2.0**-24, 0.5, 2.0**-24]
    return x, u, float(levels)


# Around the encode_sr kernel's edges: four elements a Philox counter, a
# warp's pass of two 32-counter tiles (256 elements), a few passes and one
# more; at offsets that are and are not multiples of 4.  On the CPU the
# wrappers run the plain versions; the card tests hold the kernel itself.
_EDGES = [(n, o) for n in (1, 3, 4, 5, 255, 256, 257, 3 * 256 + 1) for o in (0, 1, 4, 5)]


@pytest.mark.parametrize("n,offset", [(None, 0)] + _EDGES)
@pytest.mark.parametrize("zero", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_plain_stochastic_bit_exact_against_jax_noise(mode, zero, n, offset):
    """The plain codec and the wrappers given a noise field equal JAX's
    ``snap_to_lattice(noise=)`` bit for bit.  With ``n``, x is ``n``
    elements at ``offset`` into the case's values and the noise is a key's
    draw at ``offset``: the encode drawn from that key at that offset
    equals JAX given the same draw, and the slice of the encode of the
    whole buffer drawn from 0."""
    x, u, levels = _lattice_case(mode, zero)
    key = (0x2545F491, n or 0)
    big = x
    if n is not None:
        big = np.resize(x, n + offset)
        x = big[offset:]
        u = philox.uniform(key, offset, n).numpy()
    jcfg, tcfg = _sto(mode)
    jwire, twire = _WIRES[mode]
    scale = jq.global_absmax({"x": jnp.asarray(x)})
    safe = jq.safe_divisor(scale)
    q = jq.snap_to_lattice(jnp.asarray(x) / safe * levels, levels, noise=jnp.asarray(u)).astype(jwire)
    dec = jq.decode(jq.Encoded(scale, {"x": q}), jcfg)["x"]

    tsafe = tq.safe_divisor(torch.tensor(np.asarray(scale)).reshape(1))
    _exact(q, tq.encode_with_scale(_t(x), tsafe, levels, twire, noise=_t(u)).numpy())
    _exact(q, cq.encode_to_wire(_t(x), tsafe, tcfg, twire, noise=_t(u)).numpy())
    _exact(dec, tq.fake_quantize([_t(x)], tcfg, noise=[_t(u)])[0].numpy())
    _exact(dec, cq.fake_quantize_fused(_t(x), tcfg, noise=_t(u)).numpy())
    if n is not None:
        tbig = _t(big)
        got = cq.encode_to_wire(tbig[offset:], tsafe, tcfg, twire, key=key, offset=offset)
        _exact(q, got.numpy())
        assert torch.equal(cq.encode_to_wire(tbig, tsafe, tcfg, twire, key=key)[offset:], got)
    elif not zero:
        # Exact lattice points and the largest u exercise the add's rounding.
        assert (np.asarray(q) != np.round(x / 2.0 * levels)).any()


# --- (c) the noise path against the Pallas host-noise kernels ---------------


def _pallas_seeds(key, n_leaves):
    """The per-leaf seeds of ``encode_to_wire_pallas``/``fake_quantize_pallas``."""
    return list(
        jax.random.randint(key, (n_leaves,), jnp.iinfo(jnp.int32).min, jnp.iinfo(jnp.int32).max)
    )


def _fq_padded_shape(n: int):
    """``_fq_leaf``'s padded [rows, LANES] layout of an n-element leaf."""
    rows = -(-n // jpallas.LANES)
    block_rows = min(jpallas._BLOCK_ROWS, -(-rows // 8) * 8)
    return (-(-rows // block_rows) * block_rows, jpallas.LANES)


@pytest.mark.parametrize("mode", MODES)
def test_noise_path_matches_pallas_interpret(mode):
    tree = _tree(mode, seed=7)
    names = sorted(tree)
    jcfg, tcfg = _sto(mode)
    jwire, twire = _WIRES[mode]
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    flat = _t(np.concatenate([tree[k].reshape(-1) for k in names]))
    key = jax.random.key(23)
    seeds = _pallas_seeds(key, len(names))
    levels = float(jq.levels_for(jcfg))
    scale = jq.global_absmax(jtree)
    safe = jq.safe_divisor(scale)

    def field(shape_of):
        return _t(np.concatenate([
            np.asarray(jax.random.uniform(jax.random.key(jnp.abs(s)), shape_of(k))).reshape(-1)[
                : tree[k].size
            ]
            for k, s in zip(names, seeds)
        ]))

    enc_u = field(lambda k: jpallas._wire_block_layout(jtree[k], jwire)[0].shape)
    want = jpallas.encode_to_wire_pallas(jtree, jcfg, safe, jwire, key=key, interpret=True)
    tsafe = tq.safe_divisor(torch.tensor(np.asarray(scale)).reshape(1))
    got = cq.encode_to_wire(flat, tsafe, tcfg, twire, noise=enc_u)
    _exact(np.concatenate([np.asarray(want[k]).reshape(-1) for k in names]), got.numpy())

    fq_u = field(lambda k: _fq_padded_shape(tree[k].size))
    want = jpallas.fake_quantize_pallas(jtree, jcfg, key=key, interpret=True)
    want = np.concatenate([np.asarray(want[k]).reshape(-1) for k in names])
    got = cq.fake_quantize_fused(flat, tcfg, noise=fq_u).numpy()
    step = np.float32(np.asarray(scale)) / np.float32(levels)
    np.testing.assert_array_equal(np.rint(got / step), np.rint(want / step))  # the lattice
    np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=0)
    assert np.abs(np.rint(got / step)).max() == levels


# --- (d) the sync against JAX's sync_gradients(key=) ------------------------


def _leaf_fields(key, shapes) -> torch.Tensor:
    """JAX's ``_leaf_keys`` → ``uniform`` per leaf, laid out flat in order."""
    keys = jax.random.split(key, len(shapes))
    return _t(np.concatenate([
        np.asarray(jax.random.uniform(k, s)).reshape(-1) for k, s in zip(keys, shapes)
    ]))


def _jax_stage_keys(key):
    """``_sync_tree``'s split, with replica 0 folded into the local key."""
    local, mean = jax.random.split(key)
    return jax.random.fold_in(local, 0), mean


@pytest.mark.parametrize("local,mean", [(True, True), (True, False), (False, True)])
@pytest.mark.parametrize("mode", MODES)
def test_sync_with_jax_noise_bit_exact_against_shard_map(mode, local, mean):
    tree = _tree(mode, seed=3)
    names = sorted(tree)
    jcfg = JCompression(mode=mode, rounding="stochastic", quantize_local=local, quantize_mean=mean)
    tcfg = CompressionConfig(mode=mode, rounding="stochastic", quantize_local=local, quantize_mean=mean)
    key = jax.random.key(31)
    ref = _jax_sync(tree, jcfg, key=key)
    shapes = [tree[k].shape for k in names]
    noise = tuple(_leaf_fields(k, shapes) for k in _jax_stage_keys(key))
    flat = _t(np.concatenate([tree[k].reshape(-1) for k in names]))
    assert tsync.sync_gradients(flat, tcfg, noise=noise) is flat
    got = np.split(flat.numpy(), np.cumsum([tree[k].size for k in names])[:-1])
    for k, g in zip(names, got):
        _exact(np.asarray(ref[k]).reshape(-1), g)


# --- the port's own draw ----------------------------------------------------


def test_port_draw_is_unbiased_over_512_keys():
    """``tests/test_stochastic_rounding.py::test_unbiased_over_keys`` on the
    port's Philox draw: the same input size, trials and tolerance."""
    g = _t(np.random.default_rng(0).normal(size=(400,)))
    cfg = _sto("int8")[1]
    trials = 512
    acc = torch.zeros_like(g, dtype=torch.float64)
    for i in range(trials):
        acc += cq.fake_quantize_fused(g, cfg, key=philox.rounding_key(0, i, "mean")).double()
    step = float(g.abs().max()) / cfg.int8_levels
    tol = 4 * (step / 2) / np.sqrt(trials)
    np.testing.assert_allclose((acc / trials).numpy(), g.double().numpy(), atol=tol)


@pytest.mark.parametrize("mode", MODES)
def test_port_draw_error_bound_and_determinism(mode):
    g = _t(np.random.default_rng(1).normal(size=(1000,)))
    cfg = _sto(mode)[1]
    k1, k2 = (7, 0), (8, 0)
    out = cq.fake_quantize_fused(g, cfg, key=k1)
    bound = tq.quantization_error_bound(cfg) * float(g.abs().max()) + 1e-6
    assert float((out - g).abs().max()) <= bound
    assert torch.equal(out, cq.fake_quantize_fused(g, cfg, key=k1))
    assert not torch.equal(out, cq.fake_quantize_fused(g, cfg, key=k2))
    # Both neighbours of the lattice are used: this is not nearest rounding.
    assert not torch.equal(out, cq.fake_quantize_fused(g, CompressionConfig(mode=mode)))


def test_key_schedule_follows_seed_step_stage_and_replica():
    def draw(*args, **kw):
        return philox.uniform(philox.rounding_key(*args, **kw), 0, 64)

    base = draw(0, 0, "local")
    assert torch.equal(base, draw(0, 0, "local", replica=0))
    for other in (draw(1, 0, "local"), draw(0, 1, "local"), draw(0, 0, "mean"),
                  draw(0, 0, "local", replica=1), draw(-1, 0, "local")):
        assert not torch.equal(base, other)
    # The mean key is shared by every replica.
    assert torch.equal(draw(0, 3, "mean"), draw(0, 3, "mean", replica=5))
    # The train step's key is (train.seed, step); nearest rounding takes none.
    from ddlpc_tpu_torch.parallel.train_step import _rounding_rng

    sto = _sto("int8")[1]
    assert _rounding_rng(sto, 4, 9) == philox.step_key(4, 9) != philox.step_key(4, 10)
    assert _rounding_rng(CompressionConfig(mode="int8"), 4, 9) is None
    # And the sync splits it: local and mean draws of one step differ.
    x = _t(np.random.default_rng(2).normal(size=257))
    once = tsync.sync_gradients(x.clone(), sto, key=philox.step_key(4, 9))
    assert torch.equal(once, tsync.sync_gradients(x.clone(), sto, key=philox.step_key(4, 9)))
    assert not torch.equal(once, tsync.sync_gradients(x.clone(), sto, key=philox.step_key(4, 10)))


_X = torch.linspace(-1.0, 1.0, 64)
_ONE = torch.ones(1)
_I8 = CompressionConfig(mode="int8")
_I8_SR = _sto("int8")[1]
_U = torch.linspace(0.0, 0.99, 64)


@pytest.mark.parametrize(
    "call,exc,match",
    [
        (lambda: tq.check_rounding(CompressionConfig(mode="int8", rounding="banker")), ValueError, "banker"),
        (lambda: cq.encode_to_wire(_X, _ONE, CompressionConfig(mode="int8", rounding="banker"), torch.int8), ValueError, "banker"),
        (lambda: cq.fake_quantize_fused(_X, CompressionConfig(mode="float16", rounding="banker")), ValueError, "banker"),
        (lambda: tsync.sync_gradients(_X.clone(), CompressionConfig(mode="int8", rounding="banker")), ValueError, "banker"),
        (lambda: cq.fake_quantize_fused(_X, _I8_SR, key=(1, 2), noise=_U), ValueError, "not both"),
        (lambda: cq.fake_quantize_fused(_X, _I8, noise=_U), ValueError, "nearest"),
        (lambda: cq.encode_to_wire(_X, _ONE, _I8_SR, torch.int8, noise=_U.double()), TypeError, "float32"),
        (lambda: cq.fake_quantize_fused(_X, _I8_SR, noise=torch.zeros(128)[::2]), ValueError, "contiguous"),
        (lambda: cq.fake_quantize_fused(_X, _I8_SR, noise=torch.zeros(63)), ValueError, "shape"),
        (lambda: cq.encode_to_wire(_X, _ONE, _I8_SR, torch.int8, key=(1 << 32, 0)), ValueError, "32-bit"),
        (lambda: cq.encode_to_wire(_X, _ONE, _I8_SR, torch.int8, key=(1, 2), offset=-4), ValueError, "offset"),
        (lambda: cq.encode_to_wire(_X, _ONE, _I8_SR, torch.int8, noise=_U, offset=4), ValueError, "offset"),
        (lambda: tsync.sync_gradients(_X.clone(), _I8_SR, key=1, noise=(_U, _U)), ValueError, "not both"),
        (lambda: philox.stage_key(1, "server"), ValueError, "stage"),
    ],
)
def test_codec_refuses_bad_rounding_inputs(call, exc, match):
    cq.reset_launch_counts()
    with pytest.raises(exc, match=match):
        call()
    assert cq.LAUNCHES == {k: 0 for k in cq.LAUNCHES}


# --- the CLI and the trainer ------------------------------------------------


def _sto_cli_config(tmp_path, seed: int) -> str:
    cfg = {
        "model": {k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()},
        "data": {"image_size": [32, 32], "synthetic_len": 20, "test_split": 4},
        "train": {"epochs": 3, "micro_batch_size": 4, "sync_period": 2,
                  "learning_rate": LR, "seed": seed},
        "compression": {"mode": "int8", "rounding": "stochastic", "codec_backend": "pallas"},
    }
    path = tmp_path / f"sto{seed}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _cli_records(tmp_path, seed: int, run: str) -> list:
    workdir = tmp_path / run
    assert cli_main(["--config", _sto_cli_config(tmp_path, seed), "--device", "cpu",
                     "--workdir", str(workdir), *_OFF]) == 0
    records = [json.loads(line) for line in (workdir / "metrics.jsonl").read_text().splitlines()]
    # Wall-clock keys, the stage means t_<stage>_s and the stream's time
    # stamp among them, vary run to run.
    timing = ("epoch_time_s", "step_time_s", "tiles_per_s", "time")
    return [{k: v for k, v in r.items() if k not in timing and not re.fullmatch(r"t_\w+_s", k)}
            for r in records]


def test_cli_trains_int8_stochastic_on_cpu_and_replays(tmp_path):
    first = _cli_records(tmp_path, 0, "a")
    assert [r["epoch"] for r in first] == [0, 1, 2]
    for r in first:
        assert np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
        assert 0.0 <= r["val_miou"] <= 1.0
    assert _cli_records(tmp_path, 0, "b") == first  # bit-identical replay
    other = _cli_records(tmp_path, 1, "c")
    assert [r["loss"] for r in other] != [r["loss"] for r in first]


@pytest.mark.parametrize(
    "micro,sync,rounding,warns",
    [(128, 2, "stochastic", True), (64, 4, "stochastic", True),
     (127, 2, "stochastic", False), (4, 2, "stochastic", False), (128, 4, "nearest", False)],
)
def test_large_batch_stochastic_warning(micro, sync, rounding, warns):
    cfg = ExperimentConfig.from_dict({
        "model": {k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()},
        "data": {"image_size": [32, 32], "synthetic_len": 20, "test_split": 4,
                 "native_gather": False},
        "train": {"micro_batch_size": micro, "sync_period": sync,
                  "checkpoint_every_epochs": 0, "dump_images_per_epoch": 0,
                  "perf_accounting": False},
        "compression": {"mode": "int8", "rounding": rounding},
    })
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        Trainer(cfg, resume=False, device="cpu")
    hits = [w for w in caught if "global super-batch" in str(w.message)]
    assert len(hits) == int(warns)
    if warns:
        assert f"super-batch {micro * sync} " in str(hits[0].message)
