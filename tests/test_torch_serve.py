"""The port's serving engine against the JAX package's, on the CPU.

A JAX run directory (``scripts.serve_bench.make_tiny_run``: 32² tiles,
U-Net features (8, 16), 4 classes) is restored by both engines, and the
same seeded numpy windows and scenes go through both.

Tolerances, each with its reason:

- tiling (``window_plan``, ``Stitcher``, ``_blend_window``, ``_bucket``):
  bit for bit — the same numpy arithmetic;
- logits of a run computing in fp32 (the run's ``config.json`` with
  ``model.compute_dtype`` float32; the checkpoint's params are fp32
  either way): rtol/atol 1e-5, the same operations summed in another order
  by XLA and by PyTorch (``tests/test_torch_model.py``); the int8 and bf16
  engines run the same dequantized weights, so the same bound holds;
- logits of the run as written (bf16 compute, the flagship's dtype):
  max |Δlogit| ≤ 5e-2 · max |logit|, as ``tests/test_torch_model.py``
  argues for bf16;
- the quantized weights (int8 ``q`` and scale of every leaf, bf16 leaves):
  bit for bit.
"""

import glob
import json
import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from ddlpc_tpu.config import ServeConfig as JServeConfig
from ddlpc_tpu.serve import engine as jengine
from ddlpc_tpu.serve import quantized as jquantized
from ddlpc_tpu.serve.server import ServingFrontend as JFrontend
from ddlpc_tpu_torch.config import ServeConfig
from ddlpc_tpu_torch.convert import _flatten, _kernel_to_torch, flax_param_path
from ddlpc_tpu_torch.serve import engine as tengine
from ddlpc_tpu_torch.serve import quantized as tquantized
from ddlpc_tpu_torch.serve.server import ServingFrontend
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

TILE = 32
NCLASS = 4


def write_run(workdir, seed=0, step=1, compute_dtype="float32"):
    """A JAX run directory; ``compute_dtype`` rewrites its config (the
    checkpoint's fp32 params serve either dtype)."""
    from scripts.serve_bench import make_tiny_run

    make_tiny_run(workdir, tile=TILE, num_classes=NCLASS, seed=seed, step=step)
    path = os.path.join(workdir, "config.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["model"]["compute_dtype"] = compute_dtype
    with open(path, "w") as f:
        json.dump(cfg, f)
    return workdir


def engines(workdir, quantize="off", max_bucket=8):
    return (
        jengine.InferenceEngine.from_workdir(workdir, max_bucket=max_bucket, echo=False,
                                             quantize=quantize),
        tengine.InferenceEngine.from_workdir(workdir, max_bucket=max_bucket, echo=False,
                                             quantize=quantize, device="cpu"),
    )


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    return write_run(str(tmp_path_factory.mktemp("serve_run")))


def windows(n, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, TILE, TILE, 3)).astype(np.float32)


# ---- tiling -----------------------------------------------------------------


@pytest.mark.parametrize("hw", [(20, 13), (32, 32), (70, 45), (31, 100), (96, 64)])
@pytest.mark.parametrize("overlap", [0.0, 0.25, 0.5])
def test_window_plan_and_stitcher_equal_jax_bit_for_bit(hw, overlap):
    rng = np.random.default_rng(hw[0] * 100 + hw[1])
    image = rng.uniform(0, 1, (*hw, 3)).astype(np.float32)
    jp, jo, jhw = jengine.window_plan(image, (TILE, TILE), overlap)
    tp, to, thw = tengine.window_plan(image, (TILE, TILE), overlap)
    assert jo == to and jhw == thw
    assert jp.tobytes() == tp.tobytes() and jp.shape == tp.shape
    logits = rng.normal(size=(len(jo), TILE, TILE, NCLASS)).astype(np.float32)
    want = jengine.stitch_windows(jo, logits, (TILE, TILE), jp.shape[:2], jhw)
    got = tengine.stitch_windows(to, logits, (TILE, TILE), tp.shape[:2], thw)
    assert want.tobytes() == got.tobytes() and got.shape == (*hw, NCLASS)


@pytest.mark.parametrize("tile", [(32, 32), (7, 12), (1, 1)])
def test_blend_window_equals_jax_bit_for_bit(tile):
    assert jengine._blend_window(tile).tobytes() == tengine._blend_window(tile).tobytes()


@pytest.mark.parametrize("cap", [1, 5, 6, 8, 12])
def test_bucket_equals_jax_with_non_power_of_two_caps(cap):
    got = [tengine._bucket(n, cap) for n in range(1, 2 * cap + 1)]
    assert got == [jengine._bucket(n, cap) for n in range(1, 2 * cap + 1)]
    assert max(got) == cap


def test_window_plan_refuses_a_negative_overlap_as_jax():
    image = np.zeros((40, 40, 3), np.float32)
    for mod in (jengine, tengine):
        with pytest.raises(ValueError, match="overlap"):
            mod.window_plan(image, (TILE, TILE), -0.1)


# ---- fp32 logits ------------------------------------------------------------


@pytest.mark.parametrize("quantize", ["off", "int8", "bf16"])
def test_forward_windows_and_scene_logits_equal_jax(run_dir, quantize):
    """n = 1, 3, 5 and 9 (above max_bucket) windows and a ragged scene, then
    the bucket cache's keys and hit/miss counts after the same calls."""
    from ddlpc_tpu.obs.registry import MetricsRegistry as JRegistry
    from ddlpc_tpu_torch.obs.registry import MetricsRegistry

    je, te = engines(run_dir, quantize)
    jreg, treg = JRegistry(), MetricsRegistry()
    je.attach_registry(jreg)
    te.attach_registry(treg)
    for n in (1, 3, 5, 9):
        x = windows(n, seed=n)
        want, got = je.forward_windows(x), te.forward_windows(x)
        assert got.dtype == np.float32 and got.shape == (n, TILE, TILE, NCLASS)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    scene = np.random.default_rng(9).uniform(0, 1, (70, 45, 3)).astype(np.float32)
    np.testing.assert_allclose(te.predict_logits(scene, batch=3),
                               je.predict_logits(scene, batch=3), rtol=1e-5, atol=1e-5)
    assert te.compiled_shapes == je.compiled_shapes >= 3
    assert te.forward_calls == je.forward_calls
    for name in ("ddlpc_serve_jit_cache_hits_total", "ddlpc_serve_jit_cache_misses_total"):
        assert treg.get(name)._series == jreg.get(name)._series, name
    assert te.hbm_bytes() == je.hbm_bytes()


def test_logits_of_the_run_as_written_within_bf16_rounding(tmp_path):
    d = write_run(str(tmp_path / "run"), compute_dtype="bfloat16")
    je, te = engines(d)
    x = windows(3, seed=11)
    want, got = je.forward_windows(x), te.forward_windows(x)
    assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()


def test_sliding_window_logits_pads_the_tail_as_jax(run_dir):
    je, te = engines(run_dir)
    scene = np.random.default_rng(5).uniform(0, 1, (48, 40, 3)).astype(np.float32)
    want = jengine.sliding_window_logits(
        lambda s, w: je.forward_windows(w), None, scene, (TILE, TILE), 0.25, 4)
    got = tengine.sliding_window_logits(
        lambda s, w: te.forward_windows(w), None, scene, (TILE, TILE), 0.25, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    pred = te.predict_classes(scene, overlap=0.25, batch=4)
    assert pred.shape == (48, 40) and pred.dtype == np.int32


def test_warmup_runs_every_bucket_as_jax(run_dir):
    je, te = engines(run_dir, max_bucket=6)
    assert te.warmup() == je.warmup() == 4


# ---- quantized states -------------------------------------------------------


def _jax_leaf(tree, path):
    flat = _flatten(tree)
    return np.asarray(flat[path])


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quantized_state_equals_jax_bit_for_bit(run_dir, mode):
    """Every param leaf (conv kernels and biases, BatchNorm's weight and
    bias) quantized to JAX's bits with JAX's scale; the BatchNorm running
    statistics untouched and fp32."""
    je, te = engines(run_dir, mode)
    jq = jquantized.quantize_state(je.state, mode)
    tq = te.qstate
    assert set(tq.params) == set(te.state.params)
    names = {n for n in tq.params if n.endswith(("weight", "bias"))}
    assert any(".BatchNorm_0.weight" in n for n in names)  # flax's BN 'scale'
    for name, q in tq.params.items():
        path = flax_param_path(name, q.dim())
        want = _jax_leaf(jq.params, path)
        if path[-1] == "kernel":
            want = _kernel_to_torch(path, want)
        want = np.ascontiguousarray(want)
        if mode == "int8":
            assert q.dtype == torch.int8
            assert q.numpy().tobytes() == want.astype(np.int8).tobytes(), name
        else:
            assert q.dtype == torch.bfloat16
            assert q.view(torch.int16).numpy().tobytes() == want.view(np.int16).tobytes(), name
        scale = np.float32(_jax_leaf(jq.scales, path))
        assert tq.scales[name].numpy().tobytes() == scale.reshape(1).tobytes(), name
    for name, v in tq.batch_stats.items():
        assert v.dtype == torch.float32
        assert torch.equal(v, te.state.batch_stats[name]), name
    assert set(tq.batch_stats) == {n for n in tq.batch_stats if n.endswith(("running_mean", "running_var"))}
    assert tquantized.state_nbytes(tq) == jquantized.state_nbytes(jq)


def test_dequantized_weights_equal_jax_bit_for_bit(run_dir):
    je, te = engines(run_dir, "int8")
    jq = jquantized.quantize_state(je.state, "int8")
    jdeq = jquantized.dequantize_params(jq.params, jq.scales, "int8")
    for name, w in tquantized.dequantize_params(te.qstate, "int8").items():
        path = flax_param_path(name, w.dim())
        want = _jax_leaf(jdeq, path)
        if path[-1] == "kernel":
            want = _kernel_to_torch(path, want)
        assert w.numpy().tobytes() == np.ascontiguousarray(want, np.float32).tobytes(), name


def test_quantized_mode_is_refused_as_jax(run_dir):
    for mod in (jquantized, tquantized):
        with pytest.raises(ValueError, match="quantization mode"):
            mod.check_mode("fp4")
        assert mod.quantize_error_bound("int8") == 0.5 / 127.0
    with pytest.raises(ValueError, match="quantization mode"):
        tengine.InferenceEngine.from_workdir(run_dir, echo=False, quantize="fp4", device="cpu")


def test_activation_quantization_equals_jax(run_dir):
    j = jengine.InferenceEngine.from_workdir(run_dir, echo=False, quantize="bf16",
                                             quantize_activations=True)
    t = tengine.InferenceEngine.from_workdir(run_dir, echo=False, quantize="bf16",
                                             quantize_activations=True, device="cpu")
    x = windows(2, seed=13)
    np.testing.assert_allclose(t.forward_windows(x), j.forward_windows(x), rtol=1e-5, atol=1e-5)


# ---- hot reload -------------------------------------------------------------


@pytest.mark.parametrize("quantize", ["off", "int8"])
def test_reload_swaps_to_the_same_weights_as_jax(tmp_path, quantize):
    d = write_run(str(tmp_path / "run"), seed=0, step=1)
    je, te = engines(d, quantize)
    x = windows(2, seed=3)
    before = te.forward_windows(x)
    write_run(d, seed=7, step=2)
    jmeta, tmeta = je.reload(), te.reload()
    assert tmeta["step"] == jmeta["step"] == 2
    assert tmeta["restore_format"] == jmeta["restore_format"] == "chunked"
    assert tmeta.get("quantize") == jmeta.get("quantize")
    assert te.version == je.version == 1
    assert te.checkpoint_step == je.checkpoint_step == 2
    assert te.lineage == je.lineage and te.lineage["step"] == 2
    after = te.forward_windows(x)
    assert not np.allclose(before, after)
    np.testing.assert_allclose(after, je.forward_windows(x), rtol=1e-5, atol=1e-5)


def test_hot_reload_mid_stream_never_errors(tmp_path):
    """Params swap mid-stream; every request completes with the old
    params' answer or the new — never an error, never a mix (the JAX
    package's test of the same name, against the port's engine)."""
    d = write_run(str(tmp_path / "run"), seed=0, step=1)
    eng = tengine.InferenceEngine.from_workdir(d, echo=False, device="cpu")
    x = windows(1, seed=4)
    ref_old = eng.forward_windows(x)
    write_run(d, seed=7, step=2)
    cfg = ServeConfig(max_batch=2, max_wait_ms=2.0, queue_limit=256, deadline_ms=0.0)
    frontend = ServingFrontend(eng, cfg)
    errors, outputs = [], []
    lock = threading.Lock()

    def client():
        for _ in range(6):
            try:
                out = frontend.batcher.submit(x[0]).result(timeout=30)
            except Exception as e:  # noqa: BLE001 — the test asserts none
                with lock:
                    errors.append(e)
            else:
                with lock:
                    outputs.append(np.asarray(out))

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.01)
    eng.reload()
    for t in threads:
        t.join()
    frontend.close()
    ref_new = eng.forward_windows(x)
    assert errors == []
    assert len(outputs) == 24
    for out in outputs:
        ok_old = np.allclose(out, ref_old[0], atol=1e-5)
        ok_new = np.allclose(out, ref_new[0], atol=1e-5)
        assert ok_old or ok_new
    assert eng.version == 1


def test_quantized_reload_corrupt_blob_falls_back(tmp_path):
    """A corrupt newest checkpoint under an int8 engine: the reader
    quarantines it, the engine restores the older step and keeps serving,
    still quantized — as the JAX engine does."""
    d = write_run(str(tmp_path / "run"), seed=0, step=1)
    je, te = engines(d, "int8")
    write_run(d, seed=7, step=2)
    blob = [b for b in glob.glob(os.path.join(d, "checkpoints", "ckpt_2.*")) if not b.endswith(".json")][0]
    data = bytearray(open(blob, "rb").read())
    data[len(data) // 2] ^= 0xFF
    with open(blob, "wb") as f:
        f.write(data)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        meta = te.reload()
    assert meta.get("step") == 1 and meta.get("quarantined_steps") == [2]
    assert meta["quantize"] == "int8" and te.version == 1
    x = windows(1, seed=4)
    np.testing.assert_allclose(te.forward_windows(x), je.forward_windows(x), rtol=1e-5, atol=1e-5)


def test_frontend_reload_failure_keeps_serving_like_jax(tmp_path):
    d = write_run(str(tmp_path / "run"))
    je, te = engines(d)
    jf, tf = JFrontend(je, JServeConfig()), ServingFrontend(te, ServeConfig())
    try:
        jres = jf.reload(workdir=str(tmp_path / "nowhere"))
        tres = tf.reload(workdir=str(tmp_path / "nowhere"))
        assert tres["error_type"] == jres["error_type"] == "FileNotFoundError"
        assert set(tres) == set(jres)
        assert tf.healthz()["last_reload_error"] is not None
    finally:
        jf.close()
        tf.close()


# ---- grad mode on the batcher's threads ---------------------------------------


def test_forward_on_a_worker_thread_runs_without_grad(run_dir):
    """Grad mode is per thread: the forward enters inference mode itself,
    on whichever thread the batcher runs it, and keeps no graph."""
    te = tengine.InferenceEngine.from_workdir(run_dir, echo=False, device="cpu")
    seen = {}
    orig = te._run

    def spy(state, chunk):
        seen["grad"] = torch.is_grad_enabled()
        seen["inference"] = torch.is_inference_mode_enabled()
        out = te.device_logits(state, torch.from_numpy(np.ascontiguousarray(chunk)))
        seen["graph"] = out.grad_fn is not None or out.requires_grad
        seen["training"] = te._skeleton().training
        return orig(state, chunk)

    te._run = spy
    torch.set_grad_enabled(True)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("y", te.forward_windows(windows(2))))
    t.start()
    t.join()
    assert out["y"].shape == (2, TILE, TILE, NCLASS)
    assert seen == {"grad": False, "inference": True, "graph": False, "training": False}


def test_forward_calls_count_every_chunk_across_threads(run_dir):
    """The batcher's slots call forward_windows concurrently; every
    bucket-sized chunk counts once (5 windows at bucket 2: 3 chunks)."""
    te = tengine.InferenceEngine.from_workdir(run_dir, max_bucket=2, echo=False, device="cpu")
    x = windows(5)

    def client():
        for _ in range(5):
            te.forward_windows(x)

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert te.forward_calls == 4 * 5 * 3


def test_engine_runs_on_the_card_unless_the_caller_asks_for_cpu(run_dir):
    """The constructor's device defaults to CUDA, as from_workdir's does,
    and raises without it rather than serve from the CPU unasked."""
    te = tengine.InferenceEngine.from_workdir(run_dir, echo=False, device="cpu")
    args = (te.cfg, te.model, te._state, te.channels)
    assert tengine.InferenceEngine(*args, device="cpu").device == torch.device("cpu")
    if torch.cuda.is_available():
        assert tengine.InferenceEngine(*args).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tengine.InferenceEngine(*args)


def test_a_port_run_serves_in_both_packages(tmp_path):
    """The port's trainer writes its run's config.json beside its
    checkpoints, as the JAX trainer does: the port's engine and JAX's
    restore the port's run and answer alike."""
    from test_torch_watchdog import _tiny_config

    from ddlpc_tpu_torch.train.__main__ import parse_args
    from ddlpc_tpu_torch.train.trainer import Trainer

    run = str(tmp_path / "run")
    cfg, _, device, _ = parse_args([
        "--config", _tiny_config(tmp_path, checkpoint_every_epochs=1), "--device", "cpu",
        "--workdir", run,
    ])
    Trainer(cfg, resume=False, device=device).fit()
    from ddlpc_tpu.config import ExperimentConfig as JExperimentConfig
    from ddlpc_tpu_torch.config import ExperimentConfig

    with open(os.path.join(run, "config.json")) as f:
        text = f.read()
    assert ExperimentConfig.from_json(text) == cfg
    assert json.loads(JExperimentConfig.from_json(text).to_json()) == json.loads(text)
    je, te = engines(run)
    assert te.channels == je.channels == 3
    assert te.checkpoint_step == je.checkpoint_step == 4  # one epoch of 4 steps
    x = np.random.default_rng(0).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    np.testing.assert_allclose(te.forward_windows(x), je.forward_windows(x), rtol=1e-5, atol=1e-5)
