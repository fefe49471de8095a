"""Two optimizer steps of the tiny U-Net in the port against the JAX package.

Both sides start from the same seeded weights in the flax layout (carried
over with ``ddlpc_tpu_torch.convert``) and see the same seeded numpy batches
``[A=2, B=4, 32, 32, 3]`` (``sync_period`` 2, some void labels), in fp32
compute.  The JAX side is ``ddlpc_tpu.parallel.train_step.make_train_step``
in ``shard_map`` on a 1-device mesh with ``optax.adam``; the port's side is
its own ``make_train_step``.  Tolerances, each with its reason:

- Adam moments and BatchNorm statistics at rtol 1e-4 / atol 1e-6 (1e-7 for
  ``nu``, whose values are squares of gradients): XLA and PyTorch sum the
  convolutions' reductions in another order (PyTorch's CPU convolutions
  not even in the same order from run to run), which moves each gradient
  by a few fp32 ulps of the sum of its terms.  The losses at rtol 1e-5.
- Params at rtol 1e-4 / atol 1e-6, except for a counted few.  Adam's update
  ``lr·m̂/(sqrt(v̂)+eps)`` is normalized: where a gradient nearly cancels,
  its rounding error is a large share of it and passes to the update
  unshrunk, up to a flipped sign.  Such an element may differ by up to
  ``2·lr`` a step; at most 0.1 % of the elements may.
- fp16 codec (100 levels, the flagship's): the same, except that the codec
  snaps each gradient to a lattice of step absmax/100, and where the two
  sides' gradients straddle a lattice midpoint they snap to neighbouring
  points, a flip that moves the update by up to ``lr``.  So up to 2 % of the
  params may differ, by up to ``2·lr`` a step; the losses agree at rtol 1e-4.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from ddlpc_tpu.config import CompressionConfig as JCompression
from ddlpc_tpu.config import ModelConfig as JModelConfig
from ddlpc_tpu.data import datasets as jdatasets
from ddlpc_tpu.models import build_model as jbuild_model
from ddlpc_tpu.parallel import train_step as jts
from ddlpc_tpu_torch.config import CompressionConfig, ModelConfig, TrainConfig
from ddlpc_tpu_torch.convert import flax_from_torch, torch_state_from_flax
from ddlpc_tpu_torch.models import build_model
from ddlpc_tpu_torch.parallel.train_step import create_train_state, make_train_step
from ddlpc_tpu_torch.train.__main__ import main as cli_main
from ddlpc_tpu_torch.train.optim import Adam, build_optimizer
from test_torch_model import flax_like_variables

LR = 2e-3
FLAGSHIP = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "vaihingen_unet_tpu_flagship.json",
)
TINY = dict(
    features=(8, 16), bottleneck_features=16, width_divisor=1, stem="s2d",
    stem_factor=2, detail_head=True, num_classes=6,
    compute_dtype="float32", head_dtype="float32",
)


def _batches(n_steps: int = 2):
    ds = jdatasets.SyntheticTiles(num_tiles=8 * n_steps, image_size=(32, 32), seed=0)
    labels = ds.labels.copy()
    labels[:, :3, :5] = -1  # void pixels
    images = ds.images.reshape(n_steps, 2, 4, 32, 32, 3)
    return images, labels.reshape(n_steps, 2, 4, 32, 32)


def _flat(tree) -> dict:
    return {
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_leaves_with_path(tree)
    }


def _run_both(mode: str):
    """Two steps on each side; returns ``(jax_out, torch_out)`` with flat
    ``params``, ``batch_stats``, ``mu``, ``nu`` dicts and the losses."""
    images, labels = _batches()
    jmodel = jbuild_model(JModelConfig(**TINY))
    tx = optax.adam(LR)
    variables = flax_like_variables(jmodel)
    params0, stats0 = variables["params"], variables["batch_stats"]
    jstate = jts.TrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree.map(jnp.asarray, params0),
        batch_stats=jax.tree.map(jnp.asarray, stats0),
        opt_state=tx.init(jax.tree.map(jnp.asarray, params0)),
    )
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jstep = jts.make_train_step(
        jmodel, tx, mesh, JCompression(mode=mode), donate_state=False
    )
    jlosses = []
    for x, y in zip(images, labels):
        jstate, m = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        jlosses.append(float(m["loss"]))
    adam = jstate.opt_state[0]
    jout = {
        "params": _flat(jstate.params),
        "batch_stats": _flat(jstate.batch_stats),
        "mu": _flat(adam.mu),
        "nu": _flat(adam.nu),
        "count": int(adam.count),
        "losses": jlosses,
    }

    tmodel = build_model(ModelConfig(**TINY))
    sd, _ = torch_state_from_flax(params0, stats0)
    tmodel.load_state_dict(sd, strict=True)
    ttx = build_optimizer(TrainConfig(learning_rate=LR))
    state = create_train_state(tmodel, ttx)
    tstep = make_train_step(ttx, CompressionConfig(mode=mode))
    tlosses = []
    for x, y in zip(images, labels):
        m = tstep(state, torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)))
        tlosses.append(float(m["loss"]))
    opt = state.opt_state
    p, s, o = flax_from_torch(
        tmodel.state_dict(),
        {
            "count": opt.count,
            "mu": state.params.named_views(opt.mu),
            "nu": state.params.named_views(opt.nu),
        },
    )
    tout = {
        "params": _flat(p), "batch_stats": _flat(s), "mu": _flat(o["mu"]),
        "nu": _flat(o["nu"]), "count": int(o["count"]), "losses": tlosses,
    }
    assert state.step == 2
    return jout, tout


@pytest.fixture(scope="module")
def codec_none():
    return _run_both("none")


def _close(want: dict, got: dict, rtol: float, atol: float) -> None:
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].shape == got[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def _params_agree(jout: dict, tout: dict, max_share: float) -> None:
    """Params within rtol 1e-4 / atol 1e-6 but for at most ``max_share`` of
    the elements, which stay within ``2·lr`` a step (module docstring)."""
    total = off = 0
    for k, want in jout["params"].items():
        diff = np.abs(tout["params"][k] - want)
        off += int((diff > 1e-4 * np.abs(want) + 1e-6).sum())
        total += want.size
        assert diff.max() <= 2 * 2 * LR, (k, diff.max())
    assert off <= max_share * total, (off, total)


@pytest.mark.parametrize(
    "part,rtol,atol",
    [("params", None, None), ("batch_stats", 1e-4, 1e-6), ("mu", 1e-4, 1e-6),
     ("nu", 1e-4, 1e-7)],
)
def test_two_steps_codec_none_match_jax(codec_none, part, rtol, atol):
    jout, tout = codec_none
    if part == "params":
        _params_agree(jout, tout, max_share=1e-3)
    else:
        _close(jout[part], tout[part], rtol, atol)
    assert jout["count"] == tout["count"] == 2
    np.testing.assert_allclose(tout["losses"], jout["losses"], rtol=1e-5)
    # The step really moved the weights.
    assert max(np.abs(v).max() for v in jout["mu"].values()) > 0


def test_adam_matches_optax():
    """The port's Adam against ``optax.adam`` on the same flat numbers, over
    three steps.  The moments are bit-exact.  The params within 2 fp32 ulps:
    XLA's fp32 ``pow`` in the bias correction ``1 − b**t`` rounds 1 ulp away
    from PyTorch's at some counts, which moves the update by about as much."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(257,)).astype(np.float32)
    grads = [rng.normal(size=(257,)).astype(np.float32) * 10.0 ** -k for k in range(3)]
    grads[1][:5] = 0.0
    tx = optax.adam(LR)
    jp, js = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    adam = Adam(LR)
    tp = torch.from_numpy(p0.copy())
    ts = adam.init(tp)
    for g in grads:
        u, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, u)
        adam.update(torch.from_numpy(g), ts, tp)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=2.4e-7, atol=0)
        np.testing.assert_array_equal(ts.mu.numpy(), np.asarray(js[0].mu))
        np.testing.assert_array_equal(ts.nu.numpy(), np.asarray(js[0].nu))
    assert ts.count == int(js[0].count) == 3


def test_build_optimizer_rejects_what_is_not_ported():
    for bad in (
        dict(optimizer="sgd"), dict(lr_schedule="cosine"), dict(warmup_steps=5),
        dict(weight_decay=1e-4), dict(grad_clip_norm=1.0),
    ):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            build_optimizer(TrainConfig(**bad))


def _tiny_cli_config(tmp_path) -> str:
    cfg = {
        "model": {k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()},
        "data": {"image_size": [32, 32], "synthetic_len": 20, "test_split": 4},
        "train": {"epochs": 2, "micro_batch_size": 4, "sync_period": 2,
                  "learning_rate": LR},
        "compression": {"mode": "float16"},
    }
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(cfg))
    return str(path)


_OFF = [
    "--set", "train.checkpoint_every_epochs=0",
    "--set", "train.dump_images_per_epoch=0",
    "--set", "train.perf_accounting=False",
    "--set", "data.native_gather=False",
]


def test_cli_trains_tiny_config_on_cpu(tmp_path, capsys):
    cfg = _tiny_cli_config(tmp_path)
    workdir = tmp_path / "run"
    rc = cli_main(["--config", cfg, "--device", "cpu", "--workdir", str(workdir), *_OFF])
    assert rc == 0
    records = [json.loads(line) for line in (workdir / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0, 1]
    for r in records:
        assert np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
        assert 0.0 <= r["val_miou"] <= 1.0 and len(r["val_iou_per_class"]) == 6
    # 16 train tiles, super-batch 8: two optimizer steps per epoch.
    assert records[0]["tiles_per_s"] > 0
    assert "val_miou" in capsys.readouterr().out


def test_cli_raises_without_cuda_unless_cpu_is_asked_for(tmp_path, monkeypatch):
    cfg = _tiny_cli_config(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli_main(["--config", cfg, "--workdir", str(tmp_path / "run"), *_OFF])
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli_main(["--config", cfg, "--device", "cuda", "--workdir", str(tmp_path / "run"), *_OFF])


def test_cli_refuses_settings_that_are_not_ported(tmp_path):
    """The flagship as it stands enables checkpoints, image dumps and the
    device cache: the trainer names each ``--set`` that switches one off."""
    with pytest.raises(NotImplementedError) as e:
        cli_main(["--config", FLAGSHIP,
                  "--device", "cpu", "--workdir", str(tmp_path / "run")])
    msg = str(e.value)
    for key in ("train.checkpoint_every_epochs=0", "train.dump_images_per_epoch=0",
                "data.device_cache=False", "data.native_gather=False"):
        assert f"--set {key}" in msg
    with pytest.raises(KeyError, match="unknown config key"):
        cli_main(["--device", "cpu", "--set", "train.no_such_knob=1"])
