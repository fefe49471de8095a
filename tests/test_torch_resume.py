"""Resume and preemption of the port's trainer, on the CPU at a tiny size.

- A run of 4 epochs equals 2 epochs, a resume from their checkpoint and 2
  more, bit for bit (every epoch's loss, the params, the Adam ``mu``,
  ``nu`` and ``count``, the BatchNorm statistics, the step), on the fp16
  arm and the int8-stochastic arm (whose rounding keys come from the
  restored step).  Each pair runs in one process: PyTorch's CPU
  convolutions may sum in another order in another process.
- ``request_preempt`` in the middle of an epoch gives an emergency
  checkpoint with its position; ``fit`` returns preempted; the resume
  replays the loader to that step and ends on the uninterrupted run's bits.
- The CLI sent SIGTERM exits 43, and the same command carries on.
- A zero2 gloo world of 2 saves, and its checkpoint resumes into world 2
  zero2 and into world 1 ``off``, the state bit for bit.
- A checkpoint the JAX package wrote resumes in the port, whose next step
  agrees with JAX's next step within the tolerances that
  ``tests/test_torch_train_step.py`` states for a step.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from ddlpc_tpu.config import CompressionConfig as JCompression
from ddlpc_tpu.config import ModelConfig as JModelConfig
from ddlpc_tpu.models import build_model as jbuild_model
from ddlpc_tpu.parallel import train_step as jts
from ddlpc_tpu.train import checkpoint as jckpt
from ddlpc_tpu_torch.config import CompressionConfig, ModelConfig, TrainConfig
from ddlpc_tpu_torch.convert import gather_canonical, load_state_tree
from ddlpc_tpu_torch.models import build_model
from ddlpc_tpu_torch.parallel.train_step import create_train_state, make_train_step
from ddlpc_tpu_torch.resilience.protocol import EXIT_PREEMPTED, read_breadcrumb
from ddlpc_tpu_torch.train import checkpoint as tckpt
from ddlpc_tpu_torch.train.__main__ import parse_args
from ddlpc_tpu_torch.train.optim import build_optimizer
from ddlpc_tpu_torch.train.trainer import Trainer
from test_torch_dist_worker import run_world
from test_torch_model import flax_like_variables
from test_torch_train_step import LR, TINY, _batches, _close, _flat, _params_agree
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OFF = ["--set", "train.dump_images_per_epoch=0", "--set", "train.perf_accounting=False",
       "--set", "data.native_gather=False"]
STOCHASTIC = ("compression.mode=int8", "compression.rounding=stochastic")


@pytest.fixture
def tiny_config(tmp_path) -> str:
    """16 train tiles of 32², micro 4 x sync 2: two steps an epoch."""
    cfg = {
        "model": {k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()},
        "data": {"image_size": [32, 32], "synthetic_len": 20, "test_split": 4},
        "train": {"epochs": 4, "micro_batch_size": 4, "sync_period": 2,
                  "learning_rate": LR, "eval_every_epochs": 2},
        "compression": {"mode": "float16"},
    }
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def make_trainer(config: str, workdir, *sets: str, resume: bool = True) -> Trainer:
    args = ["--config", config, "--device", "cpu", "--workdir", str(workdir), *OFF]
    for s in sets:
        args += ["--set", s]
    cfg, _, device, _ = parse_args(args)
    return Trainer(cfg, resume=resume, device=device)


def records(workdir) -> list:
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "kind" not in r]


def canonical(trainer: Trainer) -> dict:
    sd, adam = gather_canonical(trainer.state)
    out = {f"sd/{k}": v.numpy().copy() for k, v in sd.items()}
    for key in ("mu", "nu"):
        out.update({f"{key}/{k}": v.numpy().copy() for k, v in adam[key].items()})
    out["count"] = adam["count"]
    out["step"] = trainer.state.step
    return out


def assert_same_state(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("stochastic", [False, True], ids=["fp16", "int8_stochastic"])
def test_resume_equals_the_uninterrupted_run(tiny_config, tmp_path, stochastic):
    arm = STOCHASTIC if stochastic else ()
    full = make_trainer(tiny_config, tmp_path / "full", *arm, resume=False)
    full.fit()
    first = make_trainer(tiny_config, tmp_path / "split", "train.epochs=2", *arm)
    assert first.start_epoch == 0
    first.fit()
    assert tckpt.latest_step(first.ckpt_dir) == 4
    second = make_trainer(tiny_config, tmp_path / "split", *arm)
    assert (second.start_epoch, second.state.step, second.state.opt_state.count) == (2, 4, 4)
    second.fit()
    want, got = records(tmp_path / "full"), records(tmp_path / "split")
    assert [r["epoch"] for r in got] == [0, 1, 2, 3]
    for w, g in zip(want, got):
        for key in ("loss", "pixel_acc", "grad_norm", "val_miou"):
            assert w.get(key) == g.get(key), (w["epoch"], key)
    assert_same_state(canonical(full), canonical(second))
    assert read_breadcrumb(str(tmp_path / "split"))["phase"] == "done"
    # Three checkpoints kept, one an epoch, each with its epoch and lineage.
    assert tckpt._steps(second.ckpt_dir) == [4, 6, 8]
    meta = tckpt.peek_metadata(second.ckpt_dir)
    assert meta["epoch"] == 3 and meta["lineage"]["run_id"] == second.run_id


def test_mid_epoch_preemption_resumes_to_the_same_bits(tiny_config, tmp_path):
    full = make_trainer(tiny_config, tmp_path / "full", resume=False)
    full.fit()
    run = make_trainer(tiny_config, tmp_path / "run")
    step, done = run.train_step, []

    def preempting_step(*args):
        out = step(*args)
        done.append(1)
        if len(done) == 3:  # epoch 1, its first of two steps
            run.request_preempt()
        return out

    run.train_step = preempting_step
    run.fit()
    assert run.preempted
    meta = tckpt.peek_metadata(run.ckpt_dir)
    assert (meta["epoch"], meta["step"], meta["mid_epoch_steps_done"], meta["preempted"]) == (0, 3, 1, True)
    crumb = read_breadcrumb(str(tmp_path / "run"))
    assert (crumb["phase"], crumb["epoch"], crumb["steps_done"], crumb["ckpt_step"]) == ("preempted", 1, 1, 3)
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        # The stream stamps every record with its time and schema.
        unstamped = [{k: v for k, v in r.items() if k not in ("time", "schema")}
                     for r in map(json.loads, f)]
    assert {"kind": "preempt", "epoch": 1, "steps_done": 1, "ckpt_step": 3} in unstamped
    again = make_trainer(tiny_config, tmp_path / "run")
    assert (again.start_epoch, again._skip_steps, again.state.step) == (1, 1, 3)
    again.fit()
    assert not again.preempted
    got = records(tmp_path / "run")
    assert [r["epoch"] for r in got] == [0, 1, 2, 3]
    assert got[1]["resumed_mid_epoch_at_step"] == 1
    want = records(tmp_path / "full")
    for e in (0, 2, 3):
        assert got[e]["loss"] == want[e]["loss"], e
    assert_same_state(canonical(full), canonical(again))


def test_corrupt_newest_checkpoint_falls_back(tiny_config, tmp_path):
    make_trainer(tiny_config, tmp_path / "run", "train.epochs=3").fit()
    newest = os.path.join(tmp_path / "run", "checkpoints", "ckpt_6.dwc")
    with open(newest, "r+b") as f:
        f.seek(12)
        b = f.read(1)
        f.seek(12)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.warns(RuntimeWarning, match="quarantined"):
        again = make_trainer(tiny_config, tmp_path / "run")
    assert (again.start_epoch, again.state.step) == (2, 4)
    assert os.path.exists(newest + ".bad")


def test_preemption_joins_the_grace_timer_before_fit_returns(tiny_config, tmp_path):
    """The grace timer's callback holds the trainer: its thread must have
    ended when ``fit`` returns, or it may free the train state while the
    interpreter finalizes and the process aborts (ROADMAP C13)."""
    import threading

    trainer = make_trainer(tiny_config, tmp_path / "run", resume=False)
    trainer.request_preempt()
    timer = trainer._grace_timer
    assert timer is not None and timer.is_alive()
    trainer.fit()
    assert trainer.preempted and trainer._grace_timer is None
    assert not timer.is_alive()
    assert timer not in threading.enumerate()


def test_cli_sigterm_exits_43_and_the_same_command_carries_on(tiny_config, tmp_path):
    workdir = tmp_path / "run"
    argv = [sys.executable, "-m", "ddlpc_tpu_torch.train", "--config", tiny_config,
            "--device", "cpu", "--workdir", str(workdir), *OFF]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(argv + ["--set", "train.epochs=10000"], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120
        metrics = workdir / "metrics.jsonl"
        while not (metrics.exists() and metrics.read_text().count("\n") >= 2):
            assert proc.poll() is None and time.monotonic() < deadline, proc.stderr.read()
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == EXIT_PREEMPTED, err
    crumb = read_breadcrumb(str(workdir))
    assert crumb["phase"] == "preempted"
    meta = tckpt.peek_metadata(str(workdir / "checkpoints"))
    assert meta["preempted"] and meta["step"] == crumb["ckpt_step"]
    last = meta["epoch"]
    r = subprocess.run(argv + ["--set", f"train.epochs={last + 3}"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    epochs = [rec["epoch"] for rec in records(workdir)]
    assert epochs[-2:] == [last + 1, last + 2]
    assert read_breadcrumb(str(workdir))["phase"] == "done"


def test_zero2_world_checkpoint_resumes_into_zero2_and_into_one_off(tiny_config, tmp_path):
    workdir = tmp_path / "world"
    argv = ["--config", tiny_config, "--device", "cpu", "--workdir", str(workdir), *OFF,
            "--set", "train.epochs=2", "--set", "parallel.data_axis_size=2",
            "--set", "train.micro_batch_size=2"]
    outs = run_world("ckpt", 2, str(tmp_path / "w"), {"argv": argv}, {})
    saved = {k[len("saved/"):]: v for k, v in outs[0].items() if k.startswith("saved/")}
    for out in outs:
        assert str(out["level"]) == "zero2" and int(out["start_epoch"]) == 2
        for k, v in saved.items():
            np.testing.assert_array_equal(out[f"saved/{k}"], v, err_msg=k)
            np.testing.assert_array_equal(out[f"restored/{k}"], v, err_msg=k)
    assert int(saved["count"]) == int(saved["step"]) == 4
    # The same blob into a world of one, shard_update resolving to off.
    shutil.copytree(workdir, tmp_path / "one")
    one = make_trainer(tiny_config, tmp_path / "one", "train.epochs=3")
    assert one.shard_update == "off" and one.start_epoch == 2
    assert_same_state({k: np.asarray(v) for k, v in canonical(one).items()},
                      {k: np.asarray(v) for k, v in saved.items()})
    one.fit()
    last = records(tmp_path / "one")[-1]
    assert last["epoch"] == 2 and np.isfinite(last["loss"])


def test_jax_checkpoint_resumes_in_the_port_within_a_step_tolerance(tmp_path):
    """JAX trains a step and checkpoints; both packages then take the next
    step from that checkpoint on the same batch (codec none, fp32)."""
    images, labels = _batches()
    jmodel = jbuild_model(JModelConfig(**TINY))
    tx = optax.adam(LR)
    variables = flax_like_variables(jmodel)
    jstate = jts.TrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree.map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(jax.tree.map(jnp.asarray, variables["params"])),
    )
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jstep = jts.make_train_step(jmodel, tx, mesh, JCompression(mode="none"), donate_state=False)
    jstate, _ = jstep(jstate, jnp.asarray(images[0]), jnp.asarray(labels[0]))
    d = str(tmp_path / "ck")
    jckpt.save_checkpoint(d, jstate, step=1, metadata={"epoch": 0})
    jstate, jm = jstep(jstate, jnp.asarray(images[1]), jnp.asarray(labels[1]))

    tx_t = build_optimizer(TrainConfig(learning_rate=LR))
    state = create_train_state(build_model(ModelConfig(**TINY)), tx_t)
    tree, meta = tckpt.restore_checkpoint(d)
    load_state_tree(state, tree)
    assert (state.step, state.opt_state.count, meta["epoch"]) == (1, 1, 0)
    tm = make_train_step(tx_t, CompressionConfig(mode="none"))(
        state, torch.from_numpy(images[1]), torch.from_numpy(labels[1].astype(np.int64)))
    snap = tckpt.snapshot_state(state).tree()
    opt = snap["opt_state"]["0"]
    adam = jstate.opt_state[0]
    jout = {"params": _flat(jstate.params)}
    tout = {"params": _flat(snap["params"])}
    _params_agree(jout, tout, max_share=1e-3)
    _close(_flat(jstate.batch_stats), _flat(snap["batch_stats"]), 1e-4, 1e-6)
    _close(_flat(adam.mu), _flat(opt["mu"]), 1e-4, 1e-6)
    _close(_flat(adam.nu), _flat(opt["nu"]), 1e-4, 1e-7)
    assert int(opt["count"]) == int(adam.count) == 2 and int(snap["step"]) == 2
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
