"""The port's stall watchdog (``ddlpc_tpu_torch/train/watchdog.py``) against
the JAX package's (``tests/test_watchdog.py``, case for case), then wired
into the trainer: a data fetch that stalls in the second batch is
diagnosed in ``stall.log`` with the phase ``data``, leaves the ``stalled``
breadcrumb, and under ``stall_action='abort'`` ends the process with 42.
Times: timeouts of 0.2–0.4 s against waits of up to 5 s.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

from ddlpc_tpu.train.watchdog import StallWatchdog as JStallWatchdog
from ddlpc_tpu_torch.resilience.protocol import EXIT_STALL, read_breadcrumb
from ddlpc_tpu_torch.train.watchdog import StallWatchdog
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wait(cond, seconds: float = 5.0) -> None:
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.05)


@pytest.mark.parametrize("cls", [StallWatchdog, JStallWatchdog], ids=["port", "jax"])
def test_fires_on_stall_with_tag_and_log(cls, tmp_path):
    log = tmp_path / "stall.log"
    fired = []
    wd = cls(timeout_s=0.3, log_path=str(log), on_stall=lambda age, tag: fired.append((age, tag)))
    with wd:
        wd.beat("step")
        _wait(lambda: fired)
    assert fired, "watchdog never fired on a stalled heartbeat"
    age, tag = fired[0]
    assert age >= 0.3 and tag == "step"
    text = log.read_text()
    assert "no heartbeat" in text and "last phase: 'step'" in text
    assert "Thread" in text or "File" in text  # faulthandler's stacks


def test_beating_prevents_firing():
    fired = []
    wd = StallWatchdog(timeout_s=0.4, on_stall=lambda a, t: fired.append(a))
    with wd:
        for _ in range(15):
            wd.beat("loop")
            time.sleep(0.05)
    assert not fired and wd.stall_count == 0


def test_abort_action_calls_exit_with_status(tmp_path):
    exits = []
    wd = StallWatchdog(timeout_s=0.2, action="abort", log_path=str(tmp_path / "s.log"),
                       _exit=exits.append)
    with wd:
        _wait(lambda: exits)
    assert exits and exits[0] == EXIT_STALL == 42


def test_disabled_when_timeout_nonpositive():
    wd = StallWatchdog(timeout_s=0.0)
    with wd:
        assert wd._thread is None


def test_unknown_action_rejected():
    with pytest.raises(ValueError, match="action"):
        StallWatchdog(timeout_s=1.0, action="restart")


def test_dump_mode_rearms_instead_of_spamming():
    fired = []
    wd = StallWatchdog(timeout_s=0.2, on_stall=lambda a, t: fired.append(a))
    with wd:
        time.sleep(0.55)  # about two windows after the re-arm
    assert 1 <= len(fired) <= 3


def test_paused_suppresses_firing_and_rearms():
    fired = []
    wd = StallWatchdog(timeout_s=0.25, on_stall=lambda a, t: fired.append(t))
    with wd:
        with wd.paused("checkpoint"):
            time.sleep(0.7)  # well past the timeout: must not fire
        assert not fired
        _wait(lambda: fired)
    assert fired and fired[0] == "after_checkpoint"


def _tiny_config(tmp_path, **train) -> str:
    cfg = {
        "model": {"features": [8], "bottleneck_features": 8, "num_classes": 3,
                  "compute_dtype": "float32", "head_dtype": "float32"},
        "data": {"image_size": [32, 32], "synthetic_len": 12, "test_split": 4,
                 "num_classes": 3},
        "train": {"epochs": 1, "micro_batch_size": 1, "sync_period": 2,
                  "dump_images_per_epoch": 0, "checkpoint_every_epochs": 0, **train},
    }
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_trainer_runs_with_watchdog_armed(tmp_path):
    """A short run with a generous timeout trains, fires nothing and stops
    the watchdog's thread on exit."""
    from ddlpc_tpu_torch.train.__main__ import parse_args
    from ddlpc_tpu_torch.train.trainer import Trainer

    cfg, _, device, _ = parse_args([
        "--config", _tiny_config(tmp_path, stall_timeout_s=300.0), "--device", "cpu",
        "--workdir", str(tmp_path / "run"),
    ])
    trainer = Trainer(cfg, resume=False, device=device)
    rec = trainer.fit()
    assert rec["loss"] == rec["loss"]
    assert trainer.watchdog.stall_count == 0
    assert trainer.watchdog._thread is None


# A training process whose loader sleeps in its second batch, stalled by
# this test's script; the package itself has no fault hook.
_STALLING = textwrap.dedent("""
    import sys, time
    from ddlpc_tpu_torch.train.__main__ import parse_args
    from ddlpc_tpu_torch.train.trainer import Trainer

    cfg, _, device, _ = parse_args(sys.argv[1:])
    trainer = Trainer(cfg, resume=False, device=device)

    class Stalling(type(trainer.loader)):
        def __iter__(self):
            for i, batch in enumerate(super().__iter__()):
                if i == 1:
                    time.sleep({sleep})
                yield batch

    trainer.loader.__class__ = Stalling
    trainer.fit()
    print("FIT RETURNED", trainer.watchdog.stall_count, flush=True)
""")


def _stalling_run(tmp_path, action: str, sleep: float) -> subprocess.CompletedProcess:
    workdir = tmp_path / "run"
    config = _tiny_config(tmp_path, stall_timeout_s=1.0, stall_action=action)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-c", _STALLING.format(sleep=sleep), "--config", config,
         "--device", "cpu", "--workdir", str(workdir)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    return r


def test_stalled_data_fetch_exits_42_with_stall_log_and_breadcrumb(tmp_path):
    r = _stalling_run(tmp_path, "abort", sleep=6.0)
    assert r.returncode == EXIT_STALL, (r.stdout, r.stderr)
    assert "FIT RETURNED" not in r.stdout
    workdir = str(tmp_path / "run")
    crumb = read_breadcrumb(workdir)
    assert crumb["phase"] == "stalled" and crumb["stall_tag"] == "data"
    assert crumb["stall_age_s"] >= 1.0
    with open(os.path.join(workdir, "stall.log")) as f:
        assert "last phase: 'data'" in f.read()


def test_stalled_data_fetch_in_dump_mode_diagnoses_and_finishes(tmp_path):
    r = _stalling_run(tmp_path, "dump", sleep=2.5)
    assert r.returncode == 0, r.stderr
    assert "FIT RETURNED" in r.stdout
    assert int(r.stdout.split("FIT RETURNED")[1].split()[0]) >= 1
    assert read_breadcrumb(str(tmp_path / "run"))["phase"] == "done"
    with open(tmp_path / "run" / "stall.log") as f:
        assert "last phase: 'data'" in f.read()
