"""The trainer's observability in processes of its own, on the CPU.

- A live CLI fit: a scrape of its ``/metrics`` shows the ``loss`` gauge,
  ``/healthz`` names the process, SIGUSR2 arms the on-demand profiler and
  ``top_ops_001.json`` lands in the workdir, ``/debug/trace?steps=1`` arms
  the next capture; SIGTERM then preempts it (exit 43).
- A 2-rank gloo world (``parallel/mesh.py:spawn_world``) on the
  int8-stochastic arm under ``train.trace``: every rank samples the fenced
  comm probe, rank 0's ``kind="comm"`` records carry ``comm_s_per_step > 0``
  and ``0 <= comm_fraction <= 1`` (and the ``probe`` debit), and the losses
  equal the untraced twin's bit for bit — the probe's rounding draws from
  its own key, never from the training step's.  The JAX package's
  ``tests/test_perf_accounting.py::test_trainer_publishes_accounting_and_debits_reconcile``
  holds the same for its trainer.  Where one rank cannot make the probe's
  gradient, the whole world drops the probe and trains on.
"""

import json
import os
import re
import signal
import struct
import subprocess
import sys
import time
import urllib.request

import pytest

from test_torch_dist_worker import run_world
from test_torch_train_step import _tiny_cli_config
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXIT_PREEMPTED = 43


def _wait(what: str, pred, timeout: float = 120.0, every: float = 0.1):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(every)
    raise AssertionError(f"timed out waiting for {what}")


def _get(port: int, path: str, accept: str = None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers={"Accept": accept} if accept else {})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.read().decode()


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    """A CLI fit of many tiny epochs with the telemetry endpoint on an
    ephemeral port, running until the module's tests are done."""
    root = tmp_path_factory.mktemp("live")
    workdir = root / "run"
    out = open(root / "stdout.txt", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ddlpc_tpu_torch.train", "--config", _tiny_cli_config(root),
         "--device", "cpu", "--no-resume", "--workdir", str(workdir),
         "--set", "train.epochs=100000", "--set", "train.telemetry_port=0",
         "--set", "train.profile_steps=2", "--set", "train.checkpoint_every_epochs=0",
         "--set", "train.dump_images_per_epoch=0", "--set", "data.native_gather=False"],
        cwd=REPO, stdout=out, stderr=subprocess.STDOUT,
        env=dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO),
    )

    def port():
        m = re.search(r"\[telemetry\] http://127\.0\.0\.1:(\d+)", (root / "stdout.txt").read_text())
        return int(m.group(1)) if m else None

    def records():
        path = workdir / "metrics.jsonl"
        return path.is_file() and [json.loads(x) for x in path.read_text().splitlines()]

    try:
        # The first record means fit runs, its SIGUSR2 handler installed.
        _wait("the first epoch record", records)
        yield {"proc": proc, "port": _wait("the telemetry port", port), "workdir": workdir,
               "records": records}
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait()
        else:
            rc = proc.returncode
        out.close()
    assert rc == EXIT_PREEMPTED, (root / "stdout.txt").read_text()[-4000:]


def test_live_scrape_shows_the_loss_gauge(live):
    port = live["port"]
    # The perf record follows the first epoch record by a few ms.
    snap = _wait("the perf gauges", lambda: (lambda s: "ddlpc_mfu" in s and s)(
        json.loads(_get(port, "/metrics"))))
    assert "ddlpc_train_loss" in snap and "ddlpc_train_epoch" in snap
    assert snap["ddlpc_mfu"] >= 0 and 0 < snap["ddlpc_goodput"] <= 1
    text = _get(port, "/metrics", accept="text/plain")
    assert re.search(r"^ddlpc_train_loss \S+$", text, re.M), text[:2000]
    health = json.loads(_get(port, "/healthz"))
    assert health["status"] == "ok" and health["pid"] == live["proc"].pid
    assert isinstance(health["alerts"], list)
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(port, "/nope")
    assert e.value.code == 404


def test_sigusr2_arms_the_profiler_and_debug_trace_arms_the_next(live):
    workdir = live["workdir"]
    live["proc"].send_signal(signal.SIGUSR2)
    report = _wait("top_ops_001.json", lambda: (workdir / "top_ops_001.json").is_file())
    assert report
    first = json.loads((workdir / "top_ops_001.json").read_text())
    assert first["steps_traced"] == 2 and first["tag"] == "ondemand_001"
    assert "error" not in first and first["wall_ms_per_step"] > 0
    assert (workdir / "profile_001" / "trace.json").is_file()
    armed = json.loads(_get(live["port"], "/debug/trace?steps=1"))
    assert armed["armed"] and armed["steps"] == 1
    _wait("top_ops_002.json", lambda: (workdir / "top_ops_002.json").is_file())
    second = json.loads((workdir / "top_ops_002.json").read_text())
    assert second["steps_traced"] == 1 and second["tag"] == "ondemand_002"
    profiles = [r for r in live["records"]() if r.get("kind") == "profile"]
    assert [r["report_path"] for r in profiles[:2]] == [
        str(workdir / "top_ops_001.json"), str(workdir / "top_ops_002.json")]


def _bits(x: float) -> bytes:
    return struct.pack("<d", x)


def _world_records(tmp_path, name: str, traced: bool, probe_fails_on=()) -> list:
    workdir = tmp_path / name
    argv = ["--config", _tiny_cli_config(tmp_path), "--device", "cpu", "--no-resume",
            "--workdir", str(workdir), "--set", "parallel.data_axis_size=2",
            "--set", "train.micro_batch_size=2", "--set", "compression.mode=int8",
            "--set", "compression.rounding=stochastic", "--set", "compression.codec_backend=pallas",
            "--set", "train.checkpoint_every_epochs=0", "--set", "train.dump_images_per_epoch=0",
            "--set", "data.native_gather=False"]
    if traced:
        argv += ["--set", "train.trace=True", "--set", "train.trace_sync_every_steps=1"]
    run_world("cli", 2, str(tmp_path / f"{name}_world"),
              {"argv": argv, "probe_fails_on": list(probe_fails_on)}, {})
    return [json.loads(x) for x in (workdir / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def untraced(tmp_path_factory):
    return _world_records(tmp_path_factory.mktemp("untraced"), "untraced", False)


def _same_losses(a_records: list, b_records: list) -> None:
    a = [r for r in a_records if "kind" not in r]
    b = [r for r in b_records if "kind" not in r]
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        for key in ("loss", "grad_norm", "pixel_acc", "val_loss"):
            assert _bits(x[key]) == _bits(y[key]), (key, x[key], y[key])


def test_two_rank_world_samples_the_comm_probe_and_keeps_its_losses(tmp_path, untraced):
    traced = _world_records(tmp_path, "traced", True)
    comm = [r for r in traced if r.get("kind") == "comm"]
    assert len(comm) == 2
    for r in comm:
        assert r["variant"] == "allreduce" and r["comm_s_per_step"] > 0
        assert 0 <= r["comm_fraction"] <= 1 and r["overlap_headroom_s"] >= 0
    assert not any("comm_s_per_step" in r for r in untraced if r.get("kind") == "comm")
    perf = [r for r in traced if r.get("kind") == "perf"]
    assert all(r["debit_probe_s"] > 0 for r in perf)
    assert all(r["productive_s"] + sum(v for k, v in r.items() if k.startswith("debit_"))
               <= r["wall_s"] + 1e-3 for r in perf)
    # Rank 0 alone traces: its spans hold the probe under each epoch.
    spans = [json.loads(x) for x in (tmp_path / "traced" / "spans.jsonl").read_text().splitlines()]
    names = {s["span_id"]: s["name"] for s in spans}
    assert [(s["name"], names[s["parent_id"]]) for s in spans if s["name"] == "comm_probe"] == [
        ("comm_probe", "epoch")] * 2
    _same_losses(traced, untraced)


def test_a_probe_one_rank_cannot_make_is_dropped_by_the_whole_world(tmp_path, untraced):
    """Rank 1 alone fails to make the probe's gradient: the world agrees
    before the probe's collectives, every rank drops the probe together
    and trains on (a rank that dropped it alone would leave the other in
    the probe's barrier, or pair the probe's all-reduce with a step's),
    so the run ends, no record carries a probe reading, and the losses
    equal the untraced twin's."""
    declined = _world_records(tmp_path, "declined", True, probe_fails_on=(1,))
    comm = [r for r in declined if r.get("kind") == "comm"]
    assert len(comm) == 2 and not any("comm_s_per_step" in r for r in comm)
    _same_losses(declined, untraced)
