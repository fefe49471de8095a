"""The port's fleet and training supervisor as real processes, on the CPU.

- ``python -m ddlpc_tpu_torch.serve.fleet --device cpu`` with two port
  replicas over a JAX run directory (``test_torch_serve.write_run``: fp32
  compute, int8 weights): its class maps equal the JAX package's
  in-process int8 engine's except at near-ties (the rule of
  ``tests/test_torch_serve_http.py``); a replica SIGKILLed under load
  costs no client a 5xx and is relaunched and readmitted; a rolling
  reload moves both replicas to a newer step under load; SIGTERM drains
  the fleet, which exits 0 with every replica.
- ``python -m ddlpc_tpu_torch.resilience.supervisor`` over a tiny port
  trainer whose every attempt is SIGKILLed at its second step
  (``DDLPC_CHAOS=kill@2``, one step an epoch, synchronous checkpoints):
  each attempt makes a checkpoint of progress, the run ends rc 0, and its
  final checkpoint holds the same bits as an uninterrupted run's
  (``OMP_NUM_THREADS=1`` in both, so that the CPU's sums run in one order).
"""

import http.client
import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from ddlpc_tpu.serve import engine as jengine
from ddlpc_tpu_torch.config import FleetConfig
from ddlpc_tpu_torch.train import checkpoint as tckpt
from test_torch_serve import NCLASS, TILE, write_run
from test_torch_serve_http import _assert_maps_equal_but_near_ties
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


def _npy(a):
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def _req(port, method, path, body=None, timeout=60.0, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def _wait(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def _fleet_status(port):
    return json.loads(_req(port, "GET", "/fleet")[2])


def test_fleet_cli_serves_survives_a_kill_reloads_and_drains(tmp_path):
    run = write_run(str(tmp_path / "run"))
    cfg = FleetConfig(
        workdir=run, replicas=2, port=0, quantize="int8", max_batch=4, hedge_ms=0.0,
        scrape_every_s=0.2, metrics_every_s=0.0, aggregate_every_s=0.5,
        backoff_base_s=0.1, drain_timeout_s=20.0, warmup_timeout_s=120.0,
    )
    cfg_path = tmp_path / "fleet.json"
    cfg_path.write_text(cfg.to_json())
    out = open(tmp_path / "fleet.out", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ddlpc_tpu_torch.serve.fleet", "--config", str(cfg_path),
         "--device", "cpu"],
        cwd=REPO, env=ENV, stdout=out, stderr=subprocess.STDOUT,
    )

    def banner():
        out.seek(0)
        return re.search(r"fleet: 2/2 replicas ready; routing http://[\d.]+:(\d+) ", out.read())

    try:
        _wait(lambda: banner() or proc.poll() is not None, 150, "the fleet")
        assert proc.poll() is None, out.seek(0) or out.read()
        port = int(banner().group(1))
        health = json.loads(_req(port, "GET", "/healthz")[2])
        assert health["ready"] == 2 and health["checkpoint_steps"] == [1], health

        # Class maps against the JAX package's in-process int8 engine.
        ref = jengine.InferenceEngine.from_workdir(run, max_bucket=4, echo=False,
                                                   quantize="int8")
        for hw in ((70, 45), (TILE, TILE)):
            image = np.random.default_rng(hw[0]).uniform(0, 1, (*hw, 3)).astype(np.float32)
            status, headers, body = _req(port, "POST", "/predict", _npy(image))
            assert status == 200 and headers["X-DDLPC-Model-Step"] == "1"
            got = np.load(io.BytesIO(body))
            want = ref.predict_classes(image).astype(got.dtype)
            _assert_maps_equal_but_near_ties(got, want, ref.predict_logits(image))
            assert got.max() < NCLASS

        # A load of 3 closed-loop clients; r0 is SIGKILLed in its middle.
        statuses, lock, stop = [], threading.Lock(), threading.Event()
        tile = _npy(np.random.default_rng(1).uniform(0, 1, (TILE, TILE, 3)).astype(np.float32))

        def client():
            while not stop.is_set():
                s = _req(port, "POST", "/predict", tile)[0]
                with lock:
                    statuses.append(s)

        threads = [threading.Thread(target=client) for _ in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.5)
        victim = next(r for r in _fleet_status(port)["supervisor"]["replicas"] if r["name"] == "r0")
        os.kill(victim["pid"], signal.SIGKILL)

        def relaunched():
            r0 = next(r for r in _fleet_status(port)["supervisor"]["replicas"]
                      if r["name"] == "r0")
            return r0["launches"] == 2 and r0["ready"]

        _wait(relaunched, 120, "r0's relaunch")
        # A newer checkpoint, pushed through the fleet while the load runs.
        write_run(run, seed=1, step=2)
        status, _, body = _req(port, "POST", "/reload", b"{}", timeout=120)
        answer = json.loads(body)
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(60)
        assert status == 200 and answer["ok"] and answer["step"] == 2 and answer["old_step"] == 1
        assert len(statuses) > 10 and all(s == 200 for s in statuses), statuses
        health = json.loads(_req(port, "GET", "/healthz")[2])
        assert health["checkpoint_steps"] == [2] and health["ready"] == 2
        metrics = json.loads(_req(port, "GET", "/metrics")[2])
        assert metrics["errors_5xx"] == 0 and metrics["reloads_ok"] == 1
        text = _req(port, "GET", "/metrics", headers={"Accept": "text/plain"})[2].decode()
        assert "# TYPE ddlpc_router_requests_total" in text
        assert 'ddlpc_fleet_serve_requests_total{replica="fleet"}' in text

        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out.seek(0)
    log = out.read()
    assert rc == 0, log
    assert "r0: exit -9 (oom_kill)" in log
    # Every replica drained and exited 0 at the fleet's SIGTERM.
    exits = [ln for ln in log.splitlines() if ": exit " in ln]
    assert sum("exit 0 (clean)" in ln for ln in exits) == 2, exits
    for home in ("r0", "r1"):
        assert "Traceback" not in (tmp_path / "run" / "fleet" / home / "replica.log").read_text()


TINY = {
    "model": {"features": [8, 16], "bottleneck_features": 16, "stem": "s2d", "stem_factor": 2,
              "compute_dtype": "float32"},
    "data": {"image_size": [32, 32], "synthetic_len": 20, "test_split": 4},
    "train": {"epochs": 4, "micro_batch_size": 4, "sync_period": 4,
              "checkpoint_every_epochs": 1, "checkpoint_async": False,
              "dump_images_per_epoch": 0},
    "compression": {"mode": "float16"},
}


def _train_cmd(cfg, workdir):
    return [sys.executable, "-m", "ddlpc_tpu_torch.train", "--config", cfg, "--device", "cpu",
            "--workdir", workdir]


def _leaves(workdir):
    tree, meta = tckpt.restore_checkpoint(os.path.join(workdir, "checkpoints"))
    return meta["step"], meta["epoch"], tckpt.flatten_tree(tree)


def test_supervisor_cli_resumes_a_killed_trainer_to_the_same_bits(tmp_path):
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(TINY))
    ref = str(tmp_path / "ref")
    r = subprocess.run(_train_cmd(str(cfg), ref) + ["--no-resume"], cwd=REPO, env=ENV,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    run = str(tmp_path / "run")
    r = subprocess.run(
        [sys.executable, "-m", "ddlpc_tpu_torch.resilience.supervisor", "--workdir", run,
         "--backoff-base-s", "0.1", "--"] + ["env", "DDLPC_CHAOS=kill@2"]
        + _train_cmd(str(cfg), run),
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    with open(os.path.join(run, "resilience.jsonl")) as f:
        attempts = [json.loads(ln) for ln in f]
    assert [a["cause"] for a in attempts] == ["oom_kill"] * 3 + ["clean"]
    assert all(a["progressed"] for a in attempts)
    assert "backing off" not in r.stderr
    step, epoch, got = _leaves(run)
    want_step, want_epoch, want = _leaves(ref)
    assert (step, epoch) == (want_step, want_epoch) == (4, 3)
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = want[k], got[k]
        if isinstance(a, dict):
            assert a == b == {}, k
        else:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("rc_cause", [("0", "clean"), ("3", "crash")])
def test_supervisor_cli_exit_status(tmp_path, rc_cause):
    """A clean child ends supervision rc 0; a child that always crashes
    without progress is given up on after ``--crash-loop-limit`` exits,
    and the supervisor exits with its status."""
    rc, cause = rc_cause
    r = subprocess.run(
        [sys.executable, "-m", "ddlpc_tpu_torch.resilience.supervisor", "--workdir",
         str(tmp_path), "--crash-loop-limit", "2", "--backoff-base-s", "0.01", "--",
         sys.executable, "-c", f"import sys; sys.exit({rc})"],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == int(rc)
    with open(tmp_path / "resilience.jsonl") as f:
        recs = [json.loads(ln) for ln in f]
    assert recs[0]["cause"] == cause
    if cause == "crash":
        assert recs[-1]["kind"] == "supervisor_give_up" and len(recs) == 3
