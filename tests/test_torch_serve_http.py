"""The port's HTTP server and predict CLI against the JAX package's.

The same requests go to a JAX ``make_server`` and a port ``make_server``
on two localhost ports, each over its own package's engine restored from
one JAX run directory (computing in fp32, as in
``tests/test_torch_serve.py``).  Class maps must be equal except at
pixels where JAX's two largest logits are within 1e-4 of each other (a
near-tie that 1e-5 of logit noise between XLA and PyTorch may flip); such
pixels are counted.  Status codes, ``/healthz`` keys and ``/metrics``
family names must be equal.
"""

import http.client
import io
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from ddlpc_tpu.config import ServeConfig as JServeConfig
from ddlpc_tpu.serve import server as jserver
from ddlpc_tpu_torch.config import ServeConfig
from ddlpc_tpu_torch.serve import server as tserver
from test_torch_serve import NCLASS, TILE, engines, write_run
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARGIN = 1e-4


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    return write_run(str(tmp_path_factory.mktemp("http_run")))


class _Served:
    def __init__(self, mod, cfg_cls, engine, **cfg):
        self.engine = engine
        self.frontend = mod.ServingFrontend(engine, cfg_cls(**cfg))
        self.server = mod.make_server(self.frontend, "127.0.0.1", 0)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.port = self.server.server_address[1]

    def request(self, method, path, body=None, headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            return resp.status, dict(resp.getheaders()), resp.read()
        finally:
            conn.close()

    def close(self):
        self.server.shutdown()
        self.frontend.close()
        self.server.server_close()
        self.thread.join(timeout=10)


@pytest.fixture(scope="module")
def pair(run_dir):
    je, te = engines(run_dir, max_bucket=4)
    cfg = dict(max_batch=4, queue_limit=64, deadline_ms=5000.0)
    j = _Served(jserver, JServeConfig, je, **cfg)
    t = _Served(tserver, ServeConfig, te, **cfg)
    yield j, t
    j.close()
    t.close()


def _npy(a):
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def _near_ties(logits):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) < MARGIN


def _assert_maps_equal_but_near_ties(got, want, logits):
    assert got.shape == want.shape and got.dtype == want.dtype
    differ = got != want
    ties = _near_ties(logits)
    assert not (differ & ~ties).any(), f"{int((differ & ~ties).sum())} pixels differ off near-ties"
    return int(ties.sum()), int(differ.sum())


@pytest.mark.parametrize("hw", [(70, 45), (TILE, TILE), (20, 90)])
def test_predict_answers_the_same_class_map_as_jax(pair, hw):
    j, t = pair
    image = np.random.default_rng(hw[0]).uniform(0, 1, (*hw, 3)).astype(np.float32)
    body = _npy(image)
    js, jh, jb = j.request("POST", "/predict", body, {"Content-Type": "application/x-npy"})
    ts, th, tb = t.request("POST", "/predict", body, {"Content-Type": "application/x-npy"})
    assert ts == js == 200
    assert th["Content-Type"] == jh["Content-Type"] == "application/x-npy"
    assert th["X-DDLPC-Model-Step"] == jh["X-DDLPC-Model-Step"] == "1"
    want, got = np.load(io.BytesIO(jb)), np.load(io.BytesIO(tb))
    logits = j.engine.predict_logits(image)
    ties, differ = _assert_maps_equal_but_near_ties(got, want, logits)
    assert differ <= ties
    assert got.max() < NCLASS


def test_healthz_and_metrics_speak_the_same_protocol(pair):
    j, t = pair
    body = _npy(np.random.default_rng(1).uniform(0, 1, (40, 48, 3)).astype(np.float32))
    for s in (j, t):
        assert s.request("POST", "/predict?priority=batch", body)[0] == 200
    (js, _, jb), (ts, _, tb) = (s.request("GET", "/healthz") for s in (j, t))
    assert ts == js == 200
    jh, th = json.loads(jb), json.loads(tb)
    assert set(th) == set(jh)
    for k in ("status", "tile", "channels", "quant_mode", "checkpoint_step", "queue_limit",
              "lineage_id", "lineage_step"):
        assert th[k] == jh[k], k
    (_, _, jm), (_, _, tm) = (s.request("GET", "/metrics") for s in (j, t))
    assert set(json.loads(tm)) == set(json.loads(jm))
    fams = []
    for s in (j, t):
        status, headers, text = s.request("GET", "/metrics", headers={"Accept": "text/plain"})
        assert status == 200 and headers["Content-Type"].startswith("text/plain")
        fams.append({ln.split()[2] for ln in text.decode().splitlines() if ln.startswith("# TYPE")})
    assert fams[1] == fams[0]
    assert "ddlpc_serve_jit_cache_hits_total" in fams[1]


@pytest.mark.parametrize("case", ["channels", "priority", "garbage", "route", "reload_missing", "reload"])
def test_status_codes_equal_jax(pair, tmp_path, case):
    j, t = pair
    req = {
        "channels": ("POST", "/predict", _npy(np.zeros((16, 16, 5), np.float32))),
        "priority": ("POST", "/predict?priority=vip", _npy(np.zeros((16, 16, 3), np.float32))),
        "garbage": ("POST", "/predict", b"garbage"),
        "route": ("GET", "/nope", None),
        "reload_missing": ("POST", "/reload", json.dumps({"workdir": str(tmp_path)}).encode()),
        "reload": ("POST", "/reload", b"{}"),
    }[case]
    (js, _, jb), (ts, _, tb) = (s.request(*req) for s in (j, t))
    assert ts == js, (ts, js)
    jr, tr = json.loads(jb), json.loads(tb)
    assert set(tr) == set(jr)
    if case == "reload":
        assert tr["step"] == jr["step"] == 1 and tr["restore_format"] == jr["restore_format"]


class _BlockedEngine:
    """A minimal engine whose forwards wait for ``release``."""

    tile = (TILE, TILE)
    channels = 3
    version = 0
    checkpoint_step = 1
    compiled_shapes = 1

    def __init__(self):
        self.release = threading.Event()
        self.entered = threading.Event()

    def forward_windows(self, windows):
        self.entered.set()
        self.release.wait(30)
        return np.zeros((len(windows), TILE, TILE, NCLASS), np.float32)


@pytest.mark.parametrize("deadline_ms,code", [(0.0, 503), (50.0, 504)])
def test_overload_and_deadline_answer_as_jax(deadline_ms, code):
    """A full queue answers 503 with Retry-After; a window that outlives
    its deadline in the queue answers 504 — in both servers."""
    got = []
    for mod, cfg_cls in ((jserver, JServeConfig), (tserver, ServeConfig)):
        eng = _BlockedEngine()
        s = _Served(mod, cfg_cls, eng, max_batch=1, slots=1, queue_limit=2,
                    deadline_ms=deadline_ms)
        body = _npy(np.zeros((TILE, TILE, 3), np.float32))
        out = []
        first = threading.Thread(target=lambda: out.append(s.request("POST", "/predict", body)))
        first.start()
        assert eng.entered.wait(10)
        waiting = [threading.Thread(target=lambda: out.append(s.request("POST", "/predict", body)))
                   for _ in range(2)]
        for th in waiting:
            th.start()
        if deadline_ms:
            time.sleep(0.2)
            eng.release.set()
            for th in [first, *waiting]:
                th.join(30)
            statuses = sorted(r[0] for r in out)
            got.append((statuses, None))
        else:
            for _ in range(200):
                if s.frontend.batcher.queue_depth >= 2:
                    break
                time.sleep(0.01)
            status, headers, _ = s.request("POST", "/predict", body)
            got.append((status, headers.get("Retry-After")))
            eng.release.set()
            for th in [first, *waiting]:
                th.join(30)
        s.close()
    assert got[1] == got[0]
    if deadline_ms:
        assert code in got[0][0]
    else:
        assert got[0] == (503, "1")


# ---- the predict CLI ----------------------------------------------------------


def test_predict_cli_writes_the_png_class_maps_of_jax(run_dir, tmp_path):
    from PIL import Image

    from ddlpc_tpu.data.datasets import load_image_file as jload
    from ddlpc_tpu.serve.engine import InferenceEngine as JEngine
    from ddlpc_tpu_torch.data.png import decode_png
    from ddlpc_tpu_torch.train.observability import class_palette

    src = tmp_path / "in"
    src.mkdir()
    rng = np.random.default_rng(2)
    for name, hw in (("a.png", (50, 70)), ("b.png", (33, 40))):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(src / name)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    # Both CLIs at once.
    procs = [subprocess.Popen(
        [sys.executable, "-m", mod, "--workdir", run_dir, "--input", str(src),
         "--output", str(tmp_path / out), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO,
    ) for mod, out, extra in (("ddlpc_tpu.predict", "jax", []),
                              ("ddlpc_tpu_torch.predict", "port", ["--device", "cpu"]))]
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stderr[-2000:]
            assert "wrote 2 predictions" in stdout
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    pal = class_palette(NCLASS)
    je = JEngine.from_workdir(run_dir, echo=False)
    for stem in ("a", "b"):
        with open(tmp_path / "port" / f"{stem}_pred.png", "rb") as f:
            got = decode_png(f.read())
        want = np.asarray(Image.open(tmp_path / "jax" / f"{stem}_pred.png"))
        logits = je.predict_logits(jload(str(src / f"{stem}.png"), None, channels=3))
        classes = lambda rgb: (rgb[..., None, :] == pal).all(-1).argmax(-1)  # noqa: E731
        _assert_maps_equal_but_near_ties(classes(got), classes(want), logits)


def test_predict_cli_raises_without_cuda_unless_the_cpu_is_asked_for(run_dir, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    from ddlpc_tpu_torch import predict

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict.main(["--workdir", run_dir, "--input", str(tmp_path)])


# ---- ServeConfig ----------------------------------------------------------------


def test_serve_configs_parse_to_the_fields_of_jax():
    import glob

    paths = sorted(glob.glob(os.path.join(REPO, "configs", "serve_*.json")))
    assert paths
    for path in paths:
        with open(path) as f:
            text = f.read()
        assert ServeConfig.from_json(text).to_dict() == JServeConfig.from_json(text).to_dict()
    assert ServeConfig().to_dict() == JServeConfig().to_dict()
    assert ServeConfig().quantize == "bf16" and ServeConfig().batcher == "continuous"
    assert ServeConfig().slots == 2
    assert ServeConfig.from_json(ServeConfig(port=1).to_json()).port == 1


def test_serve_config_refuses_an_unknown_key_as_jax():
    for cls in (ServeConfig, JServeConfig):
        with pytest.raises(ValueError, match="unknown config key ServeConfig.device"):
            cls.from_dict({"device": "cuda"})


def test_debug_trace_writes_the_top_ops_report(run_dir, tmp_path):
    """``GET /debug/trace`` captures the next forwards with torch.profiler
    and writes ``serve_top_ops_<n>.json`` with JAX's report fields (on the
    CPU the slot threads' ops are not recorded: an empty table)."""
    _, te = engines(run_dir, max_bucket=4)
    s = _Served(tserver, ServeConfig, te, max_batch=4, workdir=str(tmp_path), deadline_ms=5000.0)
    try:
        body = _npy(np.zeros((TILE, TILE, 3), np.float32))
        done = threading.Event()

        def traffic():
            while not done.is_set():
                s.request("POST", "/predict", body)

        t = threading.Thread(target=traffic)
        t.start()
        try:
            status, _, raw = s.request("GET", "/debug/trace?steps=2&timeout_s=20")
        finally:
            done.set()
            t.join(30)
        rep = json.loads(raw)
        assert status == 200 and "error" not in rep, rep
        assert {"tag", "trace_dir", "planes", "steps_traced", "device_total_ms", "per_step_ms",
                "top_self_time", "timed_out", "wall_s", "report_path"} <= set(rep)
        assert rep["tag"] == "serve_ondemand_001" and rep["timed_out"] is False
        assert rep["report_path"] == str(tmp_path / "serve_top_ops_001.json")
        with open(rep["report_path"]) as f:
            assert json.load(f)["tag"] == rep["tag"]
        status, _, raw = s.request("GET", "/debug/trace?steps=x")
        assert status == 400
    finally:
        s.close()
