"""The PyTorch port imports nothing of JAX and nothing of ``ddlpc_tpu``.

Pinned in a subprocess, where a fresh interpreter imports the whole port
and then lists what got loaded (the same pattern as the jax-free tier
check in tests/test_analysis.py)."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = (
    "ddlpc_tpu_torch",
    "ddlpc_tpu_torch.config",
    "ddlpc_tpu_torch.convert",
    "ddlpc_tpu_torch.data.datasets",
    "ddlpc_tpu_torch.data.loader",
    "ddlpc_tpu_torch.kernels.build",
    "ddlpc_tpu_torch.models",
    "ddlpc_tpu_torch.models.layers",
    "ddlpc_tpu_torch.models.unet",
    "ddlpc_tpu_torch.ops.cuda_quantize",
    "ddlpc_tpu_torch.ops.losses",
    "ddlpc_tpu_torch.ops.metrics",
    "ddlpc_tpu_torch.ops.quantize",
    "ddlpc_tpu_torch.parallel.grad_sync",
    "ddlpc_tpu_torch.parallel.train_step",
    "ddlpc_tpu_torch.train.__main__",
    "ddlpc_tpu_torch.train.optim",
    "ddlpc_tpu_torch.train.trainer",
)


def test_port_loads_no_jax_flax_optax_or_ddlpc_tpu():
    script = textwrap.dedent(
        f"""
        import importlib, sys
        for m in {PORT_MODULES!r}:
            importlib.import_module(m)
        bad = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "ddlpc_tpu")
        )
        print("LOADED", bad)
        """
    )
    r = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=120, cwd=REPO,
    )
    assert r.returncode == 0, r.stderr
    assert "LOADED []" in r.stdout, r.stdout


def test_chip_smoke_imports_nothing_of_jax():
    script = textwrap.dedent(
        """
        import sys
        import chip_smoke
        bad = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "ddlpc_tpu")
        )
        print("LOADED", bad)
        """
    )
    r = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=120, cwd=REPO,
    )
    assert r.returncode == 0, r.stderr
    assert "LOADED []" in r.stdout, r.stdout


def test_chip_smoke_fails_without_cuda():
    """Here there is no card: the script must exit non-zero and print no
    result line."""
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        timeout=120, cwd=REPO, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
