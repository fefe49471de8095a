"""The PyTorch port imports nothing of JAX, flax, optax, msgpack,
``ddlpc_tpu``, PIL, imageio or ml_dtypes (the card's machine has none of
the last three; the PNG decoder and encoder and the bf16 cast are the
port's own, and imageio is imported only to read a file that is not a PNG).

Pinned in a subprocess, where a fresh interpreter imports the whole port
and then lists what got loaded (the same pattern as the jax-free tier
check in tests/test_analysis.py)."""

import os
import subprocess
import sys
import textwrap

import pytest
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = (
    "ddlpc_tpu_torch",
    "ddlpc_tpu_torch.config",
    "ddlpc_tpu_torch.convert",
    "ddlpc_tpu_torch.data.datasets",
    "ddlpc_tpu_torch.data.loader",
    "ddlpc_tpu_torch.data.png",
    "ddlpc_tpu_torch.data.prepare_cityscapes",
    "ddlpc_tpu_torch.data.prepare_isprs",
    "ddlpc_tpu_torch.kernels.build",
    "ddlpc_tpu_torch.models",
    "ddlpc_tpu_torch.models.deeplabv3p",
    "ddlpc_tpu_torch.models.layers",
    "ddlpc_tpu_torch.models.unet",
    "ddlpc_tpu_torch.models.unetpp",
    "ddlpc_tpu_torch.obs.comm",
    "ddlpc_tpu_torch.obs.flops",
    "ddlpc_tpu_torch.obs.hbm",
    "ddlpc_tpu_torch.obs.lineage",
    "ddlpc_tpu_torch.obs.registry",
    "ddlpc_tpu_torch.ops.cuda_quantize",
    "ddlpc_tpu_torch.ops.losses",
    "ddlpc_tpu_torch.ops.metrics",
    "ddlpc_tpu_torch.ops.philox",
    "ddlpc_tpu_torch.ops.quantize",
    "ddlpc_tpu_torch.parallel.bucketing",
    "ddlpc_tpu_torch.parallel.compressed_allreduce",
    "ddlpc_tpu_torch.parallel.grad_sync",
    "ddlpc_tpu_torch.parallel.halo",
    "ddlpc_tpu_torch.parallel.mesh",
    "ddlpc_tpu_torch.parallel.partition",
    "ddlpc_tpu_torch.parallel.pipeline",
    "ddlpc_tpu_torch.parallel.shard_update",
    "ddlpc_tpu_torch.parallel.train_step",
    "ddlpc_tpu_torch.resilience.protocol",
    "ddlpc_tpu_torch.train.__main__",
    "ddlpc_tpu_torch.train.async_checkpoint",
    "ddlpc_tpu_torch.train.checkpoint",
    "ddlpc_tpu_torch.train.hard_task",
    "ddlpc_tpu_torch.train.observability",
    "ddlpc_tpu_torch.train.optim",
    "ddlpc_tpu_torch.train.trainer",
    "ddlpc_tpu_torch.train.watchdog",
    "ddlpc_tpu_torch.utils.fsio",
    "ddlpc_tpu_torch.utils.native",
    "ddlpc_tpu_torch.utils.wire",
    # The serving slice.
    "ddlpc_tpu_torch.analysis.lockcheck",
    # The invariant checker.
    "ddlpc_tpu_torch.analysis.check",
    "ddlpc_tpu_torch.analysis.core",
    "ddlpc_tpu_torch.analysis.lock_fixtures",
    "ddlpc_tpu_torch.analysis.rules",
    "ddlpc_tpu_torch.analysis.tiers",
    "ddlpc_tpu_torch.obs.health",
    "ddlpc_tpu_torch.obs.http",
    "ddlpc_tpu_torch.obs.profiling",
    "ddlpc_tpu_torch.obs.schema",
    "ddlpc_tpu_torch.obs.tracing",
    "ddlpc_tpu_torch.predict",
    "ddlpc_tpu_torch.resilience.chaos",
    "ddlpc_tpu_torch.serve",
    "ddlpc_tpu_torch.serve.batching",
    "ddlpc_tpu_torch.serve.cbatch",
    "ddlpc_tpu_torch.serve.engine",
    "ddlpc_tpu_torch.serve.metrics",
    "ddlpc_tpu_torch.serve.quantized",
    "ddlpc_tpu_torch.serve.server",
    # The fleet tier.
    "ddlpc_tpu_torch.obs.aggregate",
    "ddlpc_tpu_torch.obs.merge",
    "ddlpc_tpu_torch.resilience.supervisor",
    "ddlpc_tpu_torch.serve.autoscale",
    "ddlpc_tpu_torch.serve.cache",
    "ddlpc_tpu_torch.serve.fleet",
    "ddlpc_tpu_torch.serve.router",
)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "ddlpc_tpu", "PIL", "ml_dtypes", "imageio")


def test_port_loads_no_jax_flax_optax_or_ddlpc_tpu():
    script = textwrap.dedent(
        f"""
        import importlib, sys
        FORBIDDEN = {FORBIDDEN!r}
        for m in {PORT_MODULES!r}:
            importlib.import_module(m)
        bad = sorted(
            m for m in sys.modules
            if m.split(".")[0] in FORBIDDEN
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
        f"""
        import sys
        FORBIDDEN = {FORBIDDEN!r}
        import chip_smoke
        bad = sorted(
            m for m in sys.modules
            if m.split(".")[0] in FORBIDDEN
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


@pytest.mark.parametrize("module", [
    "ddlpc_tpu_torch.serve.server",
    "ddlpc_tpu_torch.predict",
    "ddlpc_tpu_torch.resilience.chaos",
    "ddlpc_tpu_torch.analysis.lockcheck",
])
def test_serving_entry_point_alone_loads_no_jax(module):
    """Each serving entry point imported on its own, in a fresh
    interpreter (what ``python -m`` does on the card's machine)."""
    script = textwrap.dedent(
        f"""
        import importlib, sys
        FORBIDDEN = {FORBIDDEN!r}
        importlib.import_module({module!r})
        print("LOADED", sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN))
        """
    )
    r = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=120, cwd=REPO,
    )
    assert r.returncode == 0, r.stderr
    assert "LOADED []" in r.stdout, r.stdout


# The fleet tier babysits what runs torch and the card, so it loads none
# of it: each module alone, in a fresh interpreter, loads no torch (and no
# JAX, nothing of ddlpc_tpu); the supervisor, the trace merger and the
# telemetry aggregator load no numpy either (the JAX package's stdlib tier,
# ddlpc_tpu/analysis/tiers.py).
FLEET_TIER = {
    "ddlpc_tpu_torch.serve.router": ("torch",),
    "ddlpc_tpu_torch.serve.fleet": ("torch",),
    "ddlpc_tpu_torch.serve.autoscale": ("torch",),
    "ddlpc_tpu_torch.serve.cache": ("torch",),
    "ddlpc_tpu_torch.resilience.supervisor": ("torch", "numpy"),
    "ddlpc_tpu_torch.obs.aggregate": ("torch", "numpy"),
    "ddlpc_tpu_torch.obs.merge": ("torch", "numpy"),
    "ddlpc_tpu_torch": ("torch", "numpy"),
    "ddlpc_tpu_torch.config": ("torch", "numpy"),
    "ddlpc_tpu_torch.serve": ("torch", "numpy"),
    # The training run's telemetry endpoint, and the profiler module that
    # imports torch only where a capture starts.
    "ddlpc_tpu_torch.obs.http": ("torch", "numpy"),
    "ddlpc_tpu_torch.obs.profiling": ("torch", "numpy"),
    # The invariant checker's command, which runs without torch as JAX's
    # runs without jax (its lock smoke reaches the torch arms lazily).
    "ddlpc_tpu_torch.analysis.check": ("torch", "numpy"),
}


@pytest.mark.parametrize("module", sorted(FLEET_TIER))
def test_fleet_tier_module_alone_loads_no_torch(module):
    forbidden = FORBIDDEN + FLEET_TIER[module]
    script = textwrap.dedent(
        f"""
        import importlib, sys
        FORBIDDEN = {forbidden!r}
        importlib.import_module({module!r})
        print("LOADED", sorted({{m.split(".")[0] for m in sys.modules
                                if m.split(".")[0] in FORBIDDEN}}))
        """
    )
    r = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=120, cwd=REPO,
    )
    assert r.returncode == 0, r.stderr
    assert "LOADED []" in r.stdout, r.stdout


def test_fleet_tier_tripwire_sees_torch():
    """The tripwire's control: the engine module alone does load torch."""
    script = (
        "import importlib, sys; importlib.import_module('ddlpc_tpu_torch.serve.engine'); "
        "print('torch' in sys.modules)"
    )
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "True"
