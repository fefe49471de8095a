"""PyTorch/CUDA port of ``ddlpc_tpu`` for NVIDIA Hopper (H100, sm_90a).

The JAX package ``ddlpc_tpu`` is the reference this package is held
against; nothing here imports it (or JAX).  The layout mirrors it:

- ``config``     — the experiment dataclasses; reads the same ``configs/*.json``
- ``data``       — synthetic tiles and the single-device batcher
- ``models``     — the U-Net (NCHW inside, NHWC at the public edge)
- ``ops``        — loss, metrics, the gradient codec and its CUDA wrappers
- ``kernels``    — hand-written CUDA C++ sources and their ``nvcc`` build
- ``parallel``   — gradient sync and the train/eval steps
- ``train``      — Adam, the Trainer and the CLI (``python -m ddlpc_tpu_torch.train``)
- ``convert``    — flax ⇄ torch state conversion

Entry points run on ``cuda`` unless the caller asks for ``cpu``; they
raise when CUDA is absent and the CPU was not asked for.
"""

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``cpu`` is asked
    for.  Raises when CUDA is requested (or defaulted to) but absent — the
    port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass --device cpu (or device='cpu') to "
            "run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
