"""`ddlpc_tpu_torch.serve` — batched, backpressured inference serving, the
port of ``ddlpc_tpu.serve``.  Layers, bottom-up:

- :mod:`engine`    — checkpoint restore, the shape-bucketed forward cache,
                     the overlap-blended sliding-window tiler, and
                     lock-guarded checkpoint hot-reload.
- :mod:`quantized` — int8/bf16 weight state: per-leaf max-abs scales
                     computed once per restore/reload by the codec kernels,
                     dequantized in each forward.
- :mod:`batching`  — bounded admission queue + coalescing micro-batcher,
                     per-request deadlines, typed ``Overloaded`` shedding.
- :mod:`cbatch`    — continuous batching: ``slots`` workers refill the
                     device the moment they free, with interactive/batch
                     priority classes and a starvation bound.
- :mod:`metrics`   — latency quantiles, queue depth, batch occupancy,
                     tiles/sec.
- :mod:`server`    — stdlib ``http.server`` front end (``/healthz``,
                     ``/predict``, ``/metrics``, ``/reload``,
                     ``/debug/trace``) over a ``ServingFrontend``.

The JAX package's fleet tier (router, fleet, autoscale, response cache)
is not ported yet.
"""

from ddlpc_tpu_torch.serve.batching import (  # noqa: F401
    DeadlineExceeded,
    EngineClosed,
    MicroBatcher,
    Overloaded,
)
from ddlpc_tpu_torch.serve.cbatch import ContinuousBatcher  # noqa: F401
from ddlpc_tpu_torch.serve.engine import (  # noqa: F401
    InferenceEngine,
    sliding_window_logits,
)
from ddlpc_tpu_torch.serve.metrics import ServeMetrics  # noqa: F401
