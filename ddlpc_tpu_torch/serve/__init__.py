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

- :mod:`router`    — the fleet's routing tier: occupancy-aware dispatch,
                     retry on another replica, hedging, per-replica
                     circuit breakers, SLO tracking, the response cache.
- :mod:`fleet`     — the replica supervisor (launch, readiness, restart,
                     rolling reload with fleet-wide rollback) and the
                     fleet's HTTP front end
                     (``python -m ddlpc_tpu_torch.serve.fleet``).
- :mod:`autoscale` — the SLO-driven replica-count policy loop.
- :mod:`cache`     — the router's content-addressed response cache.

The names below load their module on first use (PEP 562): importing this
package, or the fleet tier under it, loads neither ``torch`` nor the
engine, so a router process never pays for what its replicas run.
"""

import importlib

_EXPORTS = {
    "DeadlineExceeded": "batching",
    "EngineClosed": "batching",
    "MicroBatcher": "batching",
    "Overloaded": "batching",
    "ContinuousBatcher": "cbatch",
    "InferenceEngine": "engine",
    "sliding_window_logits": "engine",
    "ServeMetrics": "metrics",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value
