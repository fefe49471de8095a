"""Metric streams, stage timing, the per-epoch profile and the qualitative
image dumps — the port's copy of ``MetricsLogger``, ``StageTimer``,
``maybe_profile``, ``class_palette`` and ``dump_prediction_triples`` from
``ddlpc_tpu/train/observability.py``.

``MetricsLogger`` stamps every record with ``time`` and the stream
``schema`` (``scripts/check_metrics_schema.py`` lints it), mirrors it as a
txt line, and publishes its numeric scalars as gauges.  ``maybe_profile``
captures a whole epoch with ``torch.profiler`` where the JAX package
captures with ``jax.profiler``: the Chrome trace and the per-op
self-times (``ops.json``) land in the trace directory
(``obs/profiling.py``).

The PNGs are written by the port's stdlib encoder (``data/png.py``:
8-bit RGB, filter 0 on every row, one zlib stream), so the port needs no
image library; the files decode to the same pixels as the JAX package's
PIL-written ones.
"""

from __future__ import annotations

import json
import os
import time
import warnings
from contextlib import ExitStack, contextmanager
from typing import Dict, Optional

import numpy as np

from ddlpc_tpu_torch.analysis import lockcheck
from ddlpc_tpu_torch.data.png import write_png
from ddlpc_tpu_torch.obs.registry import sanitize_name
from ddlpc_tpu_torch.obs.schema import SCHEMA_VERSION

# ISPRS-style 6-class palette (imp surface, building, low veg, tree, car,
# clutter), extended by a seeded draw for datasets with more classes.
_PALETTE = np.array(
    [
        [255, 255, 255],
        [0, 0, 255],
        [0, 255, 255],
        [0, 255, 0],
        [255, 255, 0],
        [255, 0, 0],
    ],
    np.uint8,
)


def class_palette(num_classes: int) -> np.ndarray:
    if num_classes <= len(_PALETTE):
        return _PALETTE[:num_classes]
    rng = np.random.default_rng(0)
    extra = rng.integers(0, 256, size=(num_classes - len(_PALETTE), 3), dtype=np.uint8)
    return np.concatenate([_PALETTE, extra])


def _rank0() -> bool:
    """Whether this process is replica 0 (or alone)."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class MetricsLogger:
    """Append-only txt + JSONL metric streams under ``workdir``.

    txt mirrors the reference's epoch lines; JSONL is the machine-readable
    record.  ``basename`` lets other subsystems share the format without
    clobbering the training log (the serve CLI writes
    ``serve_metrics.jsonl``).  ``registry`` receives every numeric scalar
    logged as a gauge.  Only replica 0 of a ``torch.distributed`` world
    writes; ``config.json`` has one writer, the trainer."""

    def __init__(
        self,
        workdir: str,
        basename: str = "metrics",
        registry=None,
    ):
        self.enabled = _rank0()
        self.workdir = workdir
        self.registry = None
        self._records_total = None
        if registry is not None:
            self.attach_registry(registry)
        if not self.enabled:
            return
        os.makedirs(workdir, exist_ok=True)
        self.txt_path = os.path.join(workdir, f"{basename}.txt")
        self.jsonl_path = os.path.join(workdir, f"{basename}.jsonl")

    def attach_registry(self, registry) -> None:
        """Publish every numeric scalar logged from now on as a gauge in a
        MetricsRegistry, so the Prometheus exposition shows the latest
        value of everything the JSONL stream carries (the serve frontend
        owns its registry but receives a logger built before it)."""
        self.registry = registry
        self._records_total = registry.counter(
            "ddlpc_log_records_total",
            "JSONL records written, by record kind.",
            labelnames=("kind",),
        )

    def log(self, record: Dict[str, object], echo: bool = True) -> None:
        if not self.enabled:
            return
        record = {k: (float(v) if isinstance(v, np.floating) else v) for k, v in record.items()}
        record.setdefault("time", time.time())
        record.setdefault("schema", SCHEMA_VERSION)
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self.registry is not None:
            self._publish(record)
        line = "  ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in record.items()
            if k not in ("time", "schema")
        )
        with open(self.txt_path, "a") as f:
            f.write(line + "\n")
        if echo:
            print(line, flush=True)

    def _publish(self, record: Dict[str, object]) -> None:
        """Numeric scalars → ``ddlpc_<kind>_<key>`` gauges in the registry."""
        kind = str(record.get("kind", "train"))
        self._records_total.inc(kind=kind)
        prefix = sanitize_name(f"ddlpc_{kind}")
        for k, v in record.items():
            if k in ("time", "schema", "kind"):
                continue
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            self.registry.gauge(
                f"{prefix}_{sanitize_name(k)}",
                f"Latest {k!r} from the {kind} JSONL stream.",
            ).set(float(v))


@lockcheck.guarded
class StageTimer:
    """Named wall-clock stage timing: totals and counts a stage, reset each
    epoch.  Thread-safe: the loader's producer thread times its
    ``loader_gather``/``loader_upload`` stages while the training thread
    times ``data`` and ``step``.

    ``tracer`` (``obs/tracing.py``, optional) also records every stage as a
    span — how the loader's stages reach the trace without the loader
    knowing of it.  Stages run on producer threads, so each is recorded
    with the tracer's cross-thread ``add_span`` (no implicit parent)."""

    def __init__(self, tracer=None):
        self.totals: Dict[str, float] = {}  # guarded-by: _lock
        self.counts: Dict[str, int] = {}  # guarded-by: _lock
        self.tracer = tracer
        self._lock = lockcheck.lock("StageTimer._lock")

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.totals[name] = self.totals.get(name, 0.0) + (t1 - t0)
                self.counts[name] = self.counts.get(name, 0) + 1
            tracer = self.tracer
            if tracer is not None and tracer.enabled:
                tracer.add_span(name, t0, t1)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.totals)

    def means(self) -> Dict[str, float]:
        with self._lock:
            return {k: self.totals[k] / max(self.counts[k], 1) for k in self.totals}

    def reset(self) -> None:
        with self._lock:
            self.totals.clear()
            self.counts.clear()


@contextmanager
def maybe_profile(trace_dir: Optional[str], enabled: bool = True):
    """A ``torch.profiler`` capture around a block, written to
    ``trace_dir`` (the Chrome ``trace.json`` and the per-op ``ops.json``,
    ``obs/profiling.py``).  No-op when disabled, without a directory or
    off replica 0.  A profiler that cannot start or stop, or a capture
    already running in the process (``CaptureBusy``), warns and never
    raises into the loop; an exception of the profiled body propagates."""
    if not enabled or not trace_dir or not _rank0():
        yield
        return
    from ddlpc_tpu_torch.obs import profiling

    with ExitStack() as stack:
        outcome: dict = {}
        try:
            outcome = stack.enter_context(profiling.session(trace_dir))
        except (profiling.CaptureBusy, profiling.ProfilerFailed) as e:
            warnings.warn(f"profiler trace not taken: {e}", stacklevel=3)
        yield
    if "error" in outcome:
        warnings.warn(f"profiler trace: {outcome['error']}", stacklevel=3)


def dump_prediction_triples(
    workdir: str,
    images: np.ndarray,
    labels: np.ndarray,
    preds: np.ndarray,
    num_classes: int,
    epoch: int,
    max_samples: int = 5,
) -> None:
    """``images/epoch_XXXX/{Model,Label,Image} i.png``: the prediction and
    the label through the class palette, and the image at ×255."""
    out_dir = os.path.join(workdir, "images", f"epoch_{epoch:04d}")
    os.makedirs(out_dir, exist_ok=True)
    pal = class_palette(num_classes)
    for i in range(min(max_samples, len(images))):
        img_u8 = np.clip(images[i] * 255.0, 0, 255).astype(np.uint8)
        if img_u8.shape[-1] == 1:
            img_u8 = np.repeat(img_u8, 3, axis=-1)
        write_png(os.path.join(out_dir, f"Model {i}.png"), pal[np.clip(preds[i], 0, num_classes - 1)])
        write_png(os.path.join(out_dir, f"Label {i}.png"), pal[np.clip(labels[i], 0, num_classes - 1)])
        write_png(os.path.join(out_dir, f"Image {i}.png"), img_u8)
