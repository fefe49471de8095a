"""Communication accounting: the exact bytes each collective of a step
moves — the port's copy of ``comm_plan`` and ``CommAccountant`` from
``ddlpc_tpu/obs/comm.py``, over the port's ``parallel/grad_sync.py``.

The step variants are the JAX package's (:func:`step_variant`):
``allreduce`` (``shard_update='off'``, the fused all-reduce), ``zero1``
(the same all-reduce, then the all-gather of the params), ``scatter``
(``zero2``: the reduce-scatter of the gradient, then the all-gather of the
params), ``zero3`` (the same two collectives, the all-gather at the head
of the next step) and ``ring`` (``compression.transport='ring'``).  Each
row carries:

- ``bytes_pre``: the fp32 bytes of the ``n`` gradients entering the codec,
  ``n · 4``, as in JAX;
- ``bytes_post``: the codec's declared payload, ``n`` times the wire
  mode's itemsize plus one fp32 scale a bucket, as in JAX;
- ``wire_dtype`` and ``bytes_wire``: what the port's collectives really
  move.  The operand is the whole flat buffer, every bucket region's
  ``N·K_b`` elements with the alignment padding
  (``shard_update.region_rows``; JAX's row counts ``n``), plus 4 bytes a
  bucket for each max-abs all-reduce of the codec's scale (one for the
  fused encode's shared scale, one more under ``zero2``/``zero3`` for the
  mean stage's max over the chunks).  Neither NCCL nor gloo sums int16,
  so the int16 wire moves int32 (ROADMAP C5): there ``wire_dtype`` is
  ``s32``, 4 bytes an element against JAX's 2, and the row says
  ``widened_from: s16``.

The ring's row is ``ring_wire_report``'s, the JAX package's integers:
2(N−1) hops of ``ceil(n/N)`` elements in the hop's own dtype, which is
what the port's point-to-point hops move (the shared scale's 4-byte max
is not counted, as in JAX).  Under ``zero1`` the ring is followed by the
params' all-gather, which the JAX package's plan leaves out (its ``ring``
variant wins over ``zero1``); the port counts it in a second row.

One replica communicates nothing: an empty plan.

The fenced comm-time probe (:func:`make_comm_probe`, sampled by the
trainer under ``train.trace``) times the step's own sync in isolation;
:meth:`CommAccountant.record_probe` keeps the sample and ``publish`` turns
it into ``comm_s_per_step``, ``comm_fraction`` and ``overlap_headroom_s``
(the ``ddlpc_comm_*`` gauges), as in JAX.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import torch

# Wire itemsize of each codec mode's declared payload.
CODEC_ITEMSIZE = {"none": 4, "int8": 1, "float16": 2}
SCALE_BYTES = 4  # one fp32 max-abs scale
_WIRE_NAMES = {torch.int8: ("s8", 1), torch.int16: ("s32", 4), torch.float16: ("f16", 2)}
VARIANTS = ("allreduce", "zero1", "scatter", "zero3", "ring", "gspmd")


def codec_payload_bytes(n_elements: int, mode: str, n_scales: int = 1) -> int:
    """The codec's declared payload for ``n_elements``: the wire dtype's
    bytes plus one fp32 scale a bucket (quantizing modes only)."""
    if mode not in CODEC_ITEMSIZE:
        raise ValueError(f"unknown compression mode {mode!r}")
    return n_elements * CODEC_ITEMSIZE[mode] + (SCALE_BYTES * n_scales if mode != "none" else 0)


def step_variant(compression, level: str, spatial: bool = False) -> str:
    """The comm plan's variant of a resolved ZeRO level, as the JAX
    trainer picks it: the ring over every level, ``gspmd`` on a data ×
    space grid, then ``scatter`` for zero2, the level's own name for zero1
    and zero3, else ``allreduce``."""
    if compression.transport == "ring" and compression.mode != "none":
        return "ring"
    if spatial:
        return "gspmd"
    return {"zero2": "scatter", "zero1": "zero1", "zero3": "zero3"}.get(level, "allreduce")


def _params_row(n_elements: int, buffer_elements: int) -> Dict[str, object]:
    return {
        "collective": "all_gather",
        "codec": "none",
        "bytes_pre": n_elements * 4,
        "bytes_post": n_elements * 4,
        "wire_dtype": "f32",
        "bytes_wire": buffer_elements * 4,
    }


def comm_plan(
    n_elements: int, buffer_elements: int, compression, axis_size: int, variant: str,
    n_buckets: int = 1, level: str = "off",
) -> List[Dict[str, object]]:
    """Rows of the collectives one optimizer step issues: ``n_elements``
    gradients in flat buffers of ``buffer_elements`` (``n_buckets``
    regions) over ``axis_size`` replicas.  ``level`` matters to the ring
    only (zero1 adds the params' all-gather)."""
    from ddlpc_tpu_torch.parallel.compressed_allreduce import ring_wire_report
    from ddlpc_tpu_torch.parallel.grad_sync import simulate_wire_dtype

    if variant not in VARIANTS:
        raise ValueError(f"unknown comm plan variant {variant!r} (one of {VARIANTS})")
    if axis_size <= 1:
        return []
    mode = compression.mode
    if variant == "ring":
        rep = ring_wire_report(n_elements, axis_size, compression)
        name = {"int8": "s8", "int16": "s16", "float32": "f32"}[rep["wire_dtype"]]
        rows = [{
            "collective": "ring_all_reduce",
            "codec": mode,
            "bytes_pre": rep["fp32_bytes_per_replica"],
            "bytes_post": rep["wire_bytes_per_replica"],
            "wire_dtype": name,
            "bytes_wire": rep["wire_bytes_per_replica"],
        }]
        return rows + ([_params_row(n_elements, buffer_elements)] if level == "zero1" else [])
    if variant == "gspmd":
        # The spatial step's all-reduce of fp32 gradients; the codec acts
        # on the mean after it, as in the JAX package's partitioned program.
        return [{
            "collective": "all_reduce",
            "codec": "none",
            "bytes_pre": n_elements * 4,
            "bytes_post": n_elements * 4,
            "wire_dtype": "f32",
            "bytes_wire": n_elements * 4,
        }]
    wire_mode = mode if (mode != "none" and compression.quantize_local) else "none"
    wire = simulate_wire_dtype(axis_size, compression)
    wire_name, wire_item = _WIRE_NAMES[wire] if wire is not None else ("f32", 4)
    scatter = variant in ("scatter", "zero3")
    scales = 1 if wire is not None else 0
    if scatter and mode != "none" and compression.quantize_mean:
        scales += 1
    grad_row = {
        "collective": "reduce_scatter" if scatter else "all_reduce",
        "codec": wire_mode,
        "bytes_pre": n_elements * 4,
        "bytes_post": codec_payload_bytes(n_elements, wire_mode, n_buckets),
        "wire_dtype": wire_name,
        "bytes_wire": buffer_elements * wire_item + SCALE_BYTES * scales * n_buckets,
    }
    if wire == torch.int16:
        grad_row["widened_from"] = "s16"
    if variant == "allreduce":
        return [grad_row]
    return [grad_row, _params_row(n_elements, buffer_elements)]


class CommAccountant:
    """``on_step`` (once an optimizer step) adds the plan's rows to
    ``ddlpc_comm_bytes_total{collective,codec,stage}``; ``record_probe``
    keeps a fenced comm-time sample; ``publish`` refreshes the derived
    gauges and returns the flat ``kind="comm"`` record."""

    def __init__(self, registry, plan: List[Dict[str, object]], variant: str):
        self.plan = list(plan)
        self.variant = variant
        self._lock = threading.Lock()
        self._steps = 0
        self._probe_s: Optional[float] = None
        self._bytes = registry.counter(
            "ddlpc_comm_bytes_total",
            "Collective payload bytes per replica (pre_codec = fp32 entering "
            "the codec, post_codec = the codec's declared payload, wire = the "
            "bytes the collectives move).",
            labelnames=("collective", "codec", "stage"),
        )
        ratio = registry.gauge(
            "ddlpc_comm_compression_ratio",
            "Pre/post codec byte ratio per collective.",
            labelnames=("collective",),
        )
        self._g_comm_s = registry.gauge(
            "ddlpc_comm_seconds_per_step",
            "Sampled fenced gradient-sync seconds (the sync alone).",
        )
        self._g_frac = registry.gauge(
            "ddlpc_comm_fraction",
            "Sampled comm seconds over mean optimizer-step seconds.",
        )
        self._g_headroom = registry.gauge(
            "ddlpc_comm_overlap_headroom_s",
            "Per-step seconds a perfect comm/compute overlap could save: "
            "min(t_comm, t_step - t_comm).",
        )
        for row in self.plan:
            ratio.set(row["bytes_pre"] / max(row["bytes_post"], 1), collective=row["collective"])

    def on_step(self, n: int = 1) -> None:
        for row in self.plan:
            for stage, key in (("pre_codec", "bytes_pre"), ("post_codec", "bytes_post"),
                               ("wire", "bytes_wire")):
                self._bytes.inc(row[key] * n, collective=row["collective"],
                                codec=row["codec"], stage=stage)
        with self._lock:
            self._steps += n

    def record_probe(self, comm_seconds: float) -> None:
        with self._lock:
            self._probe_s = float(comm_seconds)
        self._g_comm_s.set(float(comm_seconds))

    def publish(self, step_time_s: Optional[float] = None) -> Dict[str, object]:
        with self._lock:
            steps = self._steps
            probe_s = self._probe_s
        rec: Dict[str, object] = {"kind": "comm", "variant": self.variant, "steps": steps}
        for row in self.plan:
            name = str(row["collective"])
            rec[f"{name}_bytes_pre_per_step"] = row["bytes_pre"]
            rec[f"{name}_bytes_post_per_step"] = row["bytes_post"]
            rec[f"{name}_codec"] = row["codec"]
            rec[f"{name}_wire_dtype"] = row["wire_dtype"]
            rec[f"{name}_bytes_wire_per_step"] = row["bytes_wire"]
            rec[f"{name}_compression_ratio"] = round(row["bytes_pre"] / max(row["bytes_post"], 1), 4)
            if "widened_from" in row:
                rec[f"{name}_wire_widened_from"] = row["widened_from"]
        if probe_s is not None:
            rec["comm_s_per_step"] = round(probe_s, 6)
            if step_time_s and step_time_s > 0:
                frac = min(probe_s / step_time_s, 1.0)
                headroom = max(min(probe_s, step_time_s - probe_s), 0.0)
                self._g_frac.set(frac)
                self._g_headroom.set(headroom)
                rec["comm_fraction"] = round(frac, 4)
                rec["overlap_headroom_s"] = round(headroom, 6)
                rec["step_time_s"] = round(float(step_time_s), 6)
        return rec


class CommProbeDeclined(RuntimeError):
    """A replica could not prepare the comm probe's gradient.  Every
    replica raises it together, agreed before any of the probe's own
    collectives, so that the world drops the probe as one."""


def _dummy_gradient(buffer_elements: int, segments, device) -> torch.Tensor:
    """The probe's gradient: the run's buffer with its segments filled from
    a fixed seed and the padding zero, the same on every replica."""
    g = torch.Generator(device=device).manual_seed(0)
    buf = torch.zeros(buffer_elements, dtype=torch.float32, device=device)
    for start, size in segments:
        buf[start : start + size] = torch.randn(size, generator=g, device=device) * 1e-3
    return buf


def make_comm_probe(compression, flat, axis_size: int, chunked_grads: bool = False,
                    seed: int = 0) -> Callable[[], float]:
    """A callable that times the gradient sync alone, fenced.

    It runs the step's exact sync — ``parallel/grad_sync.sync_for_level``
    as the run's placement has it (``chunked_grads``: its gradients
    persist chunked, a reduce-scatter), with the buckets of ``flat`` (the run's
    ``FlatParams``) and the run's transport — over a dummy of ``flat``'s
    gradient buffer (:func:`_dummy_gradient`), after a device synchronize
    and a barrier of the world, and returns the wall seconds until the
    device is done.  Its first call warms up (one untimed sync).
    Stochastic rounding draws from the experiment's own key
    (``philox.seed_key``), never from a step's: the probe leaves the
    training's rounding untouched, as JAX's probe builds
    ``jax.random.key(seed)`` inside its program.  The dummy is made anew
    for each call and dropped after it, so that nothing gradient-sized
    stays allocated between samples.

    Every replica must call it at the same step: it is a collective.  So
    the replicas first agree, by one all-reduce of a failure flag, that
    each made its dummy; where any could not (an out-of-memory, say),
    every replica raises :class:`CommProbeDeclined` before the barrier.
    An error inside the sync itself propagates: the world is then out of
    step, and no replica may go on alone."""
    import torch.distributed as dist

    from ddlpc_tpu_torch.ops.philox import seed_key
    from ddlpc_tpu_torch.parallel.grad_sync import sync_for_level

    n_elements, buffer_elements = flat.numel, flat.data.numel()
    segments, buckets, device = flat.segments(), flat.buckets(), flat.data.device
    key = seed_key(seed) if compression.rounding == "stochastic" else None
    state = {"warmed": False}

    def fence() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def in_world() -> bool:
        return dist.is_available() and dist.is_initialized()

    def prepared() -> torch.Tensor:
        failure = None
        try:
            buf = _dummy_gradient(buffer_elements, segments, device)
        except Exception as e:  # noqa: BLE001 — agreed on below, then raised
            buf, failure = None, f"{type(e).__name__}: {e}"
        failed = torch.tensor([0 if failure is None else 1], dtype=torch.int32, device=device)
        if in_world():
            dist.all_reduce(failed)
        n_failed = int(failed.item())
        if n_failed:
            raise CommProbeDeclined(
                f"{n_failed} replica(s) could not make the probe's gradient"
                + (f"; here {failure}" if failure else ""))
        return buf

    def sync(buf: torch.Tensor) -> None:
        sync_for_level(buf, compression, axis_size, chunked_grads, key=key, buckets=buckets,
                       n_elements=n_elements)

    def probe() -> float:
        buf = prepared()
        if not state["warmed"]:
            sync(buf)
            state["warmed"] = True
        fence()
        if in_world():
            dist.barrier()
        t0 = time.perf_counter()
        sync(buf)
        fence()
        return time.perf_counter() - t0

    return probe
