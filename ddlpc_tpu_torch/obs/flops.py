"""Per-step conv FLOP model and live MFU / goodput accounting — the port's
copy of ``ddlpc_tpu/obs/flops.py``.

**The FLOP model.**  The JAX package walks the jaxpr of the micro-batch's
``value_and_grad`` and counts every ``conv_general_dilated`` at
``2 · output elements · KH · KW · Cin`` (per group).  The port has no
jaxpr, so it counts the same equations from the model's own conv modules
(``models/layers.Conv``, ``ConvTranspose``), whose shapes forward hooks
read on a ``meta``-device forward of one tile (nothing is allocated), in
JAX's convention:

- the forward conv: ``2 · N·Ho·Wo·Cout · K · Cin``.  flax's
  ``ConvTranspose`` is itself an lhs-dilated conv, whose output is the
  up-sampled grid, so its inserted zeros count;
- the weight gradient: the same count (it contracts the same pairs);
- the data gradient, only where the conv's input depends on the params
  (the first conv of the stem sees the batch itself and has none):
  ``2 · N·H·W·Cin · K · Cout``, the input grid's size.  For a strided
  conv that grid is the lhs-dilated cotangent's, zeros counted; for the
  transposed conv it is the plain input's.  A dilated conv counts its K
  taps, not the span they cover; a 1×1-grid conv (ASPP's image pool) is
  counted like any other.  The hooks see the module's input before any
  'SAME' padding, as the jaxpr's conv does.

On the flagship that is 89 equations a micro-batch, the JAX count; the
three U-Net++ and DeepLabV3+ configs' integers equal JAX's too.  The
count is linear in the batch, so one tile's times the micro-batch is
exact.  ``torch.utils.flop_counter`` counts otherwise (no inserted zeros)
and is not used.  Non-conv FLOPs (norms, loss, Adam) are left out, as in
the JAX model.

**Accounting.**  :class:`PerfAccountant` turns the model and the
trainer's stage timings into the ``ddlpc_mfu`` and ``ddlpc_goodput``
gauges and one flat ``kind="perf"`` record an epoch: productive step
seconds over the wall since ``fit`` began, debited ``data``, ``eval``,
``checkpoint`` and ``restart`` (the gap since an interrupted attempt's
last breadcrumb).  The intervals are disjoint on the training thread, so
``productive + Σ debits ≤ wall``.

**The peak.**  Dense bf16 FLOP/s a card, keyed by
``torch.cuda.get_device_name``: the H100 SXM's published 989e12.  Any
other device, the CPU included, takes that peak too with
``ddlpc_peak_flops_assumed = 1`` (where the JAX package assumes a TPU's;
the port states no TPU number).  ``train.peak_flops_per_device > 0``
overrides it.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from ddlpc_tpu_torch.resilience.protocol import read_breadcrumb

H100_SXM_BF16_FLOPS = 989e12
# Dense bf16 FLOP/s by device name; entries are added when a card is
# measured against.
_PEAK_BY_DEVICE_NAME = (("H100 80GB HBM3", H100_SXM_BF16_FLOPS),)
ASSUMED_PEAK_FLOPS = H100_SXM_BF16_FLOPS


def collect_convs(model_cfg, image_size: Tuple[int, int], channels: int = 3) -> List[dict]:
    """One row a forward conv of one tile's train-mode forward: its kind,
    input ``[1, Cin, H, W]`` and output ``[1, Cout, Ho, Wo]`` shapes, its
    kernel's spatial size, whether its input needs a gradient, and its
    three FLOP counts (forward, weight gradient, data gradient)."""
    from ddlpc_tpu_torch.models import build_model
    from ddlpc_tpu_torch.models.layers import Conv, ConvTranspose

    rows: List[dict] = []

    def hook(module, inputs, out):
        x = inputs[0]
        _, cin, h, w = x.shape
        _, cout, ho, wo = out.shape
        k = module.weight.shape[2] * module.weight.shape[3]
        fwd = 2 * ho * wo * cout * k * cin
        rows.append({
            "kind": type(module).__name__, "in": tuple(x.shape), "out": tuple(out.shape),
            "kernel": k, "input_grad": bool(x.requires_grad),
            "forward": fwd, "weight_grad": fwd,
            "data_grad": 2 * h * w * cin * k * cout if x.requires_grad else 0,
        })

    with torch.device("meta"):
        model = build_model(model_cfg, in_channels=channels)
        for m in model.modules():
            if isinstance(m, (Conv, ConvTranspose)):
                m.register_forward_hook(hook)
        model.train()
        model(torch.zeros((1, *image_size, channels)))
    return rows


@functools.lru_cache(maxsize=None)
def _tile_flops(model_cfg, image_size: Tuple[int, int], channels: int) -> int:
    return sum(r["forward"] + r["weight_grad"] + r["data_grad"]
               for r in collect_convs(model_cfg, image_size, channels))


def conv_step_flops(cfg, micro_batch: int, sync_period: int, channels: int = 3) -> int:
    """Conv FLOPs of one optimizer step on one replica: ``sync_period``
    micro-batches of ``micro_batch`` tiles, forward and backward."""
    per_tile = _tile_flops(cfg.model, tuple(cfg.data.image_size), int(channels))
    return int(sync_period) * int(micro_batch) * per_tile


def resolve_peak_flops(configured: float = 0.0, device: Optional[torch.device] = None) -> Tuple[float, bool]:
    """(peak FLOP/s a device, assumed?) for the MFU denominator."""
    if configured and configured > 0:
        return float(configured), False
    if device is not None and device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        for sub, peak in _PEAK_BY_DEVICE_NAME:
            if sub in name:
                return peak, False
    return ASSUMED_PEAK_FLOPS, True


def restart_gap_seconds(workdir: str, now: Optional[float] = None) -> float:
    """Downtime this attempt inherits from an interrupted one: from the
    newest of the previous attempt's breadcrumb and ``resilience.jsonl``
    timestamps to now.  Only a breadcrumb whose phase is not ``done`` makes
    this attempt a restart.  Best-effort: 0 when nothing is readable."""
    now = time.time() if now is None else now
    crumb = read_breadcrumb(workdir)
    if not crumb or crumb.get("phase") == "done":
        return 0.0
    latest = 0.0
    t = crumb.get("time")
    if isinstance(t, (int, float)):
        latest = float(t)
    try:
        with open(os.path.join(workdir, "resilience.jsonl")) as f:
            for line in f:
                try:
                    t = json.loads(line).get("time")
                except (ValueError, AttributeError):
                    continue
                if isinstance(t, (int, float)):
                    latest = max(latest, float(t))
    except OSError:
        pass
    if latest <= 0.0:
        return 0.0
    return max(now - latest, 0.0)


class PerfAccountant:
    """Live MFU and goodput over a training run's wall clock.

    The trainer credits ``productive`` step seconds and ``debit``s other
    intervals of the training thread by category, plus the restart gap
    once; ``publish`` refreshes the gauges and returns the flat
    ``kind="perf"`` record.  Thread-safe."""

    def __init__(
        self,
        registry,
        flops_per_step: int,
        peak_flops: float,
        peak_assumed: bool = False,
        restart_gap_s: float = 0.0,
    ):
        self._lock = threading.Lock()
        self.flops_per_step = int(flops_per_step)
        self.peak_flops = float(peak_flops)
        self.peak_assumed = bool(peak_assumed)
        self.restart_gap_s = float(restart_gap_s)
        self._origin: Optional[float] = None
        self._productive_s = 0.0
        self._steps = 0
        self._debits: Dict[str, float] = {}
        if restart_gap_s > 0:
            self._debits["restart"] = float(restart_gap_s)
        self._g_mfu = registry.gauge(
            "ddlpc_mfu",
            "Model FLOP utilization of the last epoch's mean step "
            "(conv FLOPs / (step seconds * peak FLOP/s per device)).",
        )
        self._g_goodput = registry.gauge(
            "ddlpc_goodput",
            "Productive-step seconds over wall seconds since fit start, "
            "debiting data waits, eval, checkpoint stalls, restart gaps.",
        )
        self._g_flops = registry.gauge(
            "ddlpc_flops_per_step",
            "Per-device conv FLOPs of one optimizer step (the conv modules' "
            "forward and both backward convs, JAX's convention).",
        )
        self._g_peak = registry.gauge(
            "ddlpc_peak_flops_per_device",
            "Peak FLOP/s per device used as the MFU denominator.",
        )
        self._g_assumed = registry.gauge(
            "ddlpc_peak_flops_assumed",
            "1 when the peak is an assumption (a device not in the table, "
            "the H100 SXM's peak used), 0 when known or configured.",
        )
        self._g_debit = registry.gauge(
            "ddlpc_goodput_debit_seconds_total",
            "Cumulative non-productive wall seconds, by category.",
            labelnames=("category",),
        )
        self._g_flops.set(float(self.flops_per_step))
        self._g_peak.set(self.peak_flops)
        self._g_assumed.set(1.0 if peak_assumed else 0.0)
        if restart_gap_s > 0:
            self._g_debit.set(restart_gap_s, category="restart")

    def start(self) -> None:
        """Mark the wall origin (once; a second fit continues the clock)."""
        with self._lock:
            if self._origin is None:
                self._origin = time.monotonic()

    def productive(self, seconds: float, steps: int = 0) -> None:
        with self._lock:
            self._productive_s += max(float(seconds), 0.0)
            self._steps += int(steps)

    def debit(self, category: str, seconds: float) -> None:
        seconds = max(float(seconds), 0.0)
        with self._lock:
            self._debits[category] = self._debits.get(category, 0.0) + seconds
            total = self._debits[category]
        self._g_debit.set(total, category=category)

    def mfu(self, step_time_s: float) -> float:
        if step_time_s <= 0 or self.peak_flops <= 0:
            return 0.0
        return self.flops_per_step / (step_time_s * self.peak_flops)

    def publish(self, step_time_s: Optional[float] = None) -> Dict[str, object]:
        """Refresh the gauges; the ``kind="perf"`` record.  ``step_time_s``
        is the last epoch's mean step (else the credited mean)."""
        with self._lock:
            origin = self._origin
            productive = self._productive_s
            steps = self._steps
            debits = dict(self._debits)
        wall = (time.monotonic() - origin if origin is not None else 0.0) + self.restart_gap_s
        if step_time_s is None and steps > 0:
            step_time_s = productive / steps
        mfu = self.mfu(step_time_s) if step_time_s else 0.0
        goodput = productive / wall if wall > 0 else 0.0
        self._g_mfu.set(mfu)
        self._g_goodput.set(goodput)
        rec: Dict[str, object] = {
            "kind": "perf",
            "mfu": round(mfu, 6),
            "goodput": round(goodput, 6),
            "flops_per_step": self.flops_per_step,
            "peak_flops_per_device": self.peak_flops,
            "peak_flops_assumed": self.peak_assumed,
            "productive_s": round(productive, 4),
            "wall_s": round(wall, 4),
            "steps": steps,
        }
        if step_time_s:
            rec["step_time_s"] = round(float(step_time_s), 6)
        attributed = productive
        for cat, secs in sorted(debits.items()):
            rec[f"debit_{cat}_s"] = round(secs, 4)
            attributed += secs
        # What the measured intervals do not cover (building, logging, the
        # loop's own cost).
        rec["other_s"] = round(max(wall - attributed, 0.0), 4)
        return rec
