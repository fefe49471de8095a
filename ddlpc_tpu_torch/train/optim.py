"""Optimizer and learning-rate schedule from TrainConfig — the port's copy of
``ddlpc_tpu/train/optim.py``.

Every optimizer the JAX package builds, written out in optax's order of
operations on flat fp32 buffers (``parallel/train_step.FlatParams``),
updating the params and the state in place, one elementwise pass per term:

- ``adam``: ``scale_by_adam`` then the learning rate::

      mu  = (1 − b1)·g   + b1·mu
      nu  = (1 − b2)·g·g + b2·nu
      m̂   = mu / (1 − b1^t),   v̂ = nu / (1 − b2^t)      (fp32 corrections)
      u   = m̂ / (sqrt(v̂) + eps)

  with ``weight_decay``, optax's ``add_decayed_weights`` chained BEFORE
  Adam (L2: ``g ← g + wd·p``);
- ``adamw``: ``scale_by_adam``, then ``u ← u + wd·p`` (decoupled), then
  the learning rate;
- ``sgd``: optax's ``sgd(lr, momentum=0.9)``: ``t = g + 0.9·t``, ``u = t``
  (``weight_decay`` is not applied, as in the JAX package);

and the learning rate scales last: ``p += (−lr_t)·u``.  ``grad_clip_norm``
is optax's ``clip_by_global_norm`` chained first, on the synced gradient:
``where(norm < max, g, g / norm · max)``.  Its norm sums each leaf's
squares in the JAX package's flatten order (``segments``), as optax's
``global_norm`` does; within a leaf PyTorch and XLA sum in other orders,
so the norm can differ from optax's by an ulp or two.

``sqrt`` is the correctly rounded fp32 square root (IEEE's, numpy's and
XLA's): PyTorch's CPU ``torch.sqrt`` on fp32 is not, and misses it by an
ulp on about 0.66 % of inputs (ROADMAP C7).  :func:`sqrt_rn` takes the
root in fp64 and rounds once to fp32 on the CPU, which is exact; on a
card ``torch.sqrt`` is correctly rounded already, which ``chip_smoke.py``
checks each run.

Schedules (:func:`build_schedule`) are host functions of the update count,
evaluated in fp32 operation for operation as optax evaluates them:
``constant`` with ``warmup_steps`` is ``linear_schedule(0, lr, warmup)``;
``cosine`` is ``warmup_cosine_decay_schedule(0, lr, min(warmup, total−1),
total)``, whose cosine is the C library's ``cosf`` (the function XLA's
CPU backend calls; numpy's and PyTorch's fp32 cosines differ from it).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ddlpc_tpu_torch.config import TrainConfig
from ddlpc_tpu_torch.ops.quantize import true_div

Schedule = Callable[[int], float]
F32 = np.float32
SGD_MOMENTUM = 0.9  # the JAX package's optax.sgd(lr, momentum=0.9)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of an fp32 tensor, on every device."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


# --- schedules ---------------------------------------------------------------

_LIBM = None


def _cosf(x: np.float32) -> np.float32:
    """The C library's single-precision cosine."""
    global _LIBM
    if _LIBM is None:
        lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
        lib.cosf.restype = ctypes.c_float
        lib.cosf.argtypes = [ctypes.c_float]
        _LIBM = lib
    return F32(_LIBM.cosf(float(x)))


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax's ``linear_schedule`` (``polynomial_schedule`` at power 1)."""
    if transition_steps <= 0:
        return lambda count: float(F32(init_value))

    def schedule(count: int) -> float:
        c = min(max(count, 0), transition_steps)
        frac = F32(1) - F32(c) / F32(transition_steps)
        return float(F32(init_value - end_value) * frac + F32(end_value))

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Schedule:
    """optax's ``cosine_decay_schedule`` at ``alpha=0``, ``exponent=1``
    (where its ``(1 − alpha)·c**exponent + alpha`` is ``c`` exactly)."""
    if not decay_steps > 0:
        raise ValueError(
            "The cosine_decay_schedule requires positive decay_steps, got"
            f" decay_steps={decay_steps}."
        )

    def schedule(count: int) -> float:
        c = F32(min(count, decay_steps))
        cosine = F32(0.5) * (F32(1) + _cosf(F32(math.pi) * c / F32(decay_steps)))
        return float(F32(init_value) * cosine)

    return schedule


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int
) -> Schedule:
    """optax's ``warmup_cosine_decay_schedule`` at ``end_value=0``: the
    linear warmup, then the cosine from ``warmup_steps`` on."""
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    cosine = cosine_decay_schedule(peak_value, decay_steps - warmup_steps)
    return lambda count: warm(count) if count < warmup_steps else cosine(count - warmup_steps)


def build_schedule(cfg: TrainConfig, total_steps: Optional[int] = None) -> Union[float, Schedule]:
    """LR schedule from config.  ``total_steps`` is the run's optimizer-step
    horizon (epochs × steps an epoch), required for decaying schedules."""
    if cfg.lr_schedule == "constant":
        if cfg.warmup_steps:
            return linear_schedule(0.0, cfg.learning_rate, cfg.warmup_steps)
        return cfg.learning_rate
    if cfg.lr_schedule == "cosine":
        if not total_steps or total_steps <= 0:
            raise ValueError(
                "lr_schedule='cosine' needs the run's total step count; "
                "construct through the Trainer or pass total_steps"
            )
        return warmup_cosine_decay_schedule(
            0.0, cfg.learning_rate,
            warmup_steps=min(cfg.warmup_steps, max(total_steps - 1, 0)),
            decay_steps=total_steps,
        )
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")


# --- the optimizer -----------------------------------------------------------


@dataclass
class OptState:
    """The optimizer's state: the update count (optax's Adam ``count`` and
    the schedule's ``count``, which advance together) and the moment
    buffers, flat fp32 and aligned with the params they update: ``mu`` and
    ``nu`` for Adam, ``trace`` for SGD."""

    count: int
    mu: Optional[torch.Tensor] = None
    nu: Optional[torch.Tensor] = None
    trace: Optional[torch.Tensor] = None

    def buffers(self) -> dict:
        """``{name: buffer}`` of the moments this optimizer keeps."""
        return {k: v for k, v in (("mu", self.mu), ("nu", self.nu), ("trace", self.trace))
                if v is not None}


def _as_list(x) -> List[torch.Tensor]:
    return list(x) if isinstance(x, (list, tuple)) else [x]


class Optimizer:
    """One of the JAX package's optimizers on flat buffers.  ``kind`` is
    ``adam``, ``adamw`` or ``sgd``; ``lr`` a float or a schedule of the
    update count."""

    MOMENTS = {"adam": ("mu", "nu"), "adamw": ("mu", "nu"), "sgd": ("trace",)}

    def __init__(self, kind: str = "adam", lr: Union[float, Schedule] = 1e-3,
                 weight_decay: float = 0.0, grad_clip_norm: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        if kind not in self.MOMENTS:
            raise ValueError(f"unknown optimizer {kind!r}")
        self.kind = kind
        self.lr = lr
        self.weight_decay = weight_decay
        self.grad_clip_norm = grad_clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    # -- the optax state tree's shape -------------------------------------

    def layout(self):
        """The nesting of optax's state for this optimizer, as
        :func:`build_optimizer` of the JAX package chains it: a tuple is a
        ``chain``; ``'adam'`` is ``ScaleByAdamState``, ``'trace'``
        ``TraceState``, ``'count'`` ``ScaleByScheduleState``, ``'empty'``
        an ``EmptyState`` (``convert.py`` writes and reads the tree)."""
        lr = "count" if callable(self.lr) else "empty"
        if self.kind == "sgd":
            tree = ("trace", lr)
        elif self.kind == "adamw":
            tree = ("adam", "empty", lr)
        else:
            tree = ("adam", lr)
            if self.weight_decay:
                tree = ("empty", tree)
        if self.grad_clip_norm:
            tree = ("empty", tree)
        return tree

    def init(self, params) -> OptState:
        """Zero moments shaped like ``params`` (a buffer, or this replica's
        chunk of one), count 0."""
        like = _as_list(params)
        n = sum(p.numel() for p in like)
        ref = like[0]
        return OptState(0, **{k: torch.zeros(n, dtype=torch.float32, device=ref.device)
                              for k in self.MOMENTS[self.kind]})

    def step_size(self, count: int) -> float:
        """``−lr`` at update ``count`` (the number of updates before it),
        as optax's ``scale_by_learning_rate`` computes it."""
        lr = self.lr(count) if callable(self.lr) else self.lr
        return -1.0 * lr

    # -- the update ---------------------------------------------------------

    def global_norm(self, grads: torch.Tensor, segments: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """optax's ``global_norm`` of ``grads`` over the leaves ``segments``
        (``(offset, numel)`` in flatten order): each leaf's sum of squares,
        added in leaf order in fp32, and its root (a 0-d tensor)."""
        sq = grads * grads
        total = torch.zeros((), dtype=torch.float32, device=grads.device)
        for off, n in segments:
            total = total + sq[off : off + n].sum()
        return sqrt_rn(total.reshape(1)).reshape(())

    def _clipped(self, g: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
        """``where(norm < max, g, g / norm · max)``: a division by the norm
        (a tensor, so an IEEE division on every device), then the multiply."""
        return torch.where(norm < self.grad_clip_norm, g, g / norm * self.grad_clip_norm)

    def _bias_correction(self, decay: float, count: int) -> float:
        """``1 − decay**count`` in fp32, as optax computes it."""
        d = torch.tensor(decay, dtype=torch.float32)
        return float(1.0 - d ** torch.tensor(float(count), dtype=torch.float32))

    @torch.no_grad()
    def update(self, grads, state: OptState, params,
               segments: Optional[Sequence[Tuple[int, int]]] = None,
               norm: Optional[torch.Tensor] = None) -> None:
        """One step: ``params`` and the state in place.  ``grads`` and
        ``params`` are one buffer or matching lists of pieces (this
        replica's chunks of several bucket regions), the state's buffers
        the pieces' concatenation.  Clipping needs the whole gradient as
        one buffer and its leaves' ``segments``, or its global ``norm``
        (:meth:`global_norm`) where ``grads`` are chunks of it."""
        gs, ps = _as_list(grads), _as_list(params)
        sizes = [g.numel() for g in gs]
        moments = {k: v.split(sizes) for k, v in state.buffers().items()}
        if self.grad_clip_norm and norm is None:
            if len(gs) != 1 or segments is None:
                raise ValueError("grad_clip_norm clips the whole gradient: one buffer and its leaves")
            norm = self.global_norm(gs[0], segments)
        state.count += 1
        lr = self.step_size(state.count - 1)
        if self.kind != "sgd":
            c1 = self._bias_correction(self.b1, state.count)
            c2 = self._bias_correction(self.b2, state.count)
        for i, (g, p) in enumerate(zip(gs, ps)):
            if self.grad_clip_norm:
                g = self._clipped(g, norm)
            if self.kind == "sgd":
                t = moments["trace"][i]
                torch.add(g, SGD_MOMENTUM * t, out=t)
                u = t
            else:
                if self.kind == "adam" and self.weight_decay:
                    g = g + self.weight_decay * p
                mu, nu = moments["mu"][i], moments["nu"][i]
                torch.add((1 - self.b1) * g, self.b1 * mu, out=mu)
                torch.add((1 - self.b2) * (g * g), self.b2 * nu, out=nu)
                u = true_div(mu, c1) / (sqrt_rn(true_div(nu, c2)) + self.eps)
                if self.kind == "adamw":
                    u = u + self.weight_decay * p
            p.add_(lr * u)


class Adam(Optimizer):
    """optax's ``adam(lr)``: the flagship's optimizer."""

    def __init__(self, lr: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        super().__init__("adam", lr, b1=b1, b2=b2, eps=eps)


def build_optimizer(cfg: TrainConfig, total_steps: Optional[int] = None) -> Optimizer:
    """The JAX package's ``build_optimizer``: the optimizer, its schedule,
    weight decay and clipping, refusing what it refuses."""
    lr = build_schedule(cfg, total_steps)
    if cfg.optimizer not in ("adam", "adamw", "sgd"):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    if cfg.grad_clip_norm and cfg.grad_clip_norm < 0:
        raise ValueError(f"grad_clip_norm must be >= 0, got {cfg.grad_clip_norm}")
    return Optimizer(cfg.optimizer, lr, weight_decay=cfg.weight_decay,
                     grad_clip_norm=cfg.grad_clip_norm or 0.0)
