"""The stochastic-rounding noise: a counter-based Philox4x32-10 stream, in
plain PyTorch, and the host-side key schedule.

The TPU kernels draw U[0,1) from the core's hardware PRNG
(``ddlpc_tpu/ops/pallas_quantize.py:55-63``); the CUDA kernels in
``kernels/csrc/stochastic.cu`` compute Philox4x32-10 (Salmon et al.,
"Parallel random numbers: as easy as 1, 2, 3", SC 2011; Random123's
constants) in registers instead.  This module is their plain version: the
same stream, bit for bit, which the CPU path runs and ``chip_smoke.py``
holds the kernels against on the card.

The stream: element ``e`` takes word ``e % 4`` of ``philox(counter = (e //
4) as the words (lo, hi, 0, 0), key)``, mapped to ``u = (bits >> 8) ·
2⁻²⁴`` (the TPU kernel's own 24-bit mapping, exact in fp32 and in [0, 1)).
A draw starts at an element ``offset`` into the stream, so the draw for a
slice ``x[o:]`` at offset ``o`` is the slice of the draw for ``x``.

Keys are Python ints derived on the host (splitmix64), so drawing one
never waits on the card.  The schedule mirrors the JAX package's:
``step_key(seed, step)`` is ``_rounding_rng`` (``parallel/train_step.py``),
and ``stage_key`` is ``_sync_tree``'s split into a local and a mean key
with the replica index folded into the local one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

PhiloxKey = Tuple[int, int]  # two 32-bit words

_MASK64 = (1 << 64) - 1
_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # Weyl key bumps
ROUNDS = 10
_ROOT = 0x5EED  # the root of the key schedule, as in the JAX package
STAGES = {"local": 0, "mean": 1}


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_in(key: int, data: int) -> int:
    """A new 64-bit key from ``key`` and an integer (any sign)."""
    return _splitmix64(key ^ _splitmix64(data & _MASK64))


def seed_key(seed: int) -> int:
    """The experiment's key, before any step is folded in (``jax.random.key(seed)``
    in the JAX package): what the comm probe's rounding draws from."""
    return fold_in(_ROOT, seed)


def step_key(seed: int, step: int) -> int:
    """The optimizer step's key: a pure function of (``train.seed``, step),
    so a replayed run draws the same noise and another seed other noise."""
    return fold_in(seed_key(seed), step)


def stage_key(key: int, stage: str, replica: int = 0) -> PhiloxKey:
    """The Philox key of one codec stage of a step.  ``'local'`` folds in
    the replica index (per-replica gradients are correlated; a shared draw
    would keep their rounding errors from averaging down); ``'mean'``
    ignores it, because every replica must requantize the mean alike."""
    if stage not in STAGES:
        raise ValueError(f"unknown codec stage {stage!r} (expected 'local' or 'mean')")
    k = fold_in(key, STAGES[stage])
    if stage == "local":
        k = fold_in(k, replica)
    return k & _MASK32, k >> 32


def rounding_key(seed: int, step: int, stage: str, replica: int = 0) -> PhiloxKey:
    """``stage_key(step_key(seed, step), stage, replica)``."""
    return stage_key(step_key(seed, step), stage, replica)


def check_key(key: PhiloxKey, offset: int) -> None:
    """A key is two ints in [0, 2³²); an offset an int ≥ 0."""
    if (
        not isinstance(key, tuple)
        or len(key) != 2
        or not all(isinstance(k, int) and 0 <= k <= _MASK32 for k in key)
    ):
        raise ValueError(f"a Philox key is two 32-bit unsigned ints, got {key!r}")
    if not isinstance(offset, int) or offset < 0:
        raise ValueError(f"offset must be an int >= 0, got {offset!r}")


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of ``a · b`` (``a`` a 32-bit constant,
    ``b`` 32-bit values held in int64).  The 64-bit product would overflow
    int64, so ``b`` is split into 16-bit halves: ``a·b = u·2¹⁶ + (t mod
    2¹⁶)`` with ``t = a·b_lo`` and ``u = a·b_hi + t >> 16``, each < 2⁴⁹."""
    t = a * (b & 0xFFFF)
    u = a * (b >> 16) + (t >> 16)
    return u >> 16, ((u & 0xFFFF) << 16) | (t & 0xFFFF)


def philox4x32(counter: torch.Tensor, key: PhiloxKey) -> torch.Tensor:
    """Philox4x32-10 of int64 ``counter [..., 4]`` (32-bit words) under
    ``key``; returns the four output words ``[..., 4]`` as int64."""
    c0, c1, c2, c3 = counter.unbind(-1)
    k0, k1 = key
    for _ in range(ROUNDS):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return torch.stack((c0, c1, c2, c3), dim=-1)


def uniform(
    key: PhiloxKey, offset: int, n: int, device: Optional[torch.device] = None
) -> torch.Tensor:
    """Elements ``offset .. offset + n`` of the key's U[0,1) stream, fp32."""
    check_key(key, offset)
    if n == 0:
        return torch.empty(0, dtype=torch.float32, device=device)
    first = offset // 4
    ctr = torch.arange(first, (offset + n - 1) // 4 + 1, dtype=torch.int64, device=device)
    zero = torch.zeros_like(ctr)
    bits = philox4x32(torch.stack((ctr & _MASK32, ctr >> 32, zero, zero), -1), key)
    start = offset - 4 * first
    bits = bits.reshape(-1)[start : start + n]
    return (bits >> 8).to(torch.float32) * 2.0**-24
