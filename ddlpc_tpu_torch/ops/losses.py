"""Segmentation losses, mirroring ``ddlpc_tpu/ops/losses.py``.

Logits are ``[..., C]`` (any float dtype; every reduction runs in float32),
labels ``[...]`` integers with ``-1`` for void pixels.  In
:func:`nll_correct_valid` the labels broadcast over leading axes of the
logits (a deep-supervision stack ``[J, ...]``), as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _clipped(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    return labels.clamp(0, num_classes - 1).long().unsqueeze(-1)


def nll_correct_valid(
    logits: torch.Tensor,
    labels: torch.Tensor,
    ignore_index: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-pixel (NLL, tie-corrected correctness, validity) in one pass —
    the train step's loss and accuracy inputs, with the reference's
    arithmetic: the row max in the logits' dtype, ``lse = m + log Σ
    exp(l − m)`` in float32, ``nll = lse − m − (l_label − m)``, and a pixel
    counting ``1/#tied`` when its label's logit equals the row max.
    ``valid`` has the labels' shape."""
    num_classes = logits.shape[-1]
    idx = _clipped(labels, num_classes).expand(*logits.shape[:-1], 1)
    m = logits.amax(dim=-1)
    mf = m.float()
    zf = logits.float() - mf.unsqueeze(-1)
    lse = mf + torch.log(torch.exp(zf).sum(dim=-1))
    picked = zf.gather(-1, idx).squeeze(-1)
    nll = lse - mf - picked
    is_max = logits == m.unsqueeze(-1)
    ties = is_max.sum(dim=-1).float()
    label_is_max = is_max.gather(-1, idx).squeeze(-1).float()
    correct = label_is_max / torch.clamp_min(ties, 1.0)
    if ignore_index is None:
        valid = torch.ones_like(nll)
    else:
        valid = (labels != ignore_index).float()
    return nll, correct, valid


def softmax_cross_entropy_sum(
    logits: torch.Tensor,
    labels: torch.Tensor,
    ignore_index: Optional[int] = None,
    label_smoothing: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(summed NLL, valid-pixel count) — the eval path's globally
    pixel-weighted loss: sum both over batches, divide once.  With
    ``label_smoothing`` ε the NLL is ``(1 − ε)·nll + ε·(lse − mean(l))``,
    as the reference's ``_per_pixel_nll``; at 0 it is the plain NLL."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    nll = lse - lf.gather(-1, _clipped(labels, logits.shape[-1])).squeeze(-1)
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll + label_smoothing * (lse - lf.mean(dim=-1))
    if ignore_index is None:
        valid = torch.ones_like(nll)
    else:
        valid = (labels != ignore_index).float()
    return (nll * valid).sum(), valid.sum()


def softmax_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    ignore_index: Optional[int] = None,
    label_smoothing: float = 0.0,
) -> torch.Tensor:
    """Mean pixel cross-entropy over the valid pixels (torch's
    ``CrossEntropyLoss`` mean), the reference's ``softmax_cross_entropy``:
    :func:`softmax_cross_entropy_sum` over its count, at least 1."""
    nll_sum, count = softmax_cross_entropy_sum(logits, labels, ignore_index, label_smoothing)
    return nll_sum / torch.clamp_min(count, 1.0)
