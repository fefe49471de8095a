"""Segmentation metrics, mirroring ``ddlpc_tpu/ops/metrics.py``."""

from __future__ import annotations

from typing import Optional

import torch


def pixel_accuracy(
    logits: torch.Tensor, labels: torch.Tensor, ignore_index: Optional[int] = None
) -> torch.Tensor:
    """Share of pixels whose label's logit is the row max, an exact tie
    counting 1/#tied (the chance a uniform tie-break picks the label), over
    the pixels whose label is not ``ignore_index`` (all without one)."""
    lf = logits.float()
    idx = labels.clamp(0, logits.shape[-1] - 1).long().unsqueeze(-1)
    picked = lf.gather(-1, idx).squeeze(-1)
    row_max = lf.amax(dim=-1)
    ties = (lf == row_max.unsqueeze(-1)).sum(dim=-1).float()
    correct = (picked >= row_max).float() / torch.clamp_min(ties, 1.0)
    if ignore_index is None:
        return correct.mean()
    valid = (labels != ignore_index).float()
    return (correct * valid).sum() / torch.clamp_min(valid.sum(), 1.0)


def confusion_matrix(
    preds: torch.Tensor,
    labels: torch.Tensor,
    num_classes: int,
) -> torch.Tensor:
    """[C, C] float32 counts, rows = true class, cols = predicted class;
    labels outside [0, C) (e.g. void ``-1``) are not counted."""
    preds = preds.reshape(-1).long()
    labels = labels.reshape(-1).long()
    valid = (labels >= 0) & (labels < num_classes)
    idx = labels[valid] * num_classes + preds[valid].clamp(0, num_classes - 1)
    flat = torch.bincount(idx, minlength=num_classes * num_classes)
    return flat.float().reshape(num_classes, num_classes)


def confusion_from_logits(
    logits: torch.Tensor, labels: torch.Tensor, num_classes: int
) -> torch.Tensor:
    return confusion_matrix(logits.argmax(dim=-1), labels, num_classes)


def iou_per_class(cm: torch.Tensor) -> torch.Tensor:
    """Per-class IoU; classes absent from labels and predictions get 0."""
    tp = torch.diagonal(cm)
    denom = cm.sum(dim=0) + cm.sum(dim=1) - tp
    return torch.where(denom > 0, tp / torch.clamp_min(denom, 1.0), torch.zeros_like(tp))


def mean_iou(cm: torch.Tensor, present_only: bool = True) -> torch.Tensor:
    """mIoU; ``present_only`` averages over classes that occur in labels or
    predictions."""
    ious = iou_per_class(cm)
    if not present_only:
        return ious.mean()
    present = ((cm.sum(dim=0) + cm.sum(dim=1)) > 0).to(ious.dtype)
    return (ious * present).sum() / torch.clamp_min(present.sum(), 1.0)


def accuracy_from_confusion(cm: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(cm).sum() / torch.clamp_min(cm.sum(), 1.0)
