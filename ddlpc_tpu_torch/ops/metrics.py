"""Segmentation metrics, mirroring ``ddlpc_tpu/ops/metrics.py``."""

from __future__ import annotations

import torch


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
