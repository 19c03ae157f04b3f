"""Segmentation metrics from confusion matrices (counterpart of the
device-side part of ``labelanything_tpu/train/metrics.py``; reference:
label_anything/utils/metrics.py:28-52).

Counts come from ``torch.bincount`` over ``target * C + prediction``; the
JAX package's one-hot matmuls were a device of the TPU. All counts are
int64. The JAX package's host-side numpy classes (PmIoU, ImIoU,
StreamingBinaryAUC, dm_iou, macro_f1) are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..typing import IGNORE_INDEX


def confusion_matrix_per_sample(preds: torch.Tensor, target: torch.Tensor,
                                num_classes: int) -> torch.Tensor:
    """(B, H, W) integer predictions and targets -> (B, C, C) counts, rows
    the target class, columns the prediction (clipped to the class range);
    IGNORE_INDEX pixels are left out."""
    b = preds.shape[0]
    c = num_classes
    valid = (target != IGNORE_INDEX).reshape(b, -1)
    t = torch.where(valid, target.reshape(b, -1), 0).long()
    p = preds.reshape(b, -1).long().clamp(0, c - 1)
    sample = torch.arange(b, device=preds.device)[:, None]
    index = (sample * c + t) * c + p
    return torch.bincount(index[valid], minlength=b * c * c).reshape(b, c, c)


def confusion_matrix(preds: torch.Tensor, target: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """(C, C) confusion matrix of a batch."""
    return confusion_matrix_per_sample(preds, target, num_classes).sum(dim=0)


def fold_confusion_global(cm_ps: torch.Tensor, lut: torch.Tensor,
                          num_global: int) -> torch.Tensor:
    """Fold per-sample episode matrices (B, C_ep, C_ep) through per-sample
    episode-to-global class tables (B, C_ep) into one (G, G) matrix."""
    b, c, _ = cm_ps.shape
    lut = lut.long()
    index = lut[:, :, None] * num_global + lut[:, None, :]
    out = torch.zeros(num_global * num_global, dtype=torch.long,
                      device=cm_ps.device)
    out.index_add_(0, index.reshape(-1), cm_ps.reshape(-1).long())
    return out.reshape(num_global, num_global)


def binary_confusion_matrix(preds: torch.Tensor,
                            target: torch.Tensor) -> torch.Tensor:
    """Foreground / background counts (2, 2): every class above 0 is
    foreground (reference: utils/metrics.py:44-51)."""
    valid = target != IGNORE_INDEX
    t = (torch.where(valid, target, 0) > 0).long()
    p = (preds > 0).long()
    return torch.bincount((t * 2 + p)[valid], minlength=4).reshape(2, 2)


def iou_per_class(confmat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(iou (C,), has-support mask (C,))."""
    tp = confmat.diagonal()
    union = confmat.sum(dim=0) + confmat.sum(dim=1) - tp
    valid = union > 0
    return torch.where(valid, tp / union.clamp_min(1), 0.0), valid


def mean_iou(confmat: torch.Tensor) -> torch.Tensor:
    """Macro mIoU over the classes with support."""
    iou, valid = iou_per_class(confmat)
    return iou.sum() / valid.sum().clamp_min(1)


def strict_mean_iou(confmat: torch.Tensor) -> torch.Tensor:
    """The reference's ``StrictMeanIoU`` (utils/metrics.py:28-37): macro
    mIoU over present classes, then ``(macro * C - bg_iou) / (C - 1)`` with
    C the full matrix size, quirk included."""
    macro = mean_iou(confmat)
    c = confmat.shape[0]
    bg_union = confmat[0, 0] + confmat[0, 1:].sum() + confmat[1:, 0].sum()
    bg_iou = confmat[0, 0] / bg_union.clamp_min(1)
    return (macro * c - bg_iou) / (c - 1)


def fb_iou(confmat2: torch.Tensor) -> torch.Tensor:
    """Jaccard index of the foreground from a (2, 2) matrix."""
    tp = confmat2[1, 1]
    return tp / (confmat2[1, 0] + confmat2[0, 1] + tp).clamp_min(1)
