"""Segmentation metrics from confusion matrices (counterpart of the
device-side part of ``labelanything_tpu/train/metrics.py``; reference:
label_anything/utils/metrics.py:28-52).

Counts are added with ``index_add_`` at ``target * C + prediction``,
IGNORE_INDEX pixels adding 0, so that no count waits for the device (a
``bincount`` or a boolean index would: they size their output on the
host); the JAX package's one-hot matmuls were a device of the TPU. All
counts are int64.

The host half is the JAX module's numpy functions that ``Run`` reads its
matrices with (``strict_mean_iou_np``, ``mean_iou_np``, ``fb_iou_np``) and
``experiment/run.py``'s episode-to-global class tables and confusion folds;
the numpy counts (``global_confusion``, ``fold_global_confusion``,
``binary_confusion_np``) are the plain form of what ``Run`` folds on the
device.
The other protocols' metrics (JAX ``train/metrics.py:180-307``) close the
module: the numpy classes ``PmIoU``, ``ImIoU`` and ``StreamingBinaryAUC``,
and ``dm_iou`` / ``macro_f1`` of a confusion matrix, numpy or tensor.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
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
    counts = torch.zeros(b * c * c, dtype=torch.long, device=preds.device)
    counts.index_add_(0, index.reshape(-1), valid.reshape(-1).long())
    return counts.reshape(b, c, c)


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
    counts = torch.zeros(4, dtype=torch.long, device=preds.device)
    counts.index_add_(0, (t * 2 + p).reshape(-1), valid.reshape(-1).long())
    return counts.reshape(2, 2)


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


# -- host side (numpy) ------------------------------------------------------ #

def _np_iou_per_class(confmat) -> Tuple[np.ndarray, np.ndarray]:
    cm = np.asarray(confmat, dtype=np.float64)
    tp = np.diagonal(cm)
    union = cm.sum(axis=0) + cm.sum(axis=1) - tp
    valid = union > 0
    iou = np.where(valid, tp / np.maximum(union, 1), 0.0)
    return iou, valid


def mean_iou_np(confmat) -> float:
    iou, valid = _np_iou_per_class(confmat)
    return float(iou.sum() / max(valid.sum(), 1))


def strict_mean_iou_np(confmat) -> float:
    """:func:`strict_mean_iou` in float64 numpy."""
    iou, valid = _np_iou_per_class(confmat)
    macro = iou.sum() / max(valid.sum(), 1)
    cm = np.asarray(confmat, dtype=np.float64)
    c = cm.shape[0]
    bg_union = cm[0, 0] + cm[0, 1:].sum() + cm[1:, 0].sum()
    bg_iou = cm[0, 0] / max(bg_union, 1)
    return float((macro * c - bg_iou) / (c - 1))


def fb_iou_np(confmat2) -> float:
    cm = np.asarray(confmat2, dtype=np.float64)
    tp = cm[1, 1]
    union = cm[1, 0] + cm[0, 1] + tp
    return float(tp / max(union, 1))


def to_global_lut(classes: List[List[List[int]]], categories: Dict[int, dict],
                  num_episode_classes: int) -> np.ndarray:
    """Per-sample table episode class index -> global class index
    (reference: data/utils.py:568-589), (B, C_episode) int64. The global
    index follows the categories' insertion order.

    The reference substitutes in place, one episode index at a time, so a
    global value written earlier that equals a later episode index is
    substituted again (episode ranks (2, 5): local 1 -> 2 -> 5). The
    published numbers were measured so, and the table keeps it."""
    global_index = {cid: i + 1 for i, cid in enumerate(categories.keys())}
    b = len(classes)
    lut = np.zeros((b, num_episode_classes), np.int64)
    for i, sample_classes in enumerate(classes):
        episode_cats = sorted(set(
            c for img_classes in sample_classes for c in img_classes))
        for k in range(num_episode_classes):
            v = k
            for j, cid in enumerate(episode_cats):
                if v == j + 1:
                    v = global_index.get(cid, v)
            lut[i, k] = v
    return lut


def global_confusion(preds: np.ndarray, gts: np.ndarray, lut: np.ndarray,
                     num_global: int) -> np.ndarray:
    """Map full-resolution episode predictions and targets through the
    tables and count one global (G, G) matrix."""
    b = preds.shape[0]
    cm = np.zeros((num_global, num_global), np.int64)
    for i in range(b):
        valid = gts[i] != IGNORE_INDEX
        p = lut[i][np.clip(preds[i][valid], 0, lut.shape[1] - 1)]
        t = lut[i][np.clip(gts[i][valid], 0, lut.shape[1] - 1)]
        idx = t * num_global + p
        cm += np.bincount(idx, minlength=num_global * num_global).reshape(
            num_global, num_global)
    return cm


def fold_global_confusion(cm: np.ndarray, cm_ps: np.ndarray, lut: np.ndarray,
                          num_global: int) -> np.ndarray:
    """Fold per-sample episode matrices (B, C_ep, C_ep) into the global
    matrix ``cm`` through the tables, in place: the counts of
    :func:`global_confusion` at C_ep ** 2 work per sample."""
    b = cm_ps.shape[0]
    for i in range(b):
        idx = lut[i][:, None] * num_global + lut[i][None, :]
        cm += np.bincount(
            idx.ravel(), weights=cm_ps[i].ravel(),
            minlength=num_global * num_global,
        ).reshape(num_global, num_global).astype(np.int64)
    return cm


def binary_confusion_np(preds: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """Foreground / background counts (2, 2) of numpy arrays."""
    valid = gts != IGNORE_INDEX
    p = (preds[valid] > 0).astype(np.int64)
    t = (gts[valid] > 0).astype(np.int64)
    return np.bincount(t * 2 + p, minlength=4).reshape(2, 2)


# -- the other protocols' metrics (reference: utils/metrics.py:54-392,
# metrics.py) --------------------------------------------------------------- #

class PmIoU:
    """PANet-protocol mean IoU (reference: utils/metrics.py:54-168 PmIoU).

    Per sample and class, TP / FP / FN are counted only when the class
    appears in that sample's target; the IoU of summed counts per class is
    averaged over the requested labels."""

    def __init__(self, max_label: int = 20):
        self.n = max_label + 1
        self.tp = np.zeros(self.n)
        self.fp = np.zeros(self.n)
        self.fn = np.zeros(self.n)
        self.present = np.zeros(self.n, bool)

    def update(self, pred, target):
        pred, target = np.asarray(pred), np.asarray(target)
        if pred.ndim == 3:
            for i in range(pred.shape[0]):
                self.update(pred[i], target[i])
            return
        valid = target != IGNORE_INDEX
        for label in range(self.n):
            t = target == label
            if not t.any():
                continue
            p = (pred == label) & valid
            self.present[label] = True
            self.tp[label] += np.sum(p & t)
            self.fp[label] += np.sum(p & ~t)
            self.fn[label] += np.sum(t & ~p)

    def compute(self, labels=None) -> float:
        labels = np.asarray(labels if labels is not None
                            else range(1, self.n))
        keep = labels[self.present[labels]]
        if keep.size == 0:
            return float("nan")
        iou = self.tp[keep] / (self.tp[keep] + self.fp[keep] + self.fn[keep])
        return float(iou.mean())


def dm_iou(confmat, eps: float = 1e-8) -> torch.Tensor:
    """DENet-protocol mean IoU (reference: utils/metrics.py:216-254 DmIoU):
    the plain mean over all classes, background included, with the union
    clipped at ``eps``, so that an absent class counts 0. ``confmat``: a
    numpy array or a tensor; a float32 scalar tensor comes back."""
    cm = torch.as_tensor(confmat)
    tp = cm.diagonal().float()
    union = (cm.sum(dim=0) + cm.sum(dim=1) - cm.diagonal()).float()
    return (tp / union.clamp_min(eps)).mean()


class ImIoU:
    """ASNet-protocol mean IoU (reference: utils/metrics.py:258-360 ImIoU):
    per-episode intersection / union histograms over local ids are added
    onto global class slots; mIoU is the mean over the classes of interest
    of inter / max(union, 1)."""

    def __init__(self, class_ids, nclass: int = 20):
        self.class_ids = np.asarray(class_ids)
        self.inter = np.zeros(nclass + 1)
        self.union = np.zeros(nclass + 1)

    def update(self, pred, target, class_map):
        """``pred`` / ``target`` (H, W) in local ids 0..way; ``class_map``
        (way + 1,) local -> global (index 0 the background)."""
        way = len(class_map) - 1
        pred, target = np.asarray(pred), np.asarray(target)
        in_range = lambda x: (x >= 0) & (x <= way)
        inter = np.bincount(
            pred[(pred == target) & in_range(pred)].astype(int),
            minlength=way + 1)[: way + 1]
        a_p = np.bincount(pred[in_range(pred)].astype(int),
                          minlength=way + 1)[: way + 1]
        a_t = np.bincount(target[in_range(target)].astype(int),
                          minlength=way + 1)[: way + 1]
        np.add.at(self.inter, class_map, inter)
        np.add.at(self.union, class_map, a_p + a_t - inter)

    def compute(self) -> float:
        inter = self.inter[self.class_ids]
        union = self.union[self.class_ids]
        return float(np.mean(inter / np.maximum(union, 1.0)))


def macro_f1(confmat) -> torch.Tensor:
    """Macro F1 over the classes with support (torchmetrics' macro F1,
    reference: metrics.py F1). ``confmat``: a numpy array or a tensor; a
    float32 scalar tensor comes back."""
    cm = torch.as_tensor(confmat)
    tp = cm.diagonal()
    denom = 2 * tp + (cm.sum(dim=0) - tp) + (cm.sum(dim=1) - tp)
    valid = denom > 0
    f1 = torch.where(valid, 2 * tp / denom.clamp_min(1), 0.0).float()
    return f1.sum() / valid.sum().clamp_min(1)


class StreamingBinaryAUC:
    """Binary AUROC from score histograms (reference: metrics.py AUC over
    torchmetrics' AUROC): scores fall into ``bins`` buckets and the AUC is
    the trapezoidal integral of the ROC, exact when the scores take at
    most ``bins`` distinct values, else within O(1 / bins)."""

    def __init__(self, bins: int = 512):
        self.bins = bins
        self.pos = np.zeros(bins)
        self.neg = np.zeros(bins)

    def update(self, scores, target):
        """``scores`` in [0, 1]; ``target`` binary {0, 1}."""
        scores = np.clip(np.asarray(scores).reshape(-1), 0.0, 1.0)
        target = np.asarray(target).reshape(-1)
        idx = np.minimum((scores * self.bins).astype(int), self.bins - 1)
        self.pos += np.bincount(idx[target == 1], minlength=self.bins)
        self.neg += np.bincount(idx[target == 0], minlength=self.bins)

    def compute(self) -> float:
        tp = np.cumsum(self.pos[::-1])
        fp = np.cumsum(self.neg[::-1])
        if tp[-1] == 0 or fp[-1] == 0:
            return float("nan")
        tpr = np.concatenate([[0.0], tp / tp[-1]])
        fpr = np.concatenate([[0.0], fp / fp[-1]])
        trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2
        return float(trapezoid(tpr, fpr))
