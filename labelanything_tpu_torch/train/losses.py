"""Segmentation losses (counterpart of ``labelanything_tpu/train/losses.py``;
reference: label_anything/loss/).

Every loss takes ``logits`` (B, C, H, W), which may hold -inf at masked
classes or padded pixels, and ``target`` (B, H, W) integer with
IGNORE_INDEX padding. -inf logits are clamped to the dtype's minimum
before any softmax, so they neither poison the log-sum-exp nor receive a
gradient. Per-pixel class lookups are plain gathers here; the JAX package
spells them as one-hot contractions for the TPU.

``LabelAnythingLoss`` is an ``nn.Module``: it owns the learnable SigLIP
temperature and bias of the prompt-contrastive component. The ``rmi``,
``masks`` and symmetric losses of the JAX package are not ported yet.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..typing import BatchKeys, IGNORE_INDEX, LossDict, ResultDict


def _valid_mask(target: torch.Tensor) -> torch.Tensor:
    return target != IGNORE_INDEX


def _safe_target(target: torch.Tensor) -> torch.Tensor:
    return torch.where(_valid_mask(target), target, 0).long()


def _clamp(logits: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(logits, torch.finfo(logits.dtype).min)


def _onehot(target: torch.Tensor, num_classes: int,
            dtype: torch.dtype) -> torch.Tensor:
    """(B, C, H, W) one-hot of the target, zero at ignored pixels."""
    oh = F.one_hot(_safe_target(target), num_classes).to(dtype)
    return (oh * _valid_mask(target)[..., None]).movedim(-1, 1)


def cross_entropy_per_pixel(logits: torch.Tensor,
                            target: torch.Tensor) -> torch.Tensor:
    """Per-pixel cross entropy (B, H, W); ignored pixels give 0."""
    logp = F.log_softmax(_clamp(logits), dim=1)
    ce = -logp.gather(1, _safe_target(target)[:, None])[:, 0]
    return torch.where(_valid_mask(target), ce, 0.0)


def get_weight_matrix_from_labels(target: torch.Tensor, num_classes: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse-log-frequency pixel weights (reference: loss/utils.py:17-43):
    (weight_matrix (B, H, W), class_weights (C,))."""
    valid = _valid_mask(target)
    safe = _safe_target(target)
    counts = torch.bincount(safe[valid], minlength=num_classes).float()
    total = counts.sum()
    freq_w = 1.0 / torch.log(1.1 + counts / total.clamp_min(1.0))
    class_weights = torch.where(counts > 0, freq_w, 1.0)
    return class_weights[safe] * valid, class_weights


def focal_loss(logits: torch.Tensor, target: torch.Tensor, gamma: float = 2.0,
               weight_matrix: Optional[torch.Tensor] = None,
               **_: Any) -> torch.Tensor:
    """(reference: loss/focal.py:8-25); the mean runs over ALL pixels,
    ignored ones included (they contribute 0), as the reference's does."""
    ce = cross_entropy_per_pixel(logits, target)
    focal = (1.0 - torch.exp(-ce)) ** gamma * ce
    if weight_matrix is not None:
        focal = focal * weight_matrix
    return focal.sum() / max(target.numel(), 1)


def dice_loss(logits: torch.Tensor, target: torch.Tensor,
              average: str = "macro",
              class_weights: Optional[torch.Tensor] = None, eps: float = 1e-6,
              **_: Any) -> torch.Tensor:
    """Sorensen-Dice loss (reference: loss/dice.py:11-123)."""
    probs = F.softmax(_clamp(logits), dim=1)
    onehot = _onehot(target, logits.shape[1], probs.dtype)
    dims = (2, 3) if average == "macro" else (1, 2, 3)
    intersection = (probs * onehot).sum(dim=dims)
    cardinality = (probs + onehot).sum(dim=dims)
    loss = 1.0 - (2.0 * intersection + eps) / (cardinality + eps)
    if average != "macro":
        return loss.mean()
    if class_weights is not None:
        loss = loss * class_weights[None, :]
    return loss.mean(dim=1).mean()


def false_positive_loss(logits: torch.Tensor, target: torch.Tensor,
                        eps: float = 1e-6, **_: Any) -> torch.Tensor:
    """Suppress probability mass on classes absent from each sample's
    ground truth (reference: loss/fp.py:10-36)."""
    valid = _valid_mask(target)
    onehot = _onehot(target, logits.shape[1], torch.float32)
    not_included = 1.0 - (onehot.sum(dim=(2, 3)) > 0).float()       # (B, C)
    probs = F.softmax(_clamp(logits), dim=1)
    fp = probs * not_included[:, :, None, None] * valid[:, None]
    fp = fp.sum(dim=1) / (not_included.sum(dim=1)[:, None, None] + eps)
    return fp.sum() / valid.sum().clamp_min(1)


def loss_orthogonality(embedding: torch.Tensor,
                       eps: float = 1e-8) -> torch.Tensor:
    """Mean |cosine| between distinct embeddings (reference:
    loss/utils.py:46-66); embedding (B, N, ...)."""
    b, n = embedding.shape[:2]
    flat = embedding.reshape(b, n, -1)
    flat = flat / (torch.linalg.norm(flat, dim=-1, keepdim=True) + eps)
    sim = torch.einsum("bnd,bmd->bnm", flat, flat)
    sim = sim * (1.0 - torch.eye(n, device=sim.device, dtype=sim.dtype))
    return sim.abs().sum() / (b * (n * n - n))


def class_embedding_contrastive_loss(result: Dict[str, torch.Tensor]
                                     ) -> torch.Tensor:
    embs = result[ResultDict.EXAMPLES_CLASS_EMBS]
    b, m, c, d = embs.shape
    return loss_orthogonality(embs.reshape(b, m * c, d))


def prompt_contrastive_loss(result: Dict[str, torch.Tensor],
                            t_prime: torch.Tensor,
                            bias: torch.Tensor) -> torch.Tensor:
    """SigLIP-style contrastive loss over per-example class embeddings
    (reference: loss/prompt.py:12-47)."""
    embs = result[ResultDict.EXAMPLES_CLASS_EMBS]
    b, m, c, d = embs.shape
    flags = result[BatchKeys.FLAG_EXAMPLES].reshape(b, m * c, 1) > 0
    valid_elements = flags.sum(dim=1)                               # (B, 1)
    upper = torch.triu(torch.ones(m * c, m * c, dtype=torch.bool,
                                  device=embs.device), diagonal=1)
    pair_mask = flags & flags.transpose(1, 2) & upper

    x = embs.reshape(b, m * c, d)
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-12)
    dots = torch.einsum("bnd,bmd->bnm", x, x) * torch.exp(t_prime) + bias
    # +1 where two tokens carry the same class (across examples), else -1
    same = torch.eye(c, device=embs.device, dtype=dots.dtype).repeat(m, m)
    loss = -F.logsigmoid(dots * (2.0 * same - 1.0))
    loss = loss / valid_elements[:, :, None].clamp_min(1)
    return torch.where(pair_mask, loss, 0.0).sum() / b


LOGITS_LOSSES = {
    "focal": focal_loss,
    "dice": dice_loss,
    "fp": false_positive_loss,
}
_EMBEDDING_LOSSES = ("prompt_contrastive", "emb_contrastive")


class LabelAnythingLoss(nn.Module):
    """Weighted sum of loss components (reference: loss/__init__.py:30-116).

    ``components`` maps names to keyword dicts that each hold ``weight``,
    e.g. ``{"focal": {"weight": 1.0, "gamma": 2.0}}``. The logits are cast
    to fp32 first: the model may compute in bf16, the loss never does.
    Returns ``{LossDict.VALUE: total, LossDict.COMPONENTS: {name: value}}``.
    """

    def __init__(self, components: Dict[str, Dict[str, Any]],
                 class_weighting: bool = False):
        super().__init__()
        for name in components:
            if name not in LOGITS_LOSSES and name not in _EMBEDDING_LOSSES:
                raise ValueError(f"Unknown or unported loss component "
                                 f"{name!r}")
        self.components = {k: dict(v) for k, v in components.items()}
        self.class_weighting = class_weighting
        if "prompt_contrastive" in self.components:
            self.t_prime = nn.Parameter(torch.full((1,), math.log(10.0)))
            self.bias = nn.Parameter(torch.full((1,), -10.0))

    def forward(self, result, target: torch.Tensor) -> Dict[str, Any]:
        is_dict = isinstance(result, dict)
        logits = (result[ResultDict.LOGITS] if is_dict else result).float()
        weight_matrix = class_weights = None
        if self.class_weighting:
            weight_matrix, class_weights = get_weight_matrix_from_labels(
                target, logits.shape[1])

        total = 0.0
        parts: Dict[str, torch.Tensor] = {}
        for name, cfg in self.components.items():
            cfg = dict(cfg)
            weight = cfg.pop("weight")
            if name in LOGITS_LOSSES:
                value = LOGITS_LOSSES[name](
                    logits, target, weight_matrix=weight_matrix,
                    class_weights=class_weights, **cfg)
            elif name == "prompt_contrastive":
                value = prompt_contrastive_loss(result, self.t_prime,
                                                self.bias)
            else:
                value = class_embedding_contrastive_loss(result)
            parts[name] = value
            total = total + weight * value
        return {LossDict.VALUE: total, LossDict.COMPONENTS: parts}
