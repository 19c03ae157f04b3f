"""Query / example substitution and error-driven point prompting
(counterpart of ``labelanything_tpu/train/substitutor.py``; reference:
label_anything/experiment/substitution.py).

The raw training batch carries prompts and ground truths for all N images,
the query slot included; :func:`divide_query_examples` strips the query's
prompts before the forward pass. The point axis is extended once, so every
substitution pass sees tensors of one shape. Ground truths live in the
model's fixed frame, so new points need no rescale.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..typing import BatchKeys, IGNORE_INDEX, Label

Batch = Dict[str, torch.Tensor]

_KEYS_TO_EXCHANGE = (
    BatchKeys.PROMPT_POINTS, BatchKeys.PROMPT_MASKS, BatchKeys.PROMPT_BBOXES,
    BatchKeys.FLAG_MASKS, BatchKeys.FLAG_BBOXES, BatchKeys.FLAG_POINTS,
    BatchKeys.FLAG_EXAMPLES, BatchKeys.DIMS, BatchKeys.RESIZED_DIMS,
    BatchKeys.IMAGES, BatchKeys.EMBEDDINGS, BatchKeys.GROUND_TRUTHS)

_KEYS_TO_SEPARATE = (
    BatchKeys.PROMPT_POINTS, BatchKeys.PROMPT_MASKS, BatchKeys.PROMPT_BBOXES,
    BatchKeys.FLAG_MASKS, BatchKeys.FLAG_BBOXES, BatchKeys.FLAG_POINTS,
    BatchKeys.FLAG_EXAMPLES)


def rotation_permutation(it: int, num_examples: int) -> Tuple[int, ...]:
    """The reference's index_tensor (substitution.py:237-252)."""
    if it == num_examples:
        return (num_examples - 1,) + tuple(range(1, num_examples - 1)) + (0,)
    return (it,) + tuple(range(0, it)) + tuple(range(it + 1, num_examples))


def _image_axis(value) -> torch.Tensor:
    """A value's tensor with the image axis: a feature-pyramid cache's
    (a dict of stages) first stage."""
    return next(iter(value.values())) if isinstance(value, dict) else value


def apply_permutation(batch: Batch, perm: Tuple[int, ...]) -> Batch:
    """Permute the image axis of every exchangeable key (of every stage of
    a feature-pyramid cache)."""
    out = dict(batch)
    for key in _KEYS_TO_EXCHANGE:
        if key in out:
            idx = torch.as_tensor(perm, device=_image_axis(out[key]).device)
            value = out[key]
            out[key] = ({s: v.index_select(1, idx) for s, v in value.items()}
                        if isinstance(value, dict)
                        else value.index_select(1, idx))
    return out


def divide_query_examples(batch: Batch) -> Tuple[Batch, torch.Tensor]:
    """Strip the query slot's prompts; the ground truth is the query's."""
    out = {}
    for key, value in batch.items():
        if key in _KEYS_TO_SEPARATE:
            out[key] = value[:, 1:]
        elif key != BatchKeys.GROUND_TRUTHS:
            out[key] = value
    return out, batch[BatchKeys.GROUND_TRUTHS][:, 0]


def generate_points_from_errors(preds: torch.Tensor,
                                ground_truth: torch.Tensor,
                                generator: Optional[torch.Generator],
                                num_classes: int, num_points: int = 1
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample correction points per (sample, class) from prediction errors.

    Returns (points (B, C, n, 2) xy, labels (B, C, n) in {-1, 0, 1}): +1
    where the model missed the class, -1 where it hallucinated it, 0 when
    the class has no errors (or fewer than n). Error pixels are drawn
    without replacement by a Gumbel top-k, as in the JAX package."""
    b, h, w = preds.shape
    c = num_classes
    valid = ground_truth != IGNORE_INDEX
    gt = torch.where(valid, ground_truth, 0).long()
    gt_onehot = F.one_hot(gt, c) * valid[..., None]
    pred_onehot = F.one_hot(preds.long().clamp(0, c - 1), c) * valid[..., None]
    err_flat = (gt_onehot - pred_onehot).permute(0, 3, 1, 2).reshape(b, c, h * w)
    has_error = err_flat != 0

    uniform = torch.rand(err_flat.shape, generator=generator,
                         device=None if generator is None
                         else generator.device).to(preds.device)
    gumbel = -torch.log(-torch.log(uniform.clamp(1e-20, 1.0 - 1e-7)))
    scores = torch.where(has_error, gumbel, float("-inf"))
    idx = scores.topk(num_points, dim=-1).indices                # (B, C, n)
    any_error = has_error.any(dim=-1)[..., None]                 # (B, C, 1)

    labels = torch.where(any_error, err_flat.gather(-1, idx), 0)
    points = torch.stack([(idx % w).float(), (idx // w).float()], dim=-1)
    points = torch.where(any_error[..., None], points, 0.0)
    # the background row never receives points (reference: l.94-95)
    labels[:, 0] = int(Label.NULL)
    return points, labels.int()


def preallocate_point_slots(batch: Batch, extra: int) -> Batch:
    """Extend the point axis by ``extra`` NULL slots, so that later
    error-point writes keep every tensor's shape."""
    out = dict(batch)
    pts, flags = out[BatchKeys.PROMPT_POINTS], out[BatchKeys.FLAG_POINTS]
    out[BatchKeys.PROMPT_POINTS] = torch.cat(
        [pts, pts.new_zeros(pts.shape[:3] + (extra, 2))], dim=3)
    out[BatchKeys.FLAG_POINTS] = torch.cat(
        [flags, flags.new_zeros(flags.shape[:3] + (extra,))], dim=3)
    return out


def write_query_points(batch: Batch, points: torch.Tensor,
                       labels: torch.Tensor, slot: int) -> Batch:
    """Write error points into the query slot's (image 0) preallocated
    point slots ``slot .. slot + n``; returns a new batch."""
    out = dict(batch)
    n = points.shape[2]
    pts = out[BatchKeys.PROMPT_POINTS].clone()
    flags = out[BatchKeys.FLAG_POINTS].clone()
    pts[:, 0, :, slot:slot + n] = points.to(pts.dtype)
    flags[:, 0, :, slot:slot + n] = labels.to(flags.dtype)
    out[BatchKeys.PROMPT_POINTS], out[BatchKeys.FLAG_POINTS] = pts, flags
    return out


class Substitutor:
    """Iterator over the substitution passes of one episode batch
    (reference: substitution.py:99-275).

    The batch handed to :meth:`reset` carries the full N-image axis on
    prompt tensors and GROUND_TRUTHS. Iteration yields ``(batch, gt)`` pairs
    ready for the model; call :meth:`generate_new_points` between passes.
    """

    def __init__(self, num_points: int = 1, substitute: bool = True,
                 threshold: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        self.num_points = num_points
        self.threshold = threshold
        self.substitute = substitute
        self.generator = generator
        self.batch: Optional[Batch] = None
        self.it = 0
        self._slot = 0

    @staticmethod
    def mean_pairwise_jaccard(example_classes) -> float:
        """Mean pairwise Jaccard similarity of the per-example class sets."""
        sets = [set(c) for c in example_classes]
        if len(sets) < 2:
            return 1.0
        vals = []
        for i in range(len(sets)):
            for j in range(i + 1, len(sets)):
                union = sets[i] | sets[j]
                vals.append(len(sets[i] & sets[j]) / len(union)
                            if union else 1.0)
        return sum(vals) / len(vals)

    def calculate_if_substitute(self, classes=None) -> bool:
        """(reference: substitution.py:148-156)."""
        if self.threshold is None or not classes:
            return True
        mean = sum(self.mean_pairwise_jaccard(c) for c in classes) / len(classes)
        return mean > self.threshold

    def reset(self, batch: Batch) -> None:
        self.batch = dict(batch)
        self.it = 0
        if (self.substitute and self.num_points > 0
                and BatchKeys.PROMPT_POINTS in self.batch):
            # one write per pass (N + 1 passes); the last is never read
            extra = self.num_points * (self.num_examples + 1)
            self.batch = preallocate_point_slots(self.batch, extra)
            self._slot = self.batch[BatchKeys.PROMPT_POINTS].shape[3] - extra

    @property
    def num_examples(self) -> int:
        key = (BatchKeys.IMAGES if BatchKeys.IMAGES in self.batch
               else BatchKeys.EMBEDDINGS)
        return _image_axis(self.batch[key]).shape[1]

    def __iter__(self):
        return self

    def __next__(self):
        n = self.num_examples
        if self.it == 0:
            self.it = 1
            return divide_query_examples(self.batch)
        if not self.substitute or self.it == n + 1:
            raise StopIteration
        self.batch = apply_permutation(self.batch,
                                       rotation_permutation(self.it, n))
        self.it += 1
        return divide_query_examples(self.batch)

    def generate_new_points(self, preds: torch.Tensor, gt: torch.Tensor,
                            num_classes: int) -> None:
        """``preds`` are argmax predictions (B, H, W)."""
        if (not self.substitute or self.num_points <= 0
                or BatchKeys.PROMPT_POINTS not in self.batch):
            return
        points, labels = generate_points_from_errors(
            preds, gt, self.generator, num_classes, self.num_points)
        self.batch = write_query_points(self.batch, points, labels, self._slot)
        self._slot += self.num_points
