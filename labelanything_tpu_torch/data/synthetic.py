"""Synthetic episodes (counterpart of ``labelanything_tpu/data/synthetic.py``;
reference: label_anything/data/utils.py random_batch).

The same numpy draws in the same order as the JAX package's
``random_batch`` and ``random_full_batch``, so one seed gives the same
episode in both packages.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..typing import IGNORE_INDEX, BatchKeys


def flags_merge(flag_masks: Optional[np.ndarray],
                flag_points: Optional[np.ndarray],
                flag_bboxes: Optional[np.ndarray]) -> np.ndarray:
    """(..., C) example flags: a class counts where any modality has a
    prompt; the background (class 0) always does (reference:
    data/utils.py:68-100)."""
    parts = [f.any(axis=-1) for f in (flag_points, flag_bboxes)
             if f is not None]
    if flag_masks is not None:
        parts.append(flag_masks.astype(bool))
    if not parts:
        raise ValueError("At least one of the flags must be provided.")
    merged = np.any(parts, axis=0).astype(np.int64)
    merged[..., 0] = 1
    return merged


def random_batch(batch_size: int = 2, num_examples: int = 1,
                 num_classes: int = 2, num_points: int = 2,
                 image_size: int = 480, embed_dim: int = 768,
                 patch_size: int = 16, include_points: bool = True,
                 include_boxes: bool = True, include_masks: bool = True,
                 with_images: bool = False, seed: int = 0,
                 gt_size: Optional[int] = None) -> Dict[str, np.ndarray]:
    """A random channels-last episode of numpy arrays: ``images``
    (B, M+1, S, S, 3) or ``embeddings`` (B, M+1, S/16, S/16, D), index 0 the
    query; prompts and flags over (B, M, C); ``dims`` (B, M+1, 2) with the
    width cut to 0.9 S, so every image has a padded band on the right."""
    rng = np.random.default_rng(seed)
    b, m, c, n, s = batch_size, num_examples, num_classes, num_points, image_size
    grid = s // patch_size
    batch: Dict[str, np.ndarray] = {}
    if with_images:
        batch[BatchKeys.IMAGES] = rng.standard_normal((b, m + 1, s, s, 3),
                                                      dtype=np.float32)
    else:
        batch[BatchKeys.EMBEDDINGS] = rng.standard_normal(
            (b, m + 1, grid, grid, embed_dim), dtype=np.float32)

    flag_masks = flag_points = flag_bboxes = None
    if include_masks:
        batch[BatchKeys.PROMPT_MASKS] = rng.integers(
            0, 2, (b, m, c, s // 4, s // 4)).astype(np.float32)
        flag_masks = batch[BatchKeys.FLAG_MASKS] = rng.integers(
            0, 2, (b, m, c)).astype(np.int32)
    if include_points:
        batch[BatchKeys.PROMPT_POINTS] = rng.uniform(
            0, s, (b, m, c, n, 2)).astype(np.float32)
        flag_points = batch[BatchKeys.FLAG_POINTS] = rng.integers(
            0, 2, (b, m, c, n)).astype(np.int32)
    if include_boxes:
        x0 = rng.uniform(0, s / 2, (b, m, c, n, 2))
        wh = rng.uniform(1, s / 2, (b, m, c, n, 2))
        batch[BatchKeys.PROMPT_BBOXES] = np.concatenate(
            [x0, x0 + wh], axis=-1).astype(np.float32)
        flag_bboxes = batch[BatchKeys.FLAG_BBOXES] = rng.integers(
            0, 2, (b, m, c, n)).astype(np.int32)
    batch[BatchKeys.FLAG_EXAMPLES] = flags_merge(
        flag_masks, flag_points, flag_bboxes).astype(np.int32)

    g = gt_size or s
    gt = rng.integers(0, c, (b, g, g)).astype(np.int32)
    gt[:, :, int(g * 0.9):] = IGNORE_INDEX
    batch[BatchKeys.GROUND_TRUTHS] = gt
    batch[BatchKeys.FLAG_GTS] = np.ones((b, c), dtype=bool)
    batch[BatchKeys.DIMS] = np.tile(np.asarray([s, int(s * 0.9)], np.int32),
                                    (b, m + 1, 1))
    return batch


def random_full_batch(**kw) -> Dict[str, np.ndarray]:
    """The training loop's variant of :func:`random_batch`: prompt tensors
    and ``ground_truths`` (B, M+1, G, G) carry the full image axis, the
    query slot included, as the Substitutor consumes them."""
    kw.setdefault("num_examples", 1)
    m = kw["num_examples"]
    kw["num_examples"] = m + 1
    batch = random_batch(**kw)
    b = batch[BatchKeys.DIMS].shape[0]
    g = kw.get("gt_size") or kw.get("image_size", 480)
    c = kw.get("num_classes", 2)
    rng = np.random.default_rng(kw.get("seed", 0) + 1)
    gt = rng.integers(0, c, (b, m + 1, g, g)).astype(np.int32)
    gt[:, :, :, int(g * 0.9):] = IGNORE_INDEX
    batch[BatchKeys.GROUND_TRUTHS] = gt
    # random_batch made M + 2 images; the episode has M + 1
    for key in (BatchKeys.EMBEDDINGS, BatchKeys.IMAGES, BatchKeys.DIMS):
        if key in batch:
            batch[key] = batch[key][:, :m + 1]
    return batch


def flag_every_class(full: Dict[str, np.ndarray],
                     shots: int) -> Dict[str, np.ndarray]:
    """A full batch whose example j (1-based on the image axis) shows class
    1 + (j - 1) // shots by a mask prompt, as an episode of ways x shots
    examples does, so every class has a flagged example (the port's own:
    a class with none has no finite affinity logit, and its pixels an
    infinite training loss)."""
    masks = full[BatchKeys.FLAG_MASKS].copy()
    flags = full[BatchKeys.FLAG_EXAMPLES].copy()
    for j in range(1, masks.shape[1]):
        masks[:, j, 1 + (j - 1) // shots] = 1
        flags[:, j, 1 + (j - 1) // shots] = 1
    return dict(full, **{BatchKeys.FLAG_MASKS: masks,
                         BatchKeys.FLAG_EXAMPLES: flags})
