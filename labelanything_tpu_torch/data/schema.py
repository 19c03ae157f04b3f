"""Episode-schema helpers (host side, NumPy), a copy of
``labelanything_tpu/data/schema.py`` (reference:
label_anything/data/utils.py, flags_merge and the padding semantics).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..typing import IGNORE_INDEX


def flags_merge(
    flag_masks: Optional[np.ndarray] = None,
    flag_points: Optional[np.ndarray] = None,
    flag_bboxes: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Merge per-modality flags into example flags (M, C)
    (reference: data/utils.py:68-100). Background class is forced present."""
    if flag_masks is None and flag_points is None and flag_bboxes is None:
        raise ValueError("At least one of the flags must be provided.")
    parts = []
    if flag_points is not None:
        parts.append(flag_points.any(axis=-1))
    if flag_bboxes is not None:
        parts.append(flag_bboxes.any(axis=-1))
    if flag_masks is not None:
        parts.append(flag_masks.astype(bool))
    merged = np.stack(parts, axis=0).any(axis=0) if len(parts) > 1 else np.asarray(parts[0], bool)
    merged = merged.astype(np.int64)
    merged[..., :, 0] = 1  # bg always present
    return merged


def pad_ground_truth(gt: np.ndarray, out_hw) -> np.ndarray:
    """Bottom/right-pad a (h, w) gt map to ``out_hw`` with IGNORE_INDEX
    (matches the reference collate's -100 fill, data/utils.py:273-402)."""
    h, w = gt.shape
    out = np.full(out_hw, IGNORE_INDEX, dtype=np.int32)
    out[:h, :w] = gt
    return out
