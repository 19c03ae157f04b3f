"""Bilinear resize (counterpart of ``labelanything_tpu/ops/resize.py``).

The JAX version emulates ``F.interpolate(mode="bilinear",
align_corners=False)`` with two interpolation matmuls for the TPU; here it
is ``F.interpolate`` itself.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Sequence[int],
                    spatial_axes=(-2, -1)) -> torch.Tensor:
    """Bilinear resize of the two ``spatial_axes`` of ``x`` to ``size``
    (H, W), half-pixel centres, no antialiasing. ``spatial_axes`` is
    (-2, -1) for (..., H, W) or (1, 2) for channels-last (N, H, W, C)."""
    axes = [a % x.dim() for a in spatial_axes]
    size = (int(size[0]), int(size[1]))
    if axes == [x.dim() - 2, x.dim() - 1]:
        lead = x.shape[:-2]
        y = F.interpolate(x.reshape((-1, 1) + x.shape[-2:]), size=size,
                          mode="bilinear", align_corners=False)
        return y.reshape(lead + size)
    if x.dim() == 4 and axes == [1, 2]:
        y = F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="bilinear",
                          align_corners=False)
        return y.permute(0, 2, 3, 1)
    raise ValueError(f"unsupported spatial axes {spatial_axes} for a "
                     f"{x.dim()}-D input")
