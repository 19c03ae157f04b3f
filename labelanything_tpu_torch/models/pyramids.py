"""The feature-pyramid neck of ``is_pyramids`` models (counterpart of
``labelanything_tpu/models/pyramids.py``; reference:
label_anything/models/pyramids.py:6-157 and build_lam.py:172-178).

Channels-last: a pyramid is a dict ``{"stageN": (B, H, W, C)}``. Each level
is projected to ``d_model`` by a 1 x 1 conv and a GroupNorm of 32 groups,
gets a sine position embedding and a learned level embedding, is resized
to the finest level (bilinear, half-pixel centres) and the levels are
fused by a 1 x 1 conv. The module names mirror the JAX package's
(``input_projections.{i}`` holds its ``input_proj_i`` and ``input_gn_i``);
:class:`PyramidLamNeck` is the reference's ``nn.Sequential(PyramidNeck,
LayerNorm2d)``, so its two parts are ``0`` and ``1``.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear
from .common import Conv2d, LayerNorm2d

# the levels a neck reads, finest first, and its sine embedding's
# temperature (the reference's defaults, which no configuration changes)
FEATURE_LEVELS = ("stage2", "stage3", "stage4")
TEMPERATURE = 20.0


def pyramid_sine_position_embedding(shape, d_model: int,
                                    device=None) -> torch.Tensor:
    """Sine position embedding of an unmasked (H, W) grid (reference:
    pyramids.py:6-41): (1, H, W, d_model), the y half first."""
    h, w = shape
    half = d_model // 2
    eps = 1e-6
    y = torch.cumsum(torch.ones(h, w, device=device), 0)
    x = torch.cumsum(torch.ones(h, w, device=device), 1)
    y = y / (y[-1:, :] + eps) * (2 * math.pi)
    x = x / (x[:, -1:] + eps) * (2 * math.pi)
    dim_t = torch.arange(half, dtype=torch.float32, device=device)
    dim_t = TEMPERATURE ** (2 * torch.floor(dim_t / 2) / half)

    def sines(pos):
        p = pos[:, :, None] / dim_t
        return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()],
                           dim=-1).reshape(h, w, -1)

    return torch.cat([sines(y), sines(x)], dim=-1)[None]


class PyramidNeck(nn.Module):
    """Project, embed, resize and fuse the levels of
    :data:`FEATURE_LEVELS` that the pyramid holds (reference:
    pyramids.py:44-157)."""

    def __init__(self, intermediate_channel_sizes: Sequence[int],
                 d_model: int = 512, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model = d_model
        self.compute_dtype = dtype
        sizes = tuple(intermediate_channel_sizes)
        self.level_embed = nn.Parameter(torch.zeros(len(sizes), d_model))
        self.input_projections = nn.ModuleList(
            nn.ModuleList([Conv2d(c, d_model, 1, dtype=dtype),
                           nn.GroupNorm(32, d_model, eps=1e-6)])
            for c in sizes)
        self.final_conv = Conv2d(d_model * len(sizes), d_model, 1,
                                 dtype=dtype)

    def _group_norm(self, gn: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
        """flax's GroupNorm: fp32 statistics, output in the compute dtype."""
        y = F.group_norm(x.float().permute(0, 3, 1, 2), gn.num_groups,
                         gn.weight, gn.bias, gn.eps)
        return y.permute(0, 2, 3, 1).to(self.compute_dtype)

    def forward(self, pyramid: Dict[str, torch.Tensor]) -> torch.Tensor:
        levels = [pyramid[k] for k in FEATURE_LEVELS if k in pyramid]
        projected = []
        for i, fm in enumerate(levels):
            conv, gn = self.input_projections[i]
            x = self._group_norm(gn, conv(fm))
            pos = pyramid_sine_position_embedding(x.shape[1:3], self.d_model,
                                                  x.device)
            projected.append(x + pos.to(x.dtype) + self.level_embed[i])
        target = projected[0].shape[1:3]
        for i in range(1, len(projected)):
            projected[i] = resize_bilinear(projected[i], target,
                                           spatial_axes=(1, 2))
        return self.final_conv(torch.cat(projected, dim=-1))


class PyramidLamNeck(nn.Sequential):
    """The ``is_pyramids`` neck of the LAM: :class:`PyramidNeck`, then a
    channel LayerNorm (reference: build_lam.py:173-178). A pyramid dict in,
    one (B, H, W, d) map at the finest level's resolution out."""

    def __init__(self, intermediate_channel_sizes: Sequence[int],
                 d_model: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__(
            PyramidNeck(intermediate_channel_sizes, d_model=d_model,
                        dtype=dtype),
            LayerNorm2d(d_model, dtype=dtype))
