"""Bilinear resize (counterpart of ``labelanything_tpu/ops/resize.py``).

The JAX version emulates ``F.interpolate(mode="bilinear",
align_corners=False)`` with two interpolation matmuls for the TPU; here the
forward is ``F.interpolate`` itself. Its gradient is taken by the two
matmuls with the interpolation matrices' transposes (the JAX version's
gradient), not by ``F.interpolate``'s own backward, which on the card adds
into the input's gradient with atomics, in no fixed order: a training step
would then not repeat bit for bit, and a resumed run would not retrace the
run it resumes.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=64)
def interpolation_matrix(n_in: int, n_out: int, device=None,
                         dtype=torch.float32) -> torch.Tensor:
    """(n_out, n_in) weights of ``F.interpolate``'s bilinear resize of one
    axis, half-pixel centres (source index ``(i + 0.5) n_in / n_out - 0.5``
    clamped at 0, the two neighbours weighted by distance). Built once per
    (sizes, device, dtype) and kept: a training step's backward reuses
    them, with no host-to-card copy. Callers do not write into it."""
    scale = n_in / n_out
    src = ((torch.arange(n_out, dtype=torch.float64) + 0.5) * scale
           - 0.5).clamp(min=0)
    i0 = src.floor().long().clamp(max=n_in - 1)
    i1 = torch.where(i0 < n_in - 1, i0 + 1, i0)
    w1 = src - i0
    w = torch.zeros(n_out, n_in, dtype=torch.float64)
    rows = torch.arange(n_out)
    w.index_put_((rows, i0), 1 - w1, accumulate=True)
    w.index_put_((rows, i1), w1, accumulate=True)
    return w.to(device=device, dtype=dtype)


class _Bilinear(torch.autograd.Function):
    """(N, C, H, W) -> (N, C, h, w): ``F.interpolate`` forward, the
    transposed interpolation matmuls backward."""

    @staticmethod
    def forward(ctx, x, size: Tuple[int, int]):
        ctx.in_size = x.shape[-2:]
        return F.interpolate(x, size=size, mode="bilinear",
                             align_corners=False)

    @staticmethod
    def backward(ctx, grad):
        (h_in, w_in), (h_out, w_out) = ctx.in_size, grad.shape[-2:]
        wh = interpolation_matrix(h_in, h_out, grad.device, grad.dtype)
        ww = interpolation_matrix(w_in, w_out, grad.device, grad.dtype)
        return torch.matmul(wh.t(), torch.matmul(grad, ww)), None


def _interpolate(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _Bilinear.apply(x, size)
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False)


def resize_bilinear(x: torch.Tensor, size: Sequence[int],
                    spatial_axes=(-2, -1)) -> torch.Tensor:
    """Bilinear resize of the two ``spatial_axes`` of ``x`` to ``size``
    (H, W), half-pixel centres, no antialiasing. ``spatial_axes`` is
    (-2, -1) for (..., H, W) or (1, 2) for channels-last (N, H, W, C)."""
    axes = [a % x.dim() for a in spatial_axes]
    size = (int(size[0]), int(size[1]))
    if axes == [x.dim() - 2, x.dim() - 1]:
        lead = x.shape[:-2]
        y = _interpolate(x.reshape((-1, 1) + x.shape[-2:]), size)
        return y.reshape(lead + size)
    if x.dim() == 4 and axes == [1, 2]:
        y = _interpolate(x.permute(0, 3, 1, 2), size)
        return y.permute(0, 2, 3, 1)
    raise ValueError(f"unsupported spatial axes {spatial_axes} for a "
                     f"{x.dim()}-D input")
