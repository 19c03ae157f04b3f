"""Resizes (counterpart of ``labelanything_tpu/ops/resize.py``; the cubic
resize is ``jax.image.resize``'s, which the JAX package calls in place).

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

import numpy as np
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


def resize_bilinear_ac(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Bilinear resize of the last two axes of ``x`` (..., H, W) with
    ``align_corners=True`` (the JAX ``resize_bilinear_ac``, which takes
    channels-last; the baselines call it throughout)."""
    size = (int(size[0]), int(size[1]))
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape((-1, 1) + x.shape[-2:]) if x.dim() != 4
                      else x, size=size, mode="bilinear", align_corners=True)
    return y.reshape(lead + size)


def _take(x: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor
          ) -> torch.Tensor:
    return x.index_select(-2, rows.to(x.device)).index_select(
        -1, cols.to(x.device))


def resize_nearest_torch(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Nearest resize of the last two axes by torch's ``mode="nearest"``
    rule, source ``floor(dst * in / out)``, in integers: the float product
    that ``F.interpolate`` takes can floor one pixel lower on a tie."""
    (h, w), (oh, ow) = x.shape[-2:], (int(size[0]), int(size[1]))
    return _take(x, (torch.arange(oh) * h) // oh, (torch.arange(ow) * w) // ow)


def resize_nearest(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Nearest resize of the last two axes by ``jax.image.resize``'s rule,
    source ``floor((dst + 0.5) * in / out)``, as XLA computes it: in
    float32, with ``* in / out`` folded to a product by ``in * (1 / out)``.
    Neither torch mode is this rule: ``"nearest"`` drops the half pixel, and
    ``"nearest-exact"`` scales by ``in / out`` rounded once (three rows
    apart from 60 to 237), and the exact rule is one row apart from 60 to
    473."""
    def rows(n_in: int, n_out: int) -> torch.Tensor:
        scale = np.float32(n_in) * (np.float32(1) / np.float32(n_out))
        pos = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * scale
        return torch.from_numpy(np.floor(pos).astype(np.int64))

    (h, w), (oh, ow) = x.shape[-2:], (int(size[0]), int(size[1]))
    return _take(x, rows(h, oh), rows(w, ow))


def cubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights of ``jax.image.resize(method="cubic",
    antialias=False)`` along one axis: Keys' cubic with a = -0.5 on
    half-pixel centres (source ``(i + 0.5) n_in / n_out - 0.5``), the taps
    that fall outside the input dropped and each row's weights divided by
    their sum, in float32 as XLA computes them. ``F.interpolate(mode=
    "bicubic")`` is another function: a = -0.75 and edge pixels repeated."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    sample = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
              * inv_scale - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
    near = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1)
    far = ((np.float32(-0.5) * x + np.float32(2.5)) * x
           - np.float32(4)) * x + np.float32(2)
    w = np.where(x >= 2, np.float32(0), np.where(x >= 1, far, near))
    total = w.sum(axis=0, keepdims=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = np.where(np.abs(total) > eps,
                 w / np.where(total != 0, total, np.float32(1)), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).T.astype(np.float32)


def resize_cubic(x: torch.Tensor, size: Sequence[int],
                 spatial_axes=(1, 2)) -> torch.Tensor:
    """Cubic resize of the two ``spatial_axes`` of ``x`` (channels-last
    (N, H, W, C) by default) to ``size``, as ``jax.image.resize(...,
    method="cubic", antialias=False)`` computes it (:func:`cubic_matrix`
    per axis, applied by ``einsum``); an axis whose size does not change
    is left as it is."""
    out = x
    for axis, n_out in zip(spatial_axes, size):
        axis = axis % x.dim()
        n_in = out.shape[axis]
        if n_in == int(n_out):
            continue
        w = torch.from_numpy(cubic_matrix(n_in, int(n_out))).to(
            device=x.device, dtype=x.dtype)
        out = torch.movedim(
            torch.tensordot(w, torch.movedim(out, axis, 0), dims=1), 0, axis)
    return out


def adaptive_avg_pool(x: torch.Tensor, out_hw: Sequence[int]) -> torch.Tensor:
    """``F.adaptive_avg_pool2d`` over the last two axes: bin ``i`` averages
    rows ``floor(i H / out)`` to ``ceil((i + 1) H / out)``, as the JAX
    version's pooling matmuls do."""
    return F.adaptive_avg_pool2d(x, (int(out_hw[0]), int(out_hw[1])))
