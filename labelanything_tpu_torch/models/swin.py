"""Swin Transformer backbone of the DCAMA baseline (counterpart of
``labelanything_tpu/models/swin.py``; reference:
label_anything/models/dcama/swin_transformer.py, Microsoft's Swin-B: patch
4, window 12, 384 px).

Tokens are channels-last (B, H * W, C), as in the JAX package; the patch
embedding's convolution alone runs NCHW. ``forward`` returns the feature
map (B, H_s, W_s, C_s) of every block of every stage, before the stage's
downsampling: 24 maps for Swin-B, as DCAMA consumes them.

The module names are the reference's state-dict names
(``patch_embed.proj``, ``patch_embed.norm``, ``layers.{i}.blocks.{j}``,
``layers.{i}.downsample``), so a reference state dict loads with
``strict=True`` once the buffers the port computes (``attn_mask``,
``relative_position_index``) and the classifier (``norm``, ``head``),
which DCAMA never runs, are dropped
(``utils/weights.reference_baseline_state_dict``). Dropout and drop-path
are identity: the reference runs the backbone in eval mode inside DCAMA.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, ws * ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int
                   ) -> torch.Tensor:
    """(B * nW, ws * ws, C) -> (B, H, W, C)."""
    b = windows.shape[0] // (h * w // ws // ws)
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def relative_position_index(ws: int) -> np.ndarray:
    """(ws * ws, ws * ws) indices into the (2 ws - 1)^2 bias table
    (reference: swin_transformer.py:85-100)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def shifted_window_attn_mask(h: int, w: int, ws: int, shift: int
                             ) -> np.ndarray:
    """Additive mask (nW, N, N) of shifted windows: -100 between tokens of
    different regions, not -inf (reference: swin_transformer.py:240-260)."""
    img_mask = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mask_windows = (img_mask.reshape(1, h // ws, ws, w // ws, ws, 1)
                    .transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws))
    attn_mask = mask_windows[:, None, :] - mask_windows[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _index(ws: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(relative_position_index(ws).reshape(-1),
                           device=device)


@functools.lru_cache(maxsize=32)
def _mask(h: int, w: int, ws: int, shift: int, device: torch.device
          ) -> torch.Tensor:
    return torch.as_tensor(shifted_window_attn_mask(h, w, ws, shift),
                           device=device)


class WindowAttention(nn.Module):
    """Multi-head attention within a window, with the relative position
    bias table (reference: swin_transformer.py:62-135)."""

    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        self.dim, self.window_size, self.num_heads = dim, window_size, num_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """x (B * nW, N, C); mask: an additive (nW, N, N) or None."""
        bnw, n, _ = x.shape
        heads, hd = self.num_heads, self.dim // self.num_heads
        qkv = self.qkv(x).reshape(bnw, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q @ k.transpose(-2, -1)) * hd ** -0.5
        bias = self.relative_position_bias_table[
            _index(self.window_size, x.device)]
        attn = attn + bias.reshape(n, n, heads).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(bnw // nw, nw, heads, n, n) + mask[None, :, None]
            attn = attn.reshape(bnw, heads, n, n)
        out = attn.softmax(dim=-1) @ v
        return self.proj(out.transpose(1, 2).reshape(bnw, n, self.dim))


class Mlp(nn.Module):
    """Linear, exact GELU, linear (``fc1``, ``fc2``: Swin's and timm's)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """(reference: swin_transformer.py:184-300). The window is clamped to
    the grid, unshifted, where the grid is no larger than it; GELU is the
    exact (erf) form."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window_size: int, shift_size: int,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.input_resolution = input_resolution
        if min(input_resolution) <= window_size:
            window_size, shift_size = min(input_resolution), 0
        self.window_size, self.shift_size = window_size, shift_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H * W, C)."""
        h, w = self.input_resolution
        ws, shift = self.window_size, self.shift_size
        b, l, c = x.shape
        y = self.norm1(x).reshape(b, h, w, c)
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        mask = _mask(h, w, ws, shift, x.device) if shift > 0 else None
        y = window_reverse(self.attn(window_partition(y, ws), mask), ws, h, w)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y.reshape(b, l, c)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """2 x 2 neighbours concatenated in the order x0, x1, x2, x3, then
    LayerNorm and a linear map to twice the width."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int]):
        super().__init__()
        self.input_resolution = input_resolution
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.input_resolution
        b, l, c = x.shape
        x = x.reshape(b, h, w, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x.reshape(b, l // 4, 4 * c)))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, L, C)."""
        x = self.proj(x.permute(0, 3, 1, 2))
        return self.norm(x.flatten(2).transpose(1, 2))


class BasicLayer(nn.Module):
    """One stage: its blocks, then the downsampling (none in the last)."""

    def __init__(self, blocks: List[SwinBlock],
                 downsample: Optional[PatchMerging]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinTransformer(nn.Module):
    """(reference: swin_transformer.py:455-590)."""

    def __init__(self, img_size: int = 384, patch_size: int = 4,
                 embed_dim: int = 128, depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32),
                 window_size: int = 12, mlp_ratio: float = 4.0):
        super().__init__()
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        res, dim = img_size // patch_size, embed_dim
        layers = []
        for stage, (depth, heads) in enumerate(zip(depths, num_heads)):
            blocks = [SwinBlock(dim, (res, res), heads, window_size,
                                0 if i % 2 == 0 else window_size // 2,
                                mlp_ratio) for i in range(depth)]
            last = stage == len(depths) - 1
            layers.append(BasicLayer(
                blocks, None if last else PatchMerging(dim, (res, res))))
            if not last:
                res, dim = res // 2, dim * 2
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, H, W, 3) channels-last -> every block's (B, H_s, W_s,
        C_s)."""
        x = self.patch_embed(x)
        feats = []
        for layer in self.layers:
            for block in layer.blocks:
                x = block(x)
                h, w = block.input_resolution
                feats.append(x.reshape(x.shape[0], h, w, x.shape[-1]))
            if layer.downsample is not None:
                x = layer.downsample(x)
        return feats
