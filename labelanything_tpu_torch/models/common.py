"""Shared building blocks (counterpart of
``labelanything_tpu/models/common.py``).

Conventions of the port:

* Module and parameter names, and parameter layouts, are the original
  PyTorch LabelAnything's, so its state dicts load with ``strict=True``.
* Spatial tensors are channels-last (..., H, W, C), as in the JAX package;
  the conv layers below take and return channels-last maps.
* Parameters stay fp32. Every layer takes a compute ``dtype`` and casts its
  input and weights to it at use (bf16 for serving, fp32 for parity); norms
  compute their statistics in fp32 and return ``dtype``.
* Activations follow the JAX package: GELU is tanh-approximate (flax's
  ``nn.gelu`` default; the reference uses the exact erf form).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention

gelu = functools.partial(F.gelu, approximate="tanh")


class Linear(nn.Linear):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` on channels-last (N, H, W, C) maps."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        y = self._conv_forward(x.to(dt).permute(0, 3, 1, 2),
                               self.weight.to(dt), bias)
        return y.permute(0, 2, 3, 1)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` on channels-last (N, H, W, C) maps."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        y = F.conv_transpose2d(x.to(dt).permute(0, 3, 1, 2),
                               self.weight.to(dt), bias, self.stride,
                               self.padding, self.output_padding, self.groups,
                               self.dilation)
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis; fp32 statistics, output in ``dtype``.
    ``eps`` has no default: flax and torch disagree (1e-6 vs 1e-5) and each
    call site states the JAX package's value."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)


class LayerNorm2d(nn.Module):
    """Channel LayerNorm of a spatial map (reference: models/common.py:42-55);
    channels-last here, so it normalizes the last axis."""

    def __init__(self, num_channels: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.eps = eps
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        u = xf.mean(dim=-1, keepdim=True)
        s = (xf - u).square().mean(dim=-1, keepdim=True)
        xf = (xf - u) * torch.rsqrt(s + self.eps)
        return (self.weight * xf + self.bias).to(self.compute_dtype)


class MLPBlock(nn.Module):
    """Two-layer MLP (reference: models/common.py:19-37)."""

    def __init__(self, embedding_dim: int, mlp_dim: int, act=gelu,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lin1 = Linear(embedding_dim, mlp_dim, dtype=dtype)
        self.lin2 = Linear(mlp_dim, embedding_dim, dtype=dtype)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(self.act(self.lin1(x)))


class Attention(nn.Module):
    """Multi-head attention with projection-width downsampling
    (reference: models/common.py:58-147). The reference's key/attention
    masks are a no-op as written, and the released checkpoints were trained
    that way, so this port takes none (the JAX ``apply_masks=False``)."""

    def __init__(self, embedding_dim: int, num_heads: int,
                 downsample_rate: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        internal = embedding_dim // downsample_rate
        if internal % num_heads:
            raise ValueError("num_heads must divide the internal dim")
        self.num_heads = num_heads
        self.q_proj = Linear(embedding_dim, internal, dtype=dtype)
        self.k_proj = Linear(embedding_dim, internal, dtype=dtype)
        self.v_proj = Linear(embedding_dim, internal, dtype=dtype)
        self.out_proj = Linear(internal, embedding_dim, dtype=dtype)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        return x.reshape(b, n, self.num_heads, c // self.num_heads).transpose(1, 2)

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        out = dot_product_attention(self._split(self.q_proj(q)),
                                    self._split(self.k_proj(k)),
                                    self._split(self.v_proj(v)))
        b, h, n, d = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, h * d))


class AttentionMLPBlock(nn.Module):
    """Post-norm attention + MLP block (reference: models/common.py:151-184);
    the reference applies one LayerNorm instance twice."""

    def __init__(self, embed_dim: int, downsample_rate: int, mlp_dim: int,
                 num_heads: int, act=gelu, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = LayerNorm(embed_dim, eps=1e-5, dtype=dtype)
        self.attn = Attention(embed_dim, num_heads, downsample_rate, dtype=dtype)
        self.mlp = MLPBlock(embed_dim, mlp_dim, act=act, dtype=dtype)

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        attn_out = self.norm(self.attn(q, q, q) + q)
        return self.norm(self.mlp(attn_out) + attn_out)
