"""Plain (Hugging Face style) ViT encoders: the MAE, ImageNet-21k and DINO
backbones (counterpart of ``labelanything_tpu/models/vit.py``; reference:
label_anything/models/build_encoder.py:43-101, which runs
``transformers.ViTModel`` with ``interpolate_pos_encoding=True`` and drops
the CLS token).

A pre-LN ViT with a CLS token. The module names are ``ViTModel``'s
(``embeddings.patch_embeddings.projection``, ``encoder.layer.{i}.attention
.attention.query``, ...), so a Hugging Face checkpoint's state dict loads
with ``load_state_dict(strict=True)`` once its pooler is dropped.

The JAX package's choices are kept site by site:

* the blocks' LayerNorms take eps 1e-12 whatever the config says; only the
  final norm takes ``layernorm_eps``;
* the MLP's GELU is the tanh form (flax's default; ``ViTModel`` uses the
  exact erf form, ROADMAP C1);
* the position table is interpolated from ``pretrain_grid`` by
  :func:`..ops.resize.resize_cubic` (``jax.image.resize``'s cubic: Keys
  a = -0.5, taps outside the table dropped and the rest renormalised);
  ``ViTModel`` interpolates with torch's bicubic (a = -0.75), so off the
  pretraining grid the two differ (ROADMAP C23);
* parameters are fp32 and every layer computes in ``dtype``; the residual
  stream stays fp32, as flax's type promotion keeps it.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.resize import resize_cubic
from .common import Conv2d, LayerNorm, Linear, gelu

BLOCK_EPS = 1e-12


class _SelfAttention(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.query = Linear(dim, dim, dtype=dtype)
        self.key = Linear(dim, dim, dtype=dtype)
        self.value = Linear(dim, dim, dtype=dtype)


class _Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype):
        super().__init__()
        self.dense = Linear(d_in, d_out, dtype=dtype)


class _Attention(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.attention = _SelfAttention(dim, dtype)
        self.output = _Dense(dim, dim, dtype)


class EncoderBlock(nn.Module):
    """One pre-LN block (``ViTLayer``'s names): x + attention(norm1(x)),
    then x + MLP(norm2(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        hidden = int(dim * mlp_ratio)
        self.attention = _Attention(dim, dtype)
        self.intermediate = _Dense(dim, hidden, dtype)
        self.output = _Dense(hidden, dim, dtype)
        self.layernorm_before = LayerNorm(dim, eps=BLOCK_EPS, dtype=dtype)
        self.layernorm_after = LayerNorm(dim, eps=BLOCK_EPS, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        y = self.layernorm_before(x)
        sa = self.attention.attention

        def split(t):
            return t.reshape(b, n, self.num_heads, -1).transpose(1, 2)

        out = dot_product_attention(split(sa.query(y)), split(sa.key(y)),
                                    split(sa.value(y)))
        out = self.attention.output.dense(out.transpose(1, 2).reshape(b, n, d))
        x = x + out
        y = self.layernorm_after(x)
        return x + self.output.dense(gelu(self.intermediate.dense(y)))


class _PatchEmbeddings(nn.Module):
    def __init__(self, patch_size: int, dim: int, dtype: torch.dtype):
        super().__init__()
        self.projection = Conv2d(3, dim, patch_size, stride=patch_size,
                                 dtype=dtype)


class _Embeddings(nn.Module):
    def __init__(self, patch_size: int, dim: int, pretrain_grid: int,
                 dtype: torch.dtype):
        super().__init__()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, pretrain_grid * pretrain_grid + 1, dim))
        self.patch_embeddings = _PatchEmbeddings(patch_size, dim, dtype)


class _Encoder(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.layer = nn.ModuleList(blocks)


class StandardViT(nn.Module):
    """Pre-LN ViT with a CLS token and an interpolated position table.
    ``forward`` takes channels-last images (B, H, W, 3) and returns the
    channels-last map (B, H / p, W / p, D) with the CLS token dropped
    (reference: build_encoder.py:84-101)."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 pretrain_grid: int = 14, layernorm_eps: float = 1e-12,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.pretrain_grid = pretrain_grid
        self.compute_dtype = dtype
        self.embeddings = _Embeddings(patch_size, embed_dim, pretrain_grid,
                                      dtype)
        self.encoder = _Encoder(
            EncoderBlock(embed_dim, num_heads, mlp_ratio, dtype)
            for _ in range(depth))
        self.layernorm = LayerNorm(embed_dim, eps=layernorm_eps, dtype=dtype)

    def position_table(self, gh: int, gw: int) -> torch.Tensor:
        """(1, gh * gw, D) patch position embeddings for a gh x gw grid."""
        g, d = self.pretrain_grid, self.embed_dim
        table = self.embeddings.position_embeddings[:, 1:]
        if (gh, gw) == (g, g):
            return table
        grid = resize_cubic(table.reshape(1, g, g, d), (gh, gw))
        return grid.reshape(1, gh * gw, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        gh, gw = h // self.patch_size, w // self.patch_size
        emb = self.embeddings
        x = emb.patch_embeddings.projection(x).reshape(b, gh * gw,
                                                       self.embed_dim)
        cls = emb.cls_token + emb.position_embeddings[:, :1]
        x = torch.cat([cls.expand(b, 1, self.embed_dim),
                       x + self.position_table(gh, gw)], dim=1)
        for block in self.encoder.layer:
            x = block(x)
        x = self.layernorm(x)
        return x[:, 1:].reshape(b, gh, gw, self.embed_dim)
