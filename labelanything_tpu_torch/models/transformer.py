"""Two-way fusion transformer (counterpart of
``labelanything_tpu/models/transformer.py``; reference:
label_anything/models/transformer.py). Image tensors arrive channels-last
(B, H, W, D) and are flattened to (B, HW, D); token tensors are (B, N, D).
Only the plain module path is ported: the JAX package's blockdiag and fused
forms are reformulations of the same math for the TPU."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import Attention, LayerNorm, MLPBlock


def _flatten_image(x: torch.Tensor) -> torch.Tensor:
    b, h, w, d = x.shape
    return x.reshape(b, h * w, d)


class TwoWayAttentionBlock(nn.Module):
    """SAM-style bidirectional block (reference: transformer.py:255-330)."""

    def __init__(self, embedding_dim: int, num_heads: int, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2,
                 skip_first_layer_pe: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d, ds = embedding_dim, attention_downsample_rate
        self.self_attn = Attention(d, num_heads, dtype=dtype)
        self.norm1 = LayerNorm(d, eps=1e-5, dtype=dtype)
        self.cross_attn_token_to_image = Attention(d, num_heads, ds, dtype=dtype)
        self.norm2 = LayerNorm(d, eps=1e-5, dtype=dtype)
        self.mlp = MLPBlock(d, mlp_dim, act=F.relu, dtype=dtype)
        self.norm3 = LayerNorm(d, eps=1e-5, dtype=dtype)
        self.norm4 = LayerNorm(d, eps=1e-5, dtype=dtype)
        self.cross_attn_image_to_token = Attention(d, num_heads, ds, dtype=dtype)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)

        q = queries + query_pe
        k = keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))

        q = queries + query_pe
        k = keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    """Token <-> image fusion (reference: transformer.py:157-252)."""

    def __init__(self, depth: int, embedding_dim: int, num_heads: int,
                 mlp_dim: int, attention_downsample_rate: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim,
                                 attention_downsample_rate,
                                 skip_first_layer_pe=(i == 0), dtype=dtype)
            for i in range(depth))
        self.final_attn_token_to_image = Attention(
            embedding_dim, num_heads, attention_downsample_rate, dtype=dtype)
        self.norm_final_attn = LayerNorm(embedding_dim, eps=1e-5, dtype=dtype)

    def forward(self, image_embedding: torch.Tensor, image_pe: torch.Tensor,
                point_embedding: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """image_embedding (B, H, W, D), image_pe (1 or B, H, W, D),
        point_embedding (B, N, D) -> (queries (B, N, D), keys (B, HW, D))."""
        keys = _flatten_image(image_embedding)
        image_pe = _flatten_image(image_pe.expand(image_embedding.shape))
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, image_pe)
        q = queries + point_embedding
        k = keys + image_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys
