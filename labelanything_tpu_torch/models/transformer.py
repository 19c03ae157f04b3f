"""Fusion transformers (counterpart of
``labelanything_tpu/models/transformer.py``; reference:
label_anything/models/transformer.py). Image tensors arrive channels-last
(B, H, W, D) and are flattened to (B, HW, D); token tensors are (B, N, D).

``TwoWayTransformer.forward`` has three forms of the same function:

* the module path, block by block through ``Attention`` and ``LayerNorm``;
* the fused kernel (``ops/fused_twoway.py``, one CUDA kernel for the whole
  transformer), taken when ``fused_twoway_ok`` admits the call and one
  positional grid serves all instances: a rule on device, dtype and shape
  alone. Inside ``ops.flash_attention.plain_attention()`` the module path
  is taken instead;
* the shared-keys form (``ops/twoway_shared.py``), for keys given as base
  maps plus a per-instance shift, when the module was built with
  ``shared_keys=True``: plain tensor code that runs the first block's
  image side once per base map.

Neither the fused kernel nor the shared-keys form has dropout, so a
forward in ``train()`` mode of a module built with ``dropout`` > 0 takes
the module path by rule (the JAX package refuses its fused paths whenever
``dropout`` > 0, ``transformer.py:290-296``); in ``eval()`` mode dropout is
the identity and the rules above hold.

``OneWayTransformer`` (image tokens attend to the class tokens) and
``IdentityTransformer`` (no fusion) are the mask decoder's other fusion
transformers (``fusion_transformer``).

The JAX package's block-diagonal lane layouts are the TPU's and are not
ported.

``AffinityTransformer`` (the affinity decoder's) attends from the query
image's map to every support image's map, with the class-conditioned support
masks as values; its attention meets ``ops.attention``'s rule for the flash
kernel at the SAM grid of 64 x 64."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import flash_attention as fa
from ..ops import fused_twoway as ft
from ..ops.twoway_shared import twoway_shared
from .common import Attention, AttentionMLPBlock, LayerNorm, MLPBlock


def _flatten_image(x: torch.Tensor) -> torch.Tensor:
    b, h, w, d = x.shape
    return x.reshape(b, h * w, d)


class IdentityTransformer(nn.Module):
    """No fusion (reference: transformer.py:17-23): the tokens and the
    flattened image as they came."""

    def forward(self, image_embedding: torch.Tensor, image_pe: torch.Tensor,
                point_embedding: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return point_embedding, _flatten_image(image_embedding)


class OneWayAttentionBlock(nn.Module):
    """Queries attend to keys, then an MLP, each post-normed (reference:
    transformer.py:106-155)."""

    def __init__(self, embedding_dim: int, num_heads: int, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        d = embedding_dim
        self.cross_attn_image_to_token = Attention(
            d, num_heads, attention_downsample_rate, dtype=dtype,
            dropout=dropout)
        self.norm1 = LayerNorm(d, eps=1e-5, dtype=dtype)
        self.mlp = MLPBlock(d, mlp_dim, act=F.relu, dtype=dtype,
                            dropout=dropout)
        self.norm2 = LayerNorm(d, eps=1e-5, dtype=dtype)

    def forward(self, queries: torch.Tensor, keys: torch.Tensor,
                query_pe: Optional[torch.Tensor]) -> torch.Tensor:
        q = queries if query_pe is None else queries + query_pe
        queries = self.norm1(
            queries + self.cross_attn_image_to_token(q, keys, keys))
        return self.norm2(queries + self.mlp(queries))


class OneWayTransformer(nn.Module):
    """The image's tokens attend to the class tokens, which stay as they
    are (reference: transformer.py:26-103)."""

    def __init__(self, depth: int, embedding_dim: int, num_heads: int,
                 mlp_dim: int, attention_downsample_rate: int = 2,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            OneWayAttentionBlock(embedding_dim, num_heads, mlp_dim,
                                 attention_downsample_rate, dtype=dtype,
                                 dropout=dropout)
            for _ in range(depth))

    def forward(self, image_embedding: torch.Tensor, image_pe: torch.Tensor,
                point_embedding: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (tokens (B, N, D) unchanged, image tokens (B, HW, D))."""
        queries = _flatten_image(image_embedding)
        pe = _flatten_image(image_pe)
        for layer in self.layers:
            queries = layer(queries, point_embedding, pe)
        return point_embedding, queries


class TwoWayAttentionBlock(nn.Module):
    """SAM-style bidirectional block (reference: transformer.py:255-330)."""

    def __init__(self, embedding_dim: int, num_heads: int, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2,
                 skip_first_layer_pe: bool = False,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        d, ds, p = embedding_dim, attention_downsample_rate, dropout
        self.self_attn = Attention(d, num_heads, dtype=dtype, dropout=p)
        self.norm1 = LayerNorm(d, eps=1e-5, dtype=dtype)
        self.cross_attn_token_to_image = Attention(d, num_heads, ds,
                                                   dtype=dtype, dropout=p)
        self.norm2 = LayerNorm(d, eps=1e-5, dtype=dtype)
        self.mlp = MLPBlock(d, mlp_dim, act=F.relu, dtype=dtype, dropout=p)
        self.norm3 = LayerNorm(d, eps=1e-5, dtype=dtype)
        self.norm4 = LayerNorm(d, eps=1e-5, dtype=dtype)
        self.cross_attn_image_to_token = Attention(d, num_heads, ds,
                                                   dtype=dtype, dropout=p)
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
                 dtype: torch.dtype = torch.float32,
                 shared_keys: bool = False, dropout: float = 0.0):
        """``shared_keys``: take ``ops.twoway_shared`` for keys given as base
        maps plus shifts (``image_shift``); without it they are expanded
        and go the way of any other keys."""
        super().__init__()
        self.dropout = dropout
        self.depth = depth
        self.embedding_dim = embedding_dim
        self.num_heads = num_heads
        self.mlp_dim = mlp_dim
        self.attention_downsample_rate = attention_downsample_rate
        self.compute_dtype = dtype
        self.shared_keys = shared_keys
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim,
                                 attention_downsample_rate,
                                 skip_first_layer_pe=(i == 0), dtype=dtype,
                                 dropout=dropout)
            for i in range(depth))
        self.final_attn_token_to_image = Attention(
            embedding_dim, num_heads, attention_downsample_rate, dtype=dtype,
            dropout=dropout)
        self.norm_final_attn = LayerNorm(embedding_dim, eps=1e-5, dtype=dtype)

    def drops(self) -> bool:
        """Whether a forward now applies dropout (``train()`` mode and a
        rate above 0): then only the module path computes it."""
        return self.training and self.dropout > 0.0

    def forward(self, image_embedding: torch.Tensor, image_pe: torch.Tensor,
                point_embedding: torch.Tensor,
                image_shift: Optional[torch.Tensor] = None,
                image_shift_map: Optional[torch.Tensor] = None,
                image_shift_proj: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """image_embedding (B, H, W, D), image_pe (1 or B, H, W, D),
        point_embedding (B, N, D) -> (queries (B, N, D), keys (B, HW, D)).

        With ``image_shift`` (B, D), ``image_embedding`` holds B / group
        shared base maps and instance b's keys are ``base[b // group] +
        image_shift[b]``, a spatially uniform shift; ``image_shift_map``
        (B, H, W, Cm) and ``image_shift_proj`` (Cm, D) add the low-rank
        term ``map[b] @ proj``."""
        dt = self.compute_dtype
        # one positional grid for all instances, and no dropout to apply
        fusable = image_pe.shape[0] == 1 and not self.drops()
        if image_shift is not None:
            g, bases = point_embedding.shape[0], image_embedding.shape[0]
            if g % bases:
                raise ValueError(
                    f"image_shift needs the instance count ({g}) divisible "
                    f"by the base-map count ({bases})")
            if self.shared_keys and fusable:
                smap = (None if image_shift_map is None
                        else _flatten_image(image_shift_map).to(dt))
                proj = (None if image_shift_proj is None
                        else image_shift_proj.to(dt))
                return twoway_shared(
                    _flatten_image(image_embedding).to(dt),
                    point_embedding.to(dt), _flatten_image(image_pe)[0].to(dt),
                    ft.twoway_params(self), self.depth, self.num_heads,
                    image_shift.to(dt), smap, proj)
            image_embedding = (
                image_embedding.repeat_interleave(g // bases, dim=0)
                + image_shift[:, None, None, :].to(image_embedding.dtype))
            if image_shift_map is not None:
                image_embedding = image_embedding + (
                    image_shift_map @ image_shift_proj
                ).to(image_embedding.dtype)
        keys = _flatten_image(image_embedding)
        if (fusable and not fa._plain_requested and ft.fused_twoway_ok(
                keys.device, dt, point_embedding.shape[1], self.embedding_dim,
                self.num_heads, self.mlp_dim,
                self.attention_downsample_rate)):
            return ft.fused_twoway_transformer(
                keys.to(dt).contiguous(), point_embedding.to(dt).contiguous(),
                _flatten_image(image_pe)[0].to(dt).contiguous(),
                ft.twoway_params(self), self.depth, self.num_heads)
        image_pe = _flatten_image(image_pe.expand(image_embedding.shape))
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, image_pe)
        q = queries + point_embedding
        k = keys + image_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class AffinityBlock(nn.Module):
    """DCAMA-style mask-valued attention block (reference:
    transformer.py:332-364)."""

    def __init__(self, embedding_dim: int, num_heads: int, mlp_dim: int,
                 attention_downsample_rate: int = 2,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.attention = AttentionMLPBlock(
            embedding_dim, attention_downsample_rate, mlp_dim, num_heads,
            act=F.relu, dtype=dtype, dropout=dropout)

    def forward(self, image_features: torch.Tensor,
                support_features: torch.Tensor, support_masks: torch.Tensor,
                image_pe: torch.Tensor) -> torch.Tensor:
        """image_features (B C, HW, D), support_features and support_masks
        (B C, M HW, D), image_pe (1, h, w, D) -> (B C, HW, D)."""
        hw = image_features.shape[1]
        pe = _flatten_image(image_pe)
        shots = support_features.shape[1] // hw
        queries = image_features + pe
        keys = support_features + pe.repeat(1, shots, 1)
        return self.attention(queries, keys, support_masks) + image_features


class AffinityTransformer(nn.Module):
    """Stack of AffinityBlocks (reference: transformer.py:362-403). The JAX
    module also builds a dense (B C, heads, HW, M HW) key mask from the
    example flags, which its attention ignores unless ``apply_masks`` (the
    reference's masks are a no-op, see ``common.Attention``); the port
    builds none: at the SAM grid it would hold 1.6 G elements."""

    def __init__(self, depth: int, embedding_dim: int, num_heads: int,
                 mlp_dim: int, attention_downsample_rate: int = 2,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            AffinityBlock(embedding_dim, num_heads, mlp_dim,
                          attention_downsample_rate, dtype=dtype,
                          dropout=dropout)
            for _ in range(depth))

    def forward(self, image_embedding: torch.Tensor,
                support_features: torch.Tensor, support_masks: torch.Tensor,
                image_pe: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            image_embedding = layer(image_embedding, support_features,
                                    support_masks, image_pe)
        return image_embedding
