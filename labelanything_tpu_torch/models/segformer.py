"""SegFormer's MiT-b0 hierarchical encoder (counterpart of
``labelanything_tpu/models/segformer.py``; reference:
label_anything/models/build_encoder.py:137-140, which loads
``nvidia/segformer-b0-finetuned-ade-512-512`` through ``AutoModel``, and
build_lam.py:303-330, whose ``config.hidden_sizes`` size the multi-level
model).

Overlapping strided-conv patch embeddings (7 x 7 stride 4, then 3 x 3
stride 2, padded by k // 2), self-attention whose keys and values come from
an sr x sr strided-conv-reduced map (sr 8, 4, 2, 1), and a Mix-FFN with a
3 x 3 depthwise conv and the exact-erf GELU. Channels-last throughout. The
module names are Hugging Face ``SegformerModel``'s
(``encoder.patch_embeddings.{i}``, ``encoder.block.{i}.{j}.attention.self
.query``, ``encoder.layer_norm.{i}``, ...), so its state dict loads with
``strict=True``; the JAX package fuses keys and values into one ``kv``
projection, which ``utils/weights.state_dict_from_jax`` splits.

As in the JAX package, every LayerNorm takes eps 1e-6 and the attention is
a plain product: at 1024 px the first stage's scores are (65536, 1024) for
each image and block, 256 MiB in fp32.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv2d, LayerNorm, Linear
from .ppnet import same_pads

MIT_B0_STAGE_DIMS = {"stage1": 32, "stage2": 64, "stage3": 160, "stage4": 256}
MIT_STAGE_STRIDES = {"stage1": 4, "stage2": 8, "stage3": 16, "stage4": 32}
EPS = 1e-6


class OverlapPatchEmbed(nn.Module):
    """Strided conv with overlap, then LayerNorm."""

    def __init__(self, cin: int, dim: int, kernel: int, stride: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Conv2d(cin, dim, kernel, stride=stride,
                           padding=kernel // 2, dtype=dtype)
        self.layer_norm = LayerNorm(dim, eps=EPS, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer_norm(self.proj(x))


class _SameConv(Conv2d):
    """The reduction conv with flax's "SAME" padding (none where the stride
    divides the map; else the high side first)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (k, _), (s, _) = self.kernel_size, self.stride
        ph = same_pads(x.shape[1], k, s)
        pw = same_pads(x.shape[2], k, s)
        if any(ph + pw):
            x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
        return super().forward(x)


class _SelfAttention(nn.Module):
    def __init__(self, dim: int, sr_ratio: int, dtype: torch.dtype):
        super().__init__()
        self.query = Linear(dim, dim, dtype=dtype)
        self.key = Linear(dim, dim, dtype=dtype)
        self.value = Linear(dim, dim, dtype=dtype)
        if sr_ratio > 1:
            self.sr = _SameConv(dim, dim, sr_ratio, stride=sr_ratio,
                                dtype=dtype)
            self.layer_norm = LayerNorm(dim, eps=EPS, dtype=dtype)


class _Output(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.dense = Linear(dim, dim, dtype=dtype)


class EfficientAttention(nn.Module):
    """Self-attention with keys and values on the sr x sr reduced map; the
    scores are divided by sqrt(dh) in the compute dtype and softmaxed in
    fp32, as the JAX module does."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.compute_dtype = dtype
        self.self = _SelfAttention(dim, sr_ratio, dtype)
        self.output = _Output(dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        sa = self.self
        dh = c // self.num_heads
        q = sa.query(x).reshape(b, h * w, self.num_heads, dh)
        kv_in = x
        if self.sr_ratio > 1:
            kv_in = sa.layer_norm(sa.sr(x))
        k = sa.key(kv_in).reshape(b, -1, self.num_heads, dh)
        v = sa.value(kv_in).reshape(b, -1, self.num_heads, dh)
        scale = torch.tensor(math.sqrt(dh), dtype=self.compute_dtype)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / scale.to(q.device)
        probs = torch.softmax(scores.float(), dim=-1).to(self.compute_dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, h, w, c)
        return self.output.dense(out)


class _DWConv(nn.Module):
    def __init__(self, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.dwconv = Conv2d(hidden, hidden, 3, padding=1, groups=hidden,
                             dtype=dtype)


class MixFFN(nn.Module):
    """Dense, 3 x 3 depthwise conv, exact-erf GELU, Dense."""

    def __init__(self, dim: int, hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense1 = Linear(dim, hidden, dtype=dtype)
        self.dwconv = _DWConv(hidden, dtype)
        self.dense2 = Linear(hidden, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dwconv.dwconv(self.dense1(x))
        return self.dense2(F.gelu(x))


class MiTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int,
                 mlp_ratio: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layer_norm_1 = LayerNorm(dim, eps=EPS, dtype=dtype)
        self.attention = EfficientAttention(dim, num_heads, sr_ratio, dtype)
        self.layer_norm_2 = LayerNorm(dim, eps=EPS, dtype=dtype)
        self.mlp = MixFFN(dim, dim * mlp_ratio, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.layer_norm_1(x))
        return x + self.mlp(self.layer_norm_2(x))


class _Encoder(nn.Module):
    def __init__(self, embed_dims, depths, num_heads, sr_ratios, mlp_ratio,
                 dtype):
        super().__init__()
        cins = (3,) + tuple(embed_dims[:-1])
        self.patch_embeddings = nn.ModuleList(
            OverlapPatchEmbed(cin, dim, 7 if i == 0 else 3,
                              4 if i == 0 else 2, dtype)
            for i, (cin, dim) in enumerate(zip(cins, embed_dims)))
        self.block = nn.ModuleList(
            nn.ModuleList(MiTBlock(dim, heads, sr, mlp_ratio, dtype)
                          for _ in range(depth))
            for dim, depth, heads, sr in zip(embed_dims, depths, num_heads,
                                             sr_ratios))
        self.layer_norm = nn.ModuleList(
            LayerNorm(dim, eps=EPS, dtype=dtype) for dim in embed_dims)


class MixVisionTransformer(nn.Module):
    """MiT backbone: channels-last images (B, H, W, 3) to the
    ``{"stageN": (B, h, w, C)}`` maps of ``out_features`` (all four stages
    by default, as the reference sizes its levels from
    ``config.hidden_sizes``)."""

    def __init__(self, out_features: Sequence[str] = (
                     "stage1", "stage2", "stage3", "stage4"),
                 embed_dims: Sequence[int] = (32, 64, 160, 256),
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (1, 2, 5, 8),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 mlp_ratio: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_features = tuple(out_features)
        self.compute_dtype = dtype
        self.encoder = _Encoder(tuple(embed_dims), depths, num_heads,
                                sr_ratios, mlp_ratio, dtype)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        enc = self.encoder
        out = {}
        for i, (embed, blocks, norm) in enumerate(zip(
                enc.patch_embeddings, enc.block, enc.layer_norm)):
            x = embed(x)
            for block in blocks:
                x = block(x)
            x = norm(x)
            stage = f"stage{i + 1}"
            if stage in self.out_features:
                out[stage] = x
        return out


def build_mit_b0(out_features=("stage1", "stage2", "stage3", "stage4"),
                 image_size=None, **kwargs) -> MixVisionTransformer:
    """nvidia/segformer-b0 (hidden sizes 32, 64, 160, 256); fully
    convolutional, so ``image_size`` is not used."""
    return MixVisionTransformer(out_features=tuple(out_features), **kwargs)
