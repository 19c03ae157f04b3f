"""Prompt-image encoder (counterpart of
``labelanything_tpu/models/prompt_encoder.py``; reference:
label_anything/models/prompt_encoder.py).

Every episode axis (B batch, M examples, C classes, N annotations) is
static and validity is carried by flag tensors, as in the JAX package.
Ported here: the plain fusion path (dense prompt embedding plus support
features through the two-way transformer for every (example, class)
instance) and the class / example / class-example merges. The JAX
package's rank-1 and rank-16 shared-keys paths are exact rewrites of the
same math and are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.resize import resize_bilinear
from ..typing import BatchKeys, Label, ResultDict
from .common import AttentionMLPBlock, Conv2d, LayerNorm2d, gelu
from .transformer import TwoWayTransformer

Pair = Optional[Tuple[torch.Tensor, torch.Tensor]]


class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier positional encoding (reference:
    prompt_encoder.py:187-233). The Gaussian matrix is a buffer; it starts
    at zero and is filled by a loaded state dict or by
    :func:`labelanything_tpu_torch.utils.weights.init_weights`."""

    def __init__(self, num_pos_feats: int = 64):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, num_pos_feats))

    def _pe_encoding(self, coords: torch.Tensor) -> torch.Tensor:
        coords = 2.0 * coords - 1.0
        coords = 2.0 * math.pi * (coords @ self.positional_encoding_gaussian_matrix)
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)

    def forward(self, size: Tuple[int, int]) -> torch.Tensor:
        """Dense grid encoding, channels-last (H, W, D)."""
        h, w = size
        dev = self.positional_encoding_gaussian_matrix.device
        y = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        grid = torch.stack([x[None, :].expand(h, w), y[:, None].expand(h, w)],
                           dim=-1)
        return self._pe_encoding(grid)

    def forward_with_coords(self, coords: torch.Tensor,
                            image_size: Tuple[int, int]) -> torch.Tensor:
        """Encode unnormalized (..., 2) xy coordinates."""
        norm = torch.tensor([image_size[1], image_size[0]], dtype=coords.dtype,
                            device=coords.device)
        return self._pe_encoding(coords / norm)


class RandomMatrixEncoder(nn.Module):
    """Class-identity encoder (reference: prompt_encoder.py:233-277): adds
    one bank row to every sparse and dense embedding of each class, which
    makes class identity permutation-symmetric. Class c takes row c, unless
    the call is handed a ``generator`` (a CPU ``torch.Generator``; the
    train step hands its own on, as the JAX module draws only when given
    its ``class_rows`` random stream): then the background takes row 0 and
    the other classes distinct random rows of 1..bank_size-1, drawn anew on
    every call. :attr:`rows`, when set, pins the rows instead (the tests
    compare against a draw made elsewhere). The bank starts at zero (see
    PositionEmbeddingRandom)."""

    def __init__(self, bank_size: int, embed_dim: int):
        super().__init__()
        self.bank_size = bank_size
        self.pos_embedding = nn.Parameter(
            torch.zeros(1, 1, bank_size, embed_dim))
        self.rows: Optional[Sequence[int]] = None

    def class_rows(self, num_classes: int,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        """Bank row of each of ``num_classes`` classes (CPU, int64)."""
        if self.rows is not None:
            rows = torch.as_tensor(self.rows, dtype=torch.long)
            if rows.shape != (num_classes,):
                raise ValueError(f"{num_classes} classes but rows "
                                 f"{tuple(rows.tolist())}")
            return rows
        if generator is None:
            return torch.arange(num_classes)
        fg = torch.randperm(self.bank_size - 1, generator=generator)
        return torch.cat([torch.zeros(1, dtype=torch.long),
                          fg[:num_classes - 1] + 1])

    def forward(self, dense: torch.Tensor, sparse: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """dense (B, M, C, H, W, D), sparse (B, M, C, N, D)."""
        rows = self.class_rows(sparse.shape[2], generator).to(dense.device)
        enc = self.pos_embedding[0, 0, rows].to(dense.dtype)   # (C, D)
        return (dense + enc[None, None, :, None, None, :],
                sparse + enc[None, None, :, None, :].to(sparse.dtype))


class IdentityClassEncoder(nn.Module):
    """No class encoding (the reference's default)."""

    def forward(self, dense: torch.Tensor, sparse: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        return dense, sparse


class PromptImageEncoder(nn.Module):
    """Fuses visual prompts with support features into per-class embeddings
    (reference: prompt_encoder.py:396-827).

    Inputs (channels-last): image_embeddings (B, M, H, W, D); points
    (coords (B, M, C, Np, 2), labels (B, M, C, Np)); boxes (boxes
    (B, M, C, Nb, 4), flags (B, M, C, Nb)); masks (masks (B, M, C, Hm, Wm),
    flags (B, M, C)); flag_examples (B, M, C). Returns CLASS_EMBS (B, C, D),
    EXAMPLES_CLASS_EMBS (B, M, C, D), FLAG_EXAMPLES and EXAMPLES_CLASS_SRC
    (B*M*C, H, W, D)."""

    def __init__(self, embed_dim: int, image_embedding_size: Tuple[int, int],
                 input_image_size: Tuple[int, int], mask_in_chans: int,
                 transformer: TwoWayTransformer, class_encoder: nn.Module,
                 example_class_attention: bool = True,
                 class_attention: bool = False,
                 example_attention: bool = False, num_heads: int = 8,
                 attention_downsample_rate: int = 2, mlp_dim: int = 2048,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d, c = embed_dim, mask_in_chans
        self.embed_dim = d
        self.image_embedding_size = tuple(image_embedding_size)
        self.input_image_size = tuple(input_image_size)
        self.compute_dtype = dtype
        self.pe_layer = PositionEmbeddingRandom(d // 2)
        # pos / neg point and the two box corners (reference: l.50-55)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, d) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, d)
        self.no_mask_embed = nn.Embedding(1, d)
        self.not_a_mask_embed = nn.Embedding(1, d)
        self.no_sparse_embedding = nn.Embedding(1, d)
        self.mask_downscaling = nn.Sequential(
            Conv2d(1, c // 4, 2, stride=2, dtype=dtype),
            LayerNorm2d(c // 4, dtype=dtype),
            nn.GELU(approximate="tanh"),
            Conv2d(c // 4, c, 2, stride=2, dtype=dtype),
            LayerNorm2d(c, dtype=dtype),
            nn.GELU(approximate="tanh"),
            Conv2d(c, d, 1, dtype=dtype))
        self.sparse_embedding_attention = AttentionMLPBlock(
            d, 1, mlp_dim, num_heads, act=gelu, dtype=dtype)

        def merge_block():
            return AttentionMLPBlock(d, attention_downsample_rate, mlp_dim,
                                     num_heads, act=gelu, dtype=dtype)

        self.class_attention = merge_block() if class_attention else None
        self.example_attention = merge_block() if example_attention else None
        self.class_example_attention = (merge_block() if example_class_attention
                                        else None)
        self.transformer = transformer
        self.class_encoder = class_encoder

    def get_dense_pe(self) -> torch.Tensor:
        """(1, H, W, D) positional encoding of the feature grid."""
        return self.pe_layer(self.image_embedding_size)[None]

    def _embed_points(self, coords, labels, pad: bool) -> torch.Tensor:
        """(B, M, C, N(+1), D); a (0, 0) point labelled NULL is appended when
        no boxes are given (reference: prompt_encoder.py:83-103)."""
        coords = coords + 0.5
        if pad:
            coords = torch.cat([coords, coords.new_zeros(coords.shape[:3] + (1, 2))],
                               dim=3)
            labels = torch.cat([labels, -labels.new_ones(labels.shape[:3] + (1,))],
                               dim=3)
        pe = self.pe_layer.forward_with_coords(coords, self.input_image_size)
        lbl = labels[..., None]
        pe = torch.where(lbl == Label.NULL, self.not_a_point_embed.weight[0], pe)
        pe = torch.where(lbl == Label.NEGATIVE,
                         pe + self.point_embeddings[0].weight[0], pe)
        pe = torch.where(lbl == Label.POSITIVE,
                         pe + self.point_embeddings[1].weight[0], pe)
        return pe

    def _embed_boxes(self, boxes, flags) -> torch.Tensor:
        """(B, M, C, 2N, D), two corner tokens per box. The corner padding
        mask repeats the box flags tiled, [f0..fN, f0..fN], over box-major
        tokens, as the reference does (prompt_encoder.py:659-663)."""
        b, m, c, n, _ = boxes.shape
        corners = (boxes + 0.5).reshape(b, m, c, n, 2, 2)
        pe = self.pe_layer.forward_with_coords(corners, self.input_image_size)
        corner = torch.stack([self.point_embeddings[2].weight[0],
                              self.point_embeddings[3].weight[0]])
        pe = (pe + corner).reshape(b, m, c, 2 * n, self.embed_dim)
        tiled = torch.cat([flags, flags], dim=-1)[..., None]
        return torch.where(tiled == Label.NULL, self.not_a_point_embed.weight[0], pe)

    def _embed_masks(self, masks, mask_flags) -> torch.Tensor:
        """(B, M, C, Hm/4, Wm/4, D) dense embeddings."""
        b, m, c, hm, wm = masks.shape
        x = self.mask_downscaling(masks.reshape(b * m * c, hm, wm, 1))
        x = x.reshape((b, m, c) + x.shape[1:])
        is_null = (mask_flags == Label.NULL)[..., None, None, None]
        return torch.where(is_null, self.not_a_mask_embed.weight[0].to(x.dtype), x)

    def _embed_sparse(self, points: Pair, boxes: Pair, bmc) -> torch.Tensor:
        b, m, c = bmc
        parts = []
        if points is not None:
            parts.append(self._embed_points(*points, pad=boxes is None))
        if boxes is not None:
            parts.append(self._embed_boxes(*boxes))
        if parts:
            sparse = torch.cat(parts, dim=3)
        else:
            sparse = self.no_sparse_embedding.weight[0].expand(
                b, m, c, 1, self.embed_dim)
        # attention over all class tokens of one example: (b m) (c n) d
        n_tok = sparse.shape[3]
        sparse = self.sparse_embedding_attention(
            sparse.reshape(b * m, c * n_tok, self.embed_dim))
        return sparse.reshape(b, m, c, n_tok, self.embed_dim)

    def embed_points_masks(self, points: Pair, boxes: Pair, masks: Pair):
        """Sparse (B, M, C, N_tok, D) and dense (B, M, C, h, w, D)
        embeddings (reference: prompt_encoder.py:564-644)."""
        for prompt in (points, boxes, masks):
            if prompt is not None:
                b, m, c = prompt[0].shape[:3]
                break
        else:
            raise ValueError("No prompts provided")
        sparse = self._embed_sparse(points, boxes, (b, m, c))
        if masks is not None:
            dense = self._embed_masks(*masks)
        else:
            h, w = self.image_embedding_size
            dense = self.no_mask_embed.weight[0].expand(b, m, c, h, w,
                                                        self.embed_dim)
        return sparse, dense

    def prompt_class_information_merge(self, embeddings: torch.Tensor
                                       ) -> torch.Tensor:
        """Class / example token mixing (reference: prompt_encoder.py:696-717);
        embeddings (B, M, C, D)."""
        b, m, c, d = embeddings.shape
        if self.class_attention is not None:
            embeddings = self.class_attention(
                embeddings.reshape(b * m, c, d)).reshape(b, m, c, d)
        if self.example_attention is not None:
            x = embeddings.transpose(1, 2).reshape(b * c, m, d)
            embeddings = self.example_attention(x).reshape(b, c, m, d).transpose(1, 2)
        if self.class_example_attention is not None:
            embeddings = self.class_example_attention(
                embeddings.reshape(b, m * c, d)).reshape(b, m, c, d)
        return embeddings

    def forward(self, image_embeddings: torch.Tensor, points: Pair, boxes: Pair,
                masks: Pair, flag_examples: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> dict:
        """``generator``: the class encoder's row draw (training); None
        gives every class its own row."""
        sparse, dense = self.embed_points_masks(points, boxes, masks)
        b, m, c = dense.shape[:3]
        h, w = image_embeddings.shape[2:4]
        if (h, w) != tuple(dense.shape[3:5]):
            dense = resize_bilinear(dense.reshape((-1,) + dense.shape[3:]),
                                    (h, w), spatial_axes=(1, 2)
                                    ).reshape((b, m, c, h, w, -1))
        src = image_embeddings[:, :, None] + dense
        dense_enc, sparse_enc = self.class_encoder(src, sparse, generator)
        d = self.embed_dim
        _, keys = self.transformer(dense_enc.reshape(b * m * c, h, w, d),
                                   self.get_dense_pe(),
                                   sparse_enc.reshape(b * m * c, -1, d))
        src = keys.reshape(b * m * c, h, w, d)

        embeddings = self.prompt_class_information_merge(
            src.mean(dim=(1, 2)).reshape(b, m, c, d))
        flags = flag_examples[..., None].to(embeddings.dtype)
        normalizer = flags.sum(dim=1)
        normalizer = torch.where(normalizer == 0, torch.ones_like(normalizer),
                                 normalizer)
        return {
            BatchKeys.FLAG_EXAMPLES: flag_examples,
            ResultDict.CLASS_EMBS: (embeddings * flags).sum(dim=1) / normalizer,
            ResultDict.EXAMPLES_CLASS_EMBS: embeddings,
            ResultDict.EXAMPLES_CLASS_SRC: src,
        }
