"""Prompt-image encoder (counterpart of
``labelanything_tpu/models/prompt_encoder.py``; reference:
label_anything/models/prompt_encoder.py).

Every episode axis (B batch, M examples, C classes, N annotations) is
static and validity is carried by flag tensors, as in the JAX package.
Ported here: the fusion of dense prompt embeddings and support features
through the two-way transformer for every (example, class) instance, and
the class / example / class-example merges. The fusion's image operand is
``features[b, m] + dense[b, m, c]``; as in the JAX package it is handed to
the transformer factored where it can be (``structured_fusion``): without
mask prompts ``dense`` is spatially uniform (rank 1), with them it is the
mask trunk's 16 channels through a 1x1 convolution plus a uniform term
(rank 16), so the trunk features are resized at 16 channels instead of the
dense map at ``embed_dim``. Both are exact algebra; what the transformer
does with the factors is its own choice (``models/transformer.py``).

The variants of the JAX module are ported too: ``class_embedding_dim`` (the
merges at another width between two projections), support features left
out of the fusion (``use_support_features=False``: the fused masks gate the
support features through ``proto_chooser``), several embeddings per
example (an adaptive k x k pool, or the ``EmbeddingTransformer`` /
``GuidedPooler`` extractions), and the "TokenPool" encoder
(``PromptImagePoolEncoder``), which fuses once per example. Dropout
follows ``models/common.py``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.resize import adaptive_avg_pool, resize_bilinear
from ..typing import BatchKeys, Label, ResultDict
from .common import (Attention, AttentionMLPBlock, Conv2d, LayerNorm2d,
                     Linear, dropout_keep, gelu)
from .transformer import OneWayAttentionBlock, TwoWayTransformer

Pair = Optional[Tuple[torch.Tensor, torch.Tensor]]


def _resize_dense(dense: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Dense embeddings (B, M, C, h', w', D) bilinearly at the features'
    grid ``hw``."""
    if tuple(dense.shape[3:5]) == tuple(hw):
        return dense
    return resize_bilinear(dense.reshape((-1,) + dense.shape[3:]), hw,
                           spatial_axes=(1, 2)).reshape(
                               dense.shape[:3] + tuple(hw) + dense.shape[-1:])


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


class EmbeddingTransformer(nn.Module):
    """Cross-attention extraction of ``num_embeddings`` embeddings per class
    (reference: prompt_encoder.py:280-313; JAX l.175-226): learned queries
    attend, through one-way blocks, to the fused maps of every example of
    the class. In ``train()`` mode each of the embeddings is dropped from
    the flags with probability ``embedding_dropout`` (at least one stays),
    drawn from the dropout generator."""

    def __init__(self, emb_dim: int, num_embeddings: int, num_layers: int = 2,
                 embedding_dropout: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embedding_dropout = embedding_dropout
        self.embeddings = nn.Parameter(torch.zeros(num_embeddings, emb_dim))
        self.layers = nn.ModuleList(
            OneWayAttentionBlock(emb_dim, 8, dtype=dtype)
            for _ in range(num_layers))

    def forward(self, src: torch.Tensor, image_pe: torch.Tensor,
                flag_examples: torch.Tensor) -> dict:
        """src (B*M*C, h, w, D), flag_examples (B, M, C) ->
        EXAMPLES_CLASS_EMBS (B, n, C, D) and FLAG_EXAMPLES (B, n, C); the
        positional encoding is not used (as in JAX)."""
        b, m, c = flag_examples.shape
        h, w, d = src.shape[-3:]
        n = self.embeddings.shape[0]
        embeddings = self.embeddings[None].expand(b * c, n, d)
        src = (src.reshape(b, m, c, h * w, d).transpose(1, 2)
               .reshape(b * c, m * h * w, d))
        for layer in self.layers:
            embeddings = layer(embeddings, src, None)
        flags = (flag_examples.sum(dim=1) > 0).long()[:, None, :].expand(
            b, n, c)
        if self.training and self.embedding_dropout > 0.0:
            included = dropout_keep((n,), self.embedding_dropout)
            if not bool(included.any()):
                included[0] = True
            flags = flags * included.to(flags.device)[None, :, None]
        return {ResultDict.EXAMPLES_CLASS_EMBS:
                    embeddings.reshape(b, c, n, d).transpose(1, 2),
                BatchKeys.FLAG_EXAMPLES: flags}


class GuidedPooler(nn.Module):
    """Soft foreground / background chooser extraction (reference:
    prompt_encoder.py:315-393; JAX l.228-308). As in the reference, the
    self-attention runs over the (B M C) axis with the pixels as the batch,
    and the softmax over the W axis of the chooser logits. The reference's
    Gumbel noise needs a random stream that no entry point of the JAX
    package hands the module, so it is deterministic in both packages.
    Returns the choices as MASK_EMBEDDINGS (bg, fg), each
    (n, B*M*C', 1, h, w), for the ``masks`` loss."""

    def __init__(self, emb_dim: int, num_embeddings: int, tau: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.tau = tau
        self.attention = Attention(emb_dim, 8, dtype=dtype)
        dims = (emb_dim, emb_dim // 2, emb_dim // 4, emb_dim // 8,
                num_embeddings + 1)
        for name in ("fg_chooser", "bg_chooser"):
            for i in range(4):
                self.add_module(f"{name}_{i}", Conv2d(dims[i], dims[i + 1], 1,
                                                      dtype=dtype))

    def _choose(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """(bmc, h, w, D) -> the soft choices (n, bmc, 1, h, w)."""
        for i in range(4):
            x = getattr(self, f"{name}_{i}")(x)
            if i < 3:
                x = torch.relu(x)
        x = torch.softmax(x / self.tau, dim=2)
        return x[..., 1:].permute(3, 0, 1, 2)[:, :, None]

    def forward(self, src: torch.Tensor, image_pe: torch.Tensor,
                flag_examples: torch.Tensor) -> dict:
        b, m, c = flag_examples.shape
        h, w, d = src.shape[-3:]
        src6 = (src + image_pe).reshape(b, m, c, h, w, d)
        fg_src = src6[:, :, 1:]
        bg_src = fg_src.mean(dim=2, keepdim=True)
        fg_flags = flag_examples[:, :, 1:]
        bg_flags = (fg_flags.sum(dim=2) > 0).to(fg_flags.dtype)[:, :, None]

        def seq_attn(x: torch.Tensor) -> torch.Tensor:
            toks = x.reshape(-1, h * w, d).transpose(0, 1)
            out = self.attention(toks, toks, toks)
            return out.transpose(0, 1).reshape(-1, h, w, d)

        fg, bg = seq_attn(fg_src), seq_attn(bg_src)
        fg_mask, bg_mask = self._choose(fg, "fg_chooser"), \
            self._choose(bg, "bg_chooser")
        n = fg_mask.shape[0]

        def pool(mask: torch.Tensor, x: torch.Tensor, cc: int):
            # mean over (h, w) of mask * features: (n, bmc, d)
            e = torch.einsum("nbhw,bhwd->nbd", mask[:, :, 0], x) / (h * w)
            return (e.transpose(0, 1).reshape(b, m, cc, n, d)
                    .permute(0, 3, 1, 2, 4).reshape(b, n * m, cc, d))

        embeddings = torch.cat([pool(bg_mask, bg, 1),
                                pool(fg_mask, fg, c - 1)], dim=2)
        flags = torch.cat([bg_flags, fg_flags], dim=2).repeat(1, n, 1)
        return {ResultDict.EXAMPLES_CLASS_EMBS: embeddings,
                BatchKeys.FLAG_EXAMPLES: flags,
                ResultDict.MASK_EMBEDDINGS: (bg_mask, fg_mask)}


class PromptImageEncoder(nn.Module):
    """Fuses visual prompts with support features into per-class embeddings
    (reference: prompt_encoder.py:396-827).

    Inputs (channels-last): image_embeddings (B, M, H, W, D); points
    (coords (B, M, C, Np, 2), labels (B, M, C, Np)); boxes (boxes
    (B, M, C, Nb, 4), flags (B, M, C, Nb)); masks (masks (B, M, C, Hm, Wm),
    flags (B, M, C)); flag_examples (B, M, C). Returns CLASS_EMBS (B, C, D),
    EXAMPLES_CLASS_EMBS (B, M, C, D), FLAG_EXAMPLES and EXAMPLES_CLASS_SRC
    (B*M*C, H, W, D). With ``embeddings_per_example`` n > 1 the examples
    axis of EXAMPLES_CLASS_EMBS and FLAG_EXAMPLES holds n entries an
    example; the extraction modules return no CLASS_EMBS (the decoder
    classifies per example), the pooler also MASK_EMBEDDINGS."""

    def __init__(self, embed_dim: int, image_embedding_size: Tuple[int, int],
                 input_image_size: Tuple[int, int], mask_in_chans: int,
                 transformer: TwoWayTransformer, class_encoder: nn.Module,
                 example_class_attention: bool = True,
                 class_attention: bool = False,
                 example_attention: bool = False, num_heads: int = 8,
                 attention_downsample_rate: int = 2, mlp_dim: int = 2048,
                 dtype: torch.dtype = torch.float32,
                 structured_fusion: bool = True, mask_factor: bool = True,
                 class_embedding_dim: Optional[int] = None,
                 use_support_features: bool = True,
                 embeddings_per_example: int = 1,
                 embedding_extraction: Optional[str] = None,
                 dropout: float = 0.0):
        """``structured_fusion=False`` hands the transformer the expanded
        image operand on every call; ``mask_factor=False`` does so for
        episodes with mask prompts only. ``embedding_extraction`` is None,
        "cross_attention" (:class:`EmbeddingTransformer`) or "pooler"
        (:class:`GuidedPooler`)."""
        super().__init__()
        d, c = embed_dim, mask_in_chans
        self.use_support_features = use_support_features
        self.embeddings_per_example = embeddings_per_example
        self.structured_fusion = structured_fusion
        self.mask_factor = mask_factor
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
            d, 1, mlp_dim, num_heads, act=gelu, dtype=dtype, dropout=dropout)

        # the merges at class_embedding_dim, between two projections
        # (JAX l.389-407); an extraction module's embeddings skip them, and
        # the JAX model then holds no parameters for them
        merges = embedding_extraction is None
        merge_dim, merge_ds = d, attention_downsample_rate
        self.class_projector_in = self.class_projector_out = None
        if class_embedding_dim is not None and merges:
            merge_dim, merge_ds = class_embedding_dim, 1
            self.class_projector_in = Linear(d, merge_dim, dtype=dtype)
            self.class_projector_out = Linear(merge_dim, d, dtype=dtype)

        def merge_block(wanted: bool) -> Optional[AttentionMLPBlock]:
            if not (wanted and merges):
                return None
            return AttentionMLPBlock(merge_dim, merge_ds, mlp_dim, num_heads,
                                     act=gelu, dtype=dtype, dropout=dropout)

        self.class_attention = merge_block(class_attention)
        self.example_attention = merge_block(example_attention)
        self.class_example_attention = merge_block(example_class_attention)
        self.transformer = transformer
        self.class_encoder = class_encoder
        if not use_support_features:
            self.proto_chooser_0 = Conv2d(d, d // 8, 1, dtype=dtype)
            self.proto_chooser_1 = Conv2d(d // 8, 1, 1, dtype=dtype)
        self.embedding_extraction_module = None
        if embedding_extraction == "cross_attention":
            self.embedding_extraction_module = EmbeddingTransformer(
                d, embeddings_per_example, dtype=dtype)
        elif embedding_extraction == "pooler":
            self.embedding_extraction_module = GuidedPooler(
                d, embeddings_per_example, dtype=dtype)
        elif embedding_extraction is not None:
            raise ValueError(f"unknown embedding_extraction "
                             f"{embedding_extraction!r}")

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

    def _embed_masks_factored(self, masks, mask_flags):
        """The dense mask embedding split exactly as ``h2 @ w3 + u``: the
        mask trunk (everything before the final 1x1 convolution) gives h2
        (B, M, C, Hm/4, Wm/4, Cm), zeroed for NULL masks; u (B, M, C, D) is
        the convolution's bias, or ``not_a_mask_embed`` for NULL masks; w3
        (Cm, D) is the convolution's weight."""
        b, m, c, hm, wm = masks.shape
        trunk, conv3 = self.mask_downscaling[:6], self.mask_downscaling[6]
        x = trunk(masks.reshape(b * m * c, hm, wm, 1))
        x = x.reshape((b, m, c) + x.shape[1:])
        is_null = mask_flags == Label.NULL
        x = torch.where(is_null[..., None, None, None], 0.0, x)
        dt = self.compute_dtype
        u = torch.where(is_null[..., None],
                        self.not_a_mask_embed.weight[0].to(dt),
                        conv3.bias.to(dt))
        return x, u, conv3.weight[:, :, 0, 0].t().to(dt)

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
        if self.class_projector_in is not None:
            embeddings = self.class_projector_in(embeddings)
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
        if self.class_projector_out is not None:
            embeddings = self.class_projector_out(embeddings)
        return embeddings

    def _class_result(self, embeddings: torch.Tensor,
                      flag_examples: torch.Tensor) -> dict:
        """The merges, and each class's embedding as the mean over the
        examples that flag it (reference: prompt_encoder.py:719-750)."""
        embeddings = self.prompt_class_information_merge(embeddings)
        flags = flag_examples[..., None].to(embeddings.dtype)
        normalizer = flags.sum(dim=1)
        normalizer = torch.where(normalizer == 0, torch.ones_like(normalizer),
                                 normalizer)
        class_embeddings = (embeddings * flags).sum(dim=1) / normalizer
        return {BatchKeys.FLAG_EXAMPLES: flag_examples,
                ResultDict.CLASS_EMBS: class_embeddings,
                ResultDict.EXAMPLES_CLASS_EMBS: embeddings}

    def _obtain_embeddings(self, src: torch.Tensor,
                           flag_examples: torch.Tensor) -> dict:
        """Pool the fused maps (B*M*C, h, w, D) to per-(example, class)
        embeddings: an extraction module's, an adaptive k x k pool of each
        map for k^2 = ``embeddings_per_example`` > 1 (each example's flags
        repeated k^2 times), else the map's mean."""
        if self.embedding_extraction_module is not None:
            return self.embedding_extraction_module(src, self.get_dense_pe(),
                                                    flag_examples)
        b, m, c = flag_examples.shape
        d = src.shape[-1]
        if self.embeddings_per_example > 1:
            k = math.isqrt(self.embeddings_per_example)
            x = adaptive_avg_pool(src.permute(0, 3, 1, 2), (k, k))
            embeddings = (x.reshape(b, m, c, d, k * k).permute(0, 1, 4, 2, 3)
                          .reshape(b, m * k * k, c, d))
            flag_examples = flag_examples.repeat_interleave(k * k, dim=1)
        else:
            embeddings = src.mean(dim=(1, 2)).reshape(b, m, c, d)
        return self._class_result(embeddings, flag_examples)

    def _fuse(self, image_embeddings: torch.Tensor, sparse_enc: torch.Tensor,
              **keys) -> torch.Tensor:
        """The fusion transformer over the flattened B.M.C axis: fused image
        features (B*M*C, h, w, D). ``keys`` are the transformer's shift
        arguments when ``image_embeddings`` holds base maps."""
        h, w, d = image_embeddings.shape[-3:]
        n = sparse_enc.shape[3]
        _, fused = self.transformer(image_embeddings.reshape(-1, h, w, d),
                                    self.get_dense_pe(),
                                    sparse_enc.reshape(-1, n, d), **keys)
        return fused.reshape(-1, h, w, d)

    def forward(self, image_embeddings: torch.Tensor, points: Pair, boxes: Pair,
                masks: Pair, flag_examples: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> dict:
        """``generator``: the class encoder's row draw (training); None
        gives every class its own row."""
        h, w = image_embeddings.shape[2:4]
        d = self.embed_dim
        # the class encoders add one row per class, uniform over the map, so
        # the image operand is features[b, m] + <structured correction>
        structured = self.structured_fusion and self.use_support_features
        factored = masks is not None and structured and self.mask_factor
        uniform = masks is None and structured
        if factored:
            b, m, c = masks[0].shape[:3]
            sparse = self._embed_sparse(points, boxes, (b, m, c))
            h2, u, w3 = self._embed_masks_factored(*masks)
            if (h, w) != tuple(h2.shape[3:5]):
                # the 1x1 convolution is linear per channel, so it commutes
                # with the bilinear resize: resize the trunk's 16 channels
                h2 = resize_bilinear(h2.reshape((-1,) + h2.shape[3:]), (h, w),
                                     spatial_axes=(1, 2))
            shift, sparse_enc = self.class_encoder(
                u[:, :, :, None, None, :], sparse, generator)
            src = self._fuse(image_embeddings, sparse_enc,
                             image_shift=shift.reshape(b * m * c, d),
                             image_shift_map=h2.reshape(b * m * c, h, w, -1),
                             image_shift_proj=w3)
        elif uniform:
            sparse, _ = self.embed_points_masks(points, boxes, None)
            b, m, c = sparse.shape[:3]
            proxy = self.no_mask_embed.weight[0].to(self.compute_dtype).expand(
                b, m, c, 1, 1, d)
            shift, sparse_enc = self.class_encoder(proxy, sparse, generator)
            src = self._fuse(image_embeddings, sparse_enc,
                             image_shift=shift.reshape(b * m * c, d))
        else:
            sparse, dense = self.embed_points_masks(points, boxes, masks)
            b, m, c = dense.shape[:3]
            dense = _resize_dense(dense, (h, w))
            if self.use_support_features:
                dense = image_embeddings[:, :, None] + dense
            dense_enc, sparse_enc = self.class_encoder(dense, sparse,
                                                       generator)
            src = self._fuse(dense_enc, sparse_enc)

        if not self.use_support_features:
            # the fused masks gate the support features (JAX l.809-816)
            gate = torch.sigmoid(self.proto_chooser_1(
                torch.relu(self.proto_chooser_0(src))))
            src = image_embeddings.reshape(-1, h, w, d).repeat_interleave(
                c, dim=0) * gate
        result = self._obtain_embeddings(src, flag_examples)
        return {**result, ResultDict.EXAMPLES_CLASS_SRC: src}


class PromptImagePoolEncoder(PromptImageEncoder):
    """The "TokenPool" encoder (reference: prompt_encoder.py:830-915; JAX
    l.824-877): every class's class-encoded dense embedding is summed into
    its example's support features, one fusion pass runs per example with
    all the classes' tokens, and each class's embedding is the mean of its
    own tokens after the pass. EXAMPLES_CLASS_SRC is the per-example map
    (B*M, h, w, D)."""

    def forward(self, image_embeddings: torch.Tensor, points: Pair,
                boxes: Pair, masks: Pair, flag_examples: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> dict:
        sparse, dense = self.embed_points_masks(points, boxes, masks)
        b, m, c = dense.shape[:3]
        h, w = image_embeddings.shape[2:4]
        d = self.embed_dim
        dense, sparse = self.class_encoder(_resize_dense(dense, (h, w)),
                                           sparse, generator)
        src = (image_embeddings + dense.sum(dim=2)).reshape(b * m, h, w, d)
        n_tok = sparse.shape[3]
        queries, _ = self.transformer(src, self.get_dense_pe(),
                                      sparse.reshape(b * m, c * n_tok, d))
        embeddings = queries.reshape(b, m, c, n_tok, d).mean(dim=3)
        return {**self._class_result(embeddings, flag_examples),
                ResultDict.EXAMPLES_CLASS_SRC: src}
