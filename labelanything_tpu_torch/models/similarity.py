"""The training-free cosine-similarity baseline (counterpart of
``labelanything_tpu/models/similarity.py``; reference:
label_anything/models/similarity.py:9-207).

A query pixel's logit for a class is its largest cosine similarity to a
support pixel of that class; the background class holds the support pixels
that no foreground mask covers. Features are resized to ``compare_size``
first (bilinear), masks by ``jax.image.resize``'s nearest rule; the logits
go to ``image_size`` and, with ``custom_preprocess``, the query's pad band
is -inf (background 0), as in the JAX package.

The JAX module forms the whole (B, HW, M, K) similarity array and one
masked copy of it a class: at ``compare_size`` 128 and 2-way 5-shot that is
about 10.7 GB an episode. Here the per-class maxima are taken over blocks
of query rows, each block's similarities at most :data:`BLOCK_BYTES`: the
same products and the same maxima.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.resize import resize_bilinear, resize_nearest
from ..typing import BatchKeys, ResultDict
from .lam import get_preprocess_shape

# the bytes of one block's (B, rows, M, K) fp32 similarities
BLOCK_BYTES = 1 << 30


def class_max_similarity(q: torch.Tensor, s: torch.Tensor,
                         masks: torch.Tensor,
                         block_bytes: int = BLOCK_BYTES) -> torch.Tensor:
    """q (B, Q, D) and s (B, M, K, D) unit vectors, masks (B, M, C, K) in
    {0, 1} -> (B, C, Q): the largest q . s over the support pixels of each
    class, -inf where a class has none. Query rows go in blocks whose
    (B, rows, M, K) fp32 similarities hold at most ``block_bytes``."""
    b, n_q = q.shape[:2]
    m, k = s.shape[1:3]
    c = masks.shape[2]
    rows = max(1, block_bytes // max(1, b * m * k * 4))
    keep = masks > 0                                       # (B, M, C, K)
    out = q.new_empty((b, c, n_q), dtype=torch.float32)
    for start in range(0, n_q, rows):
        sim = torch.einsum("bqd,bmkd->bqmk", q[:, start:start + rows].float(),
                           s.float())
        for n in range(c):
            msim = torch.where(keep[:, None, :, n], sim, float("-inf"))
            out[:, n, start:start + rows] = msim.flatten(2).amax(dim=-1)
    return out


class SimilarityFewShotSegmenter(nn.Module):
    """(reference: similarity.py:9-207). It holds no parameters."""

    def __init__(self, encoder: Optional[nn.Module] = None,
                 similarity: str = "cosine", image_size: Optional[int] = None,
                 custom_preprocess: bool = False,
                 compare_size: Optional[int] = None):
        super().__init__()
        self.encoder = encoder
        self.similarity = similarity
        self.image_size = image_size
        self.custom_preprocess = custom_preprocess
        self.compare_size = compare_size

    def forward(self, batch: dict, generator=None) -> dict:
        if self.similarity != "cosine":
            raise NotImplementedError("only cosine similarity is supported")
        if BatchKeys.EMBEDDINGS in batch:
            embeddings = batch[BatchKeys.EMBEDDINGS]       # (B, M, H, W, D)
        else:
            if self.encoder is None:
                raise ValueError("Encoder is None and no embeddings provided")
            images = batch[BatchKeys.IMAGES]
            flat = self.encoder(images.reshape((-1,) + images.shape[2:]))
            embeddings = flat.reshape(images.shape[:2] + flat.shape[1:])
        b, m = embeddings.shape[:2]
        if self.compare_size is not None:
            cs = self.compare_size
            flat = resize_bilinear(embeddings.reshape((-1,)
                                                      + embeddings.shape[2:]),
                                   (cs, cs), spatial_axes=(1, 2))
            embeddings = flat.reshape((b, m) + flat.shape[1:])
        else:
            cs = embeddings.shape[2]

        def unit(x):
            return x / torch.linalg.vector_norm(
                x, dim=-1, keepdim=True).clamp(min=1e-12)

        query, support = unit(embeddings[:, 0]), unit(embeddings[:, 1:])
        prompt_masks = batch[BatchKeys.PROMPT_MASKS]       # (B, M-1, C, h, w)
        m1, c = prompt_masks.shape[1:3]
        pm = resize_nearest(prompt_masks.reshape((-1,) + prompt_masks.shape[3:]),
                            (cs, cs)).reshape(b, m1, c, cs * cs)
        bg = (pm[:, :, 1:].sum(dim=2) == 0).to(pm.dtype)
        pm = torch.cat([bg[:, :, None], pm[:, :, 1:]], dim=2)

        h, w = query.shape[1:3]
        seg = class_max_similarity(query.reshape(b, h * w, -1),
                                   support.reshape(b, m1, cs * cs, -1), pm)
        seg = seg.reshape(b, c, h, w)
        s_out = self.image_size or cs
        seg = resize_bilinear(seg, (s_out, s_out))
        if (BatchKeys.DIMS in batch and self.image_size is not None
                and self.custom_preprocess):
            dims = batch[BatchKeys.DIMS].reshape(b, -1, 2)[:, 0]
            ih, iw = get_preprocess_shape(dims[:, 0], dims[:, 1], s_out)
            idx = torch.arange(s_out, device=seg.device)
            valid = ((idx[None, :] < ih[:, None])[:, :, None]
                     & (idx[None, :] < iw[:, None])[:, None, :])
            seg = torch.where(valid[:, None], seg, float("-inf"))
            bg0 = torch.where(valid, seg[:, 0], 0.0)
            seg = torch.cat([bg0[:, None], seg[:, 1:]], dim=1)
        return {ResultDict.LOGITS: seg}


def build_similarity(encoder=None, similarity="cosine", image_size=None,
                     custom_preprocess=False, compare_size=None,
                     **kwargs) -> SimilarityFewShotSegmenter:
    """The other keys of a model block (``dtype``, ...) are not used, as
    in the JAX builder."""
    return SimilarityFewShotSegmenter(
        encoder=encoder, similarity=similarity, image_size=image_size,
        custom_preprocess=custom_preprocess, compare_size=compare_size)
