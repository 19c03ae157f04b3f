"""The multi-level (feature-pyramid) LAM (counterpart of
``labelanything_tpu/models/multilevel.py``; reference:
label_anything/models/prompt_encoder.py:919-967, mask_decoder.py:651-771,
lam.py:531-582).

One prompt encoder and one mask decoder a backbone stage. Each level's
decoder fuses and upscales as the plain decoder does; the levels' feature
maps are resized to the first level's, projected to the widest level's
width and summed, their class embeddings likewise, and the sum is
classified once. Levels go in ``sorted(stage)`` order. As in the JAX
package, the example flags reach every level's decoder (the reference
calls ``_get_pe_result`` with one argument where it takes two, a latent
``TypeError``), and images go to the backbone as the batch holds them,
without ``maybe_normalize_images`` (JAX ``multilevel.py:112-126``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from ..ops.resize import resize_bilinear
from ..typing import BatchKeys, ResultDict
from .common import Conv2d, Linear
from .lam import Batch, Lam

_PE_KEYS = (ResultDict.CLASS_EMBS, ResultDict.EXAMPLES_CLASS_SRC,
            ResultDict.EXAMPLES_CLASS_EMBS)


class MultiLevelPromptEncoder(nn.Module):
    """One ``PromptImageEncoder`` a level (reference:
    prompt_encoder.py:919-967): each key of the result is a list over the
    levels."""

    def __init__(self, prompt_encoders: Sequence[nn.Module]):
        super().__init__()
        self.prompt_encoders = nn.ModuleList(prompt_encoders)

    def forward(self, image_embeddings: List[torch.Tensor], points, boxes,
                masks, flag_examples: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, list]:
        result = {k: [] for k in _PE_KEYS}
        for encoder, level in zip(self.prompt_encoders, image_embeddings):
            out = encoder(level, points, boxes, masks, flag_examples,
                          generator)
            for key in result:
                result[key].append(out[key])
        return result

    def get_dense_pe(self) -> List[torch.Tensor]:
        return [enc.get_dense_pe() for enc in self.prompt_encoders]


class MultiLevelMaskDecoder(nn.Module):
    """(reference: mask_decoder.py:651-771). Each level's
    ``MaskDecoderLam`` runs its transformer, up-convs, class MLP and
    spatial convs; ``fm_projectors.{i}`` (1 x 1 conv) and
    ``ce_projectors.{i}`` (dense) take its map and class embeddings to the
    widest level's width."""

    def __init__(self, mask_decoders: Sequence[nn.Module],
                 embed_dims: Sequence[int], downsample_rate: int = 8,
                 segment_example_logits: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mask_decoders = nn.ModuleList(mask_decoders)
        self.segment_example_logits = segment_example_logits
        self.compute_dtype = dtype
        width = max(embed_dims)
        outs = [d // downsample_rate for d in embed_dims]
        self.fm_projectors = nn.ModuleList(
            Conv2d(d, width, 1, dtype=dtype) for d in outs)
        self.ce_projectors = nn.ModuleList(
            Linear(d, width, dtype=dtype) for d in outs)

    def forward(self, query_embeddings: List[torch.Tensor],
                image_pe: List[torch.Tensor], pe_result: Dict[str, list],
                flag_examples: torch.Tensor) -> torch.Tensor:
        maps, embs = [], []
        for i, (q, pe, decoder) in enumerate(zip(
                query_embeddings, image_pe, self.mask_decoders)):
            b, h, w, d = q.shape
            if self.segment_example_logits:
                e = pe_result[ResultDict.EXAMPLES_CLASS_EMBS][i]
                tokens = e.reshape(b, -1, e.shape[-1])
            else:
                tokens = pe_result[ResultDict.CLASS_EMBS][i]
            ce, keys = decoder.transformer(q, pe, tokens)
            x = keys.reshape(b, h, w, d)
            if decoder.output_upscaling is not None:
                x = decoder.output_upscaling(x)
                ce = decoder.class_mlp(ce)
            if decoder.spatial_convs is not None:
                x = decoder.spatial_convs(x)
            maps.append(x)
            embs.append(ce)
        target = maps[0].shape[1:3]
        fused_fm = fused_ce = 0.0
        for fm, ce, fm_proj, ce_proj in zip(maps, embs, self.fm_projectors,
                                            self.ce_projectors):
            fused_fm = fused_fm + fm_proj(
                resize_bilinear(fm, target, spatial_axes=(1, 2)))
            fused_ce = fused_ce + ce_proj(ce)
        seg = torch.einsum("bnd,bhwd->bnhw", fused_ce.float(),
                           fused_fm.float())
        if self.segment_example_logits:
            b, n = seg.shape[:2]
            c = flag_examples.shape[2]
            seg = seg.reshape((b, n // c, c) + seg.shape[2:])
            seg = torch.where(flag_examples.bool()[..., None, None], seg,
                              float("-inf")).amax(dim=1)
        return seg


class MultiLevelLam(Lam):
    """(reference: lam.py:531-582). Embeddings arrive as a stage dict
    ``{"stageN": (B, N, h, w, C)}``, or images go through the pyramid
    backbone. The result's EXAMPLES_CLASS_EMBS is the last level's. It
    serves whole episodes only, as the JAX one can."""

    def level_embeddings(self, batch: Batch):
        """(query levels, support levels) in ``sorted(stage)`` order."""
        if BatchKeys.EMBEDDINGS in batch:
            stages = batch[BatchKeys.EMBEDDINGS]
        elif BatchKeys.IMAGES in batch:
            images = batch[BatchKeys.IMAGES]
            b, n = images.shape[:2]
            out = self.image_encoder(images.reshape((b * n,)
                                                    + images.shape[2:]))
            stages = {k: v.reshape((b, n) + v.shape[1:])
                      for k, v in out.items()}
        else:
            raise ValueError("Either 'images' or 'embeddings' must be provided.")
        levels = [stages[k] for k in sorted(stages)]
        return [lv[:, 0] for lv in levels], [lv[:, 1:] for lv in levels]

    def _forward(self, batch: Batch,
                 generator: Optional[torch.Generator] = None) -> tuple:
        query, support = self.level_embeddings(batch)
        points, boxes, masks, flags = self.prepare_prompts(batch)
        pe_result = self.prompt_encoder(support, points, boxes, masks, flags,
                                        generator)
        seg = self.mask_decoder(query, self.prompt_encoder.get_dense_pe(),
                                pe_result, flags)
        return seg, {ResultDict.EXAMPLES_CLASS_EMBS:
                     pe_result[ResultDict.EXAMPLES_CLASS_EMBS][-1]}

    def generate_class_embeddings(self, example_batch: Batch) -> dict:
        raise NotImplementedError("the multi-level LAM serves whole "
                                  "episodes: call the model on the batch")

    def raw_decode(self, batch: Batch, class_embeddings: dict):
        raise NotImplementedError("the multi-level LAM serves whole "
                                  "episodes: call the model on the batch")
