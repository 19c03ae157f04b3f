"""LAM, the Label-Anything model (counterpart of
``labelanything_tpu/models/lam.py``; reference: label_anything/models/lam.py).

As in the JAX package, the forward returns logits in the fixed
``image_size`` frame with the padded region of each query set to -inf
(background 0), and prompt modalities are chosen by which batch keys are
present. Batches are dicts of tensors in the JAX package's channels-last
layout (``images`` (B, N, S, S, 3), index 0 along N is the query).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..ops.image_norm import maybe_normalize_images
from ..ops.resize import resize_bilinear
from ..typing import BatchKeys, ResultDict
from .affinity_decoder import AffinityDecoder
from .common import Conv2d, LayerNorm2d

Batch = Dict[str, Any]


def get_preprocess_shape(oldh: torch.Tensor, oldw: torch.Tensor,
                         long_side_length: int):
    """Long-side resize shape ``floor(old * S / max(h, w) + 0.5)`` in fp32
    (reference: data/utils.py:441-449)."""
    oldh, oldw = oldh.float(), oldw.float()
    scale = long_side_length * 1.0 / torch.maximum(oldh, oldw)
    return (torch.floor(oldh * scale + 0.5).long(),
            torch.floor(oldw * scale + 0.5).long())


class Neck(nn.Sequential):
    """image_embed_dim -> embed_dim projection (reference:
    build_lam.py:150-171): 1x1 conv, LayerNorm2d, 3x3 conv, LayerNorm2d."""

    def __init__(self, in_dim: int, embed_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(
            Conv2d(in_dim, embed_dim, 1, bias=False, dtype=dtype),
            LayerNorm2d(embed_dim, dtype=dtype),
            Conv2d(embed_dim, embed_dim, 3, padding=1, bias=False, dtype=dtype),
            LayerNorm2d(embed_dim, dtype=dtype))


class Lam(nn.Module):
    """Multi-class few-shot segmentation model (reference: lam.py:24-453)."""

    def __init__(self, prompt_encoder: nn.Module, mask_decoder: nn.Module,
                 image_encoder: Optional[nn.Module] = None,
                 neck: Optional[nn.Module] = None, image_size: int = 1024,
                 custom_preprocess: bool = True):
        super().__init__()
        self.image_encoder = image_encoder
        self.neck = neck
        self.prompt_encoder = prompt_encoder
        self.mask_decoder = mask_decoder
        self.image_size = image_size
        self.custom_preprocess = custom_preprocess

    def prepare_embeddings(self, batch: Batch) -> torch.Tensor:
        """(B, N, h, w, D) features of every image of the batch, from
        precomputed ``embeddings`` or from ``images`` through the encoder."""
        encoder = None
        if BatchKeys.EMBEDDINGS in batch:
            x = batch[BatchKeys.EMBEDDINGS]
        elif BatchKeys.IMAGES in batch:
            if self.image_encoder is None:
                # the JAX Lam calls its absent encoder and fails with a
                # TypeError (ROADMAP C13)
                raise ValueError(
                    "the batch carries images but the model has no image "
                    "encoder (lam_no_vit reads embeddings): build lam_b, "
                    "lam_l or lam_h, or give embeddings")
            x = maybe_normalize_images(
                batch[BatchKeys.IMAGES], batch[BatchKeys.DIMS], self.image_size,
                self.custom_preprocess, batch.get(BatchKeys.RESIZED_DIMS))
            encoder = self.image_encoder
        else:
            raise ValueError("Either 'images' or 'embeddings' must be provided.")
        b, n = x.shape[:2]
        flat = x.reshape((b * n,) + x.shape[2:])
        if encoder is not None:
            flat = encoder(flat)
        if self.neck is not None:
            flat = self.neck(flat)
        return flat.reshape((b, n) + flat.shape[1:])

    @staticmethod
    def prepare_prompts(batch: Batch):
        def pair(key, flag):
            return (batch[key], batch[flag]) if key in batch else None

        return (pair(BatchKeys.PROMPT_POINTS, BatchKeys.FLAG_POINTS),
                pair(BatchKeys.PROMPT_BBOXES, BatchKeys.FLAG_BBOXES),
                pair(BatchKeys.PROMPT_MASKS, BatchKeys.FLAG_MASKS),
                batch[BatchKeys.FLAG_EXAMPLES])

    def _encode_prompts(self, support_embeddings: torch.Tensor, batch: Batch,
                        generator: Optional[torch.Generator] = None) -> dict:
        points, boxes, masks, flag_examples = self.prepare_prompts(batch)
        return self.prompt_encoder(support_embeddings, points, boxes, masks,
                                   flag_examples, generator)

    def get_dense_pe(self) -> torch.Tensor:
        return self.prompt_encoder.get_dense_pe()

    def _decode_raw(self, query_embeddings: torch.Tensor, pe_result: dict,
                    support_embeddings: Optional[torch.Tensor] = None,
                    flag_examples: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """Decoder-resolution logits (B, C, h, w). The affinity decoder also
        takes the support images' features and the example flags (JAX
        ``lam.py:183-190``)."""
        pe = self.get_dense_pe()
        if isinstance(self.mask_decoder, AffinityDecoder):
            return self.mask_decoder(query_embeddings, support_embeddings, pe,
                                     pe_result, flag_examples)
        return self.mask_decoder(query_embeddings, pe, pe_result)

    def _forward(self, batch: Batch,
                 generator: Optional[torch.Generator] = None) -> tuple:
        """(decoder-resolution logits, the prompt encoder's result) of a
        whole episode, before the postprocess (JAX ``lam.py:170-193``)."""
        embeddings = self.prepare_embeddings(batch)
        pe_result = self._encode_prompts(embeddings[:, 1:], batch, generator)
        seg = self._decode_raw(embeddings[:, 0], pe_result, embeddings[:, 1:],
                               batch[BatchKeys.FLAG_EXAMPLES])
        return seg, pe_result

    def forward(self, batch: Batch,
                generator: Optional[torch.Generator] = None) -> dict:
        """``generator`` (training): the CPU ``torch.Generator`` from which
        a ``RandomMatrixEncoder`` draws the classes' bank rows; without it
        class c takes row c. A ``train()``-mode forward of a model built
        with dropout draws its masks from the generator of
        ``models.common.dropout_generator``, which the train step sets.
        The result also holds the pooler's MASK_EMBEDDINGS where the prompt
        encoder gives them."""
        seg, pe_result = self._forward(batch, generator)
        seg = self.postprocess_masks_fixed(seg, batch[BatchKeys.DIMS])
        if BatchKeys.FLAG_GTS in batch:
            seg = torch.where(batch[BatchKeys.FLAG_GTS][:, :, None, None], seg,
                              float("-inf"))
        result = {ResultDict.LOGITS: seg,
                  ResultDict.EXAMPLES_CLASS_EMBS:
                      pe_result[ResultDict.EXAMPLES_CLASS_EMBS]}
        if ResultDict.MASK_EMBEDDINGS in pe_result:
            result[ResultDict.MASK_EMBEDDINGS] = \
                pe_result[ResultDict.MASK_EMBEDDINGS]
        return result

    def generate_class_embeddings(self, example_batch: Batch) -> dict:
        """Class embeddings of a support batch whose every image is an
        example (reference: lam.py:349-361)."""
        return self._encode_prompts(self.prepare_embeddings(example_batch),
                                    example_batch)

    def predict(self, batch: Batch, class_embeddings: dict) -> torch.Tensor:
        """Logits of the query (index 0) against cached class embeddings
        (reference: lam.py:362-382). Not for the affinity decoder, which
        decodes against the support images themselves: call the model on
        the whole episode."""
        return self.postprocess_masks_fixed(
            self.raw_decode(batch, class_embeddings), batch[BatchKeys.DIMS])

    def raw_decode(self, batch: Batch, class_embeddings: dict
                   ) -> torch.Tensor:
        """Decoder-resolution logits of the query against cached class
        embeddings, before the postprocess (JAX ``lam.py:234-245``; used by
        ``inference.predict_original_resolution``). Not for the affinity
        decoder (ROADMAP C9), as :meth:`predict`."""
        if isinstance(self.mask_decoder, AffinityDecoder):
            raise NotImplementedError(
                "predict against cached class embeddings is not defined for "
                "the affinity decoder, which needs the support images' "
                "features (the JAX Lam.predict hands it support_embeddings="
                "None, which it cannot take); call the model on the whole "
                "episode")
        return self._decode_raw(self.prepare_embeddings(batch)[:, 0],
                                class_embeddings)

    def postprocess_masks_fixed(self, seg: torch.Tensor,
                                dims: torch.Tensor) -> torch.Tensor:
        """Upscale (B, C, h, w) logits to the fixed (S, S) frame and fill
        each query's pad region with 0 (background) or -inf (the other
        classes). Under bf16 compute the upscale runs in bf16, as in the
        JAX package."""
        s = self.image_size
        if self.mask_decoder.compute_dtype == torch.bfloat16:
            seg = seg.to(torch.bfloat16)
        seg = resize_bilinear(seg, (s, s))
        if not self.custom_preprocess:
            return seg
        qdims = dims.reshape(dims.shape[0], -1, 2)[:, 0]
        ih, iw = get_preprocess_shape(qdims[:, 0], qdims[:, 1], s)
        idx = torch.arange(s, device=seg.device)
        valid = ((idx[None, :] < ih[:, None])[:, :, None]
                 & (idx[None, :] < iw[:, None])[:, None, :])
        fill = torch.full((seg.shape[1],), float("-inf"), dtype=seg.dtype,
                          device=seg.device)
        fill[0] = 0.0
        return torch.where(valid[:, None], seg, fill[None, :, None, None])
