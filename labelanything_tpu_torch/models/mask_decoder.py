"""Prototype mask decoder (counterpart of
``labelanything_tpu/models/mask_decoder.py``; reference:
label_anything/models/mask_decoder.py).

Class embeddings and query-image features are fused by a fusion
transformer (two-way, one-way or none), the image side is upsampled by two
transposed convs (and, optionally, refined by spatial convs), and every
pixel is classified by a class-embedding . pixel-embedding product
accumulated in fp32. The variants of the JAX module are ported:

* ``segment_example_logits``: one embedding per (example, class); each
  class's logit is the maximum over the examples that flag it, -inf where
  none does (JAX ``mask_decoder.py:112-123, 172-179``);
* ``classification_levels=2``: the same product also at the transformer's
  resolution, bilinearly resized and merged with the upsampled level by
  the 3 x 3 ``level_reducer`` (l.204-221);
* ``conv_classification``: each embedding becomes a 3 x 3 kernel through
  the two ``prototype_tconv`` transposed convs and is correlated with the
  pixel embeddings with 2 pixels of padding, one grouped convolution over
  the batch (l.146-166);
* the decoder without upscaling (``conv_upsample_stride`` and
  ``classification_layer_downsample_rate`` both 1, l.65-87).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear
from ..typing import BatchKeys, ResultDict
from .common import Conv2d, ConvTranspose2d, Dropout, LayerNorm2d, Linear


class MLP(nn.Module):
    """ReLU MLP head (reference: mask_decoder.py:776-805); dropout after each
    hidden activation (JAX ``mask_decoder.py:24-45``)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            Linear(i, o, dtype=dtype) for i, o in zip(dims[:-1], dims[1:]))
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.dropout(F.relu(x))
        return x


class MaskDecoderLam(nn.Module):
    """Prototype-based mask decoder (reference: mask_decoder.py:169-363).
    Channels-last in, logits (B, C, h', w') out."""

    def __init__(self, transformer_dim: int, transformer: nn.Module,
                 spatial_convs: Optional[int] = None,
                 classification_layer_downsample_rate: int = 8,
                 dtype: torch.dtype = torch.float32,
                 segment_example_logits: bool = False,
                 conv_upsample_stride: int = 2,
                 classification_levels: int = 1,
                 conv_classification: bool = False, dropout: float = 0.0):
        super().__init__()
        td, ds, s = (transformer_dim, classification_layer_downsample_rate,
                     conv_upsample_stride)
        first = td // (ds // 2 if ds > 1 else 1)
        self.compute_dtype = dtype
        self.transformer = transformer
        self.segment_example_logits = segment_example_logits
        self.classification_levels = classification_levels
        self.output_upscaling = self.class_mlp = None
        if s > 1 or ds > 1:
            # indices follow the reference Sequential (activation at 2)
            self.output_upscaling = nn.Sequential(
                ConvTranspose2d(td, first, s, stride=s, dtype=dtype),
                LayerNorm2d(first, dtype=dtype),
                nn.GELU(approximate="tanh"),
                ConvTranspose2d(first, td // ds, s, stride=s, dtype=dtype))
            self.class_mlp = MLP(td, td, td // ds, 3, dtype=dtype,
                                 dropout=dropout)
        if classification_levels > 1:
            self.level_reducer = Conv2d(2, 1, 3, padding=1, dtype=dtype)
        self.spatial_convs = None
        if spatial_convs is not None:
            # conv at 3i, LayerNorm2d at 3i + 1, activation at 3i + 2
            layers = []
            for i in range(spatial_convs):
                layers.append(Conv2d(td // ds, td // ds, 3, padding=1,
                                     dtype=dtype))
                if i < spatial_convs - 1:
                    layers += [LayerNorm2d(td // ds, dtype=dtype),
                               nn.GELU(approximate="tanh")]
            self.spatial_convs = nn.Sequential(*layers)
        self.prototype_tconv = None
        if conv_classification:
            # flax's 3 x 3 ConvTranspose with "SAME" padding at stride 1
            self.prototype_tconv = nn.ModuleList(
                ConvTranspose2d(td // ds, td // ds, 3, padding=1, bias=False,
                                dtype=dtype)
                for _ in range(2))

    def _classify(self, query: torch.Tensor, class_embeddings: torch.Tensor,
                  flag_examples: torch.Tensor) -> torch.Tensor:
        """query (B, h, w, D), class embeddings (B, n, D) -> logits
        (B, C, h', w') in fp32."""
        b, h, w, d = query.shape
        n = class_embeddings.shape[1]
        if self.prototype_tconv is not None:
            ce = class_embeddings.reshape(b * n, 1, 1, d)
            for tconv in self.prototype_tconv:
                ce = tconv(ce)
            kh, kw = ce.shape[1:3]
            # one group per episode: (1, B D, h, w) against (B n, D, kh, kw)
            dt = self.compute_dtype
            weight = ce.reshape(b * n, kh, kw, d).permute(0, 3, 1, 2)
            seg = F.conv2d(query.to(dt).permute(0, 3, 1, 2).reshape(
                1, b * d, h, w), weight.to(dt), padding=2, groups=b)
            seg = seg.reshape(b, n, seg.shape[-2], seg.shape[-1]).float()
        else:
            seg = torch.einsum("bnd,bhwd->bnhw", class_embeddings.float(),
                               query.float())
        if self.segment_example_logits:
            c = flag_examples.shape[2]
            seg = seg.reshape((b, n // c, c) + seg.shape[-2:])
            valid = flag_examples.bool()[..., None, None]
            seg = torch.where(valid, seg, float("-inf")).amax(dim=1)
        return seg

    def forward(self, query_embeddings: torch.Tensor, image_pe: torch.Tensor,
                pe_result: dict) -> torch.Tensor:
        """query_embeddings (B, h, w, D), image_pe (1, h, w, D), pe_result
        with CLASS_EMBS (B, C, D), or with ``segment_example_logits``
        EXAMPLES_CLASS_EMBS (B, M, C, D) and FLAG_EXAMPLES (B, M, C) ->
        logits in fp32. The reference also hands the transformer the class
        validity flags; its attention ignores them (see
        common.Attention), so this port takes none."""
        b, h, w, d = query_embeddings.shape
        flag_examples = pe_result.get(BatchKeys.FLAG_EXAMPLES)
        if self.segment_example_logits:
            embs = pe_result[ResultDict.EXAMPLES_CLASS_EMBS]
            tokens = embs.reshape(b, -1, embs.shape[-1])
        else:
            tokens = pe_result[ResultDict.CLASS_EMBS]
        class_embeddings, keys = self.transformer(query_embeddings, image_pe,
                                                  tokens)
        x = keys.reshape(b, h, w, d)
        coarse = None
        if self.classification_levels > 1:
            coarse = self._classify(x, class_embeddings, flag_examples)
        if self.output_upscaling is not None:
            x = self.output_upscaling(x)
            class_embeddings = self.class_mlp(class_embeddings)
        if self.spatial_convs is not None:
            x = self.spatial_convs(x)
        seg = self._classify(x, class_embeddings, flag_examples)
        if coarse is None:
            return seg
        h0, w0 = seg.shape[-2:]
        stacked = torch.stack([seg, resize_bilinear(coarse, (h0, w0))], -1)
        merged = self.level_reducer(stacked.reshape((-1, h0, w0, 2)))
        return merged.reshape(seg.shape).float()
