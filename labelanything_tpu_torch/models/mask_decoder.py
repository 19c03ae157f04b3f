"""Prototype mask decoder (counterpart of
``labelanything_tpu/models/mask_decoder.py``; reference:
label_anything/models/mask_decoder.py).

Class embeddings and query-image features are fused by a two-way
transformer, the image side is upsampled by two transposed convs (and,
optionally, refined by spatial convs), and every pixel is classified by a
class-embedding . pixel-embedding product accumulated in fp32. Ported: the
single-level "Prototype" decoder with one embedding per class, the
configuration the LAM checkpoints use; per-example logits, multi-level
classification and convolutional classification are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..typing import ResultDict
from .common import Conv2d, ConvTranspose2d, LayerNorm2d, Linear
from .transformer import TwoWayTransformer


class MLP(nn.Module):
    """ReLU MLP head (reference: mask_decoder.py:776-805)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            Linear(i, o, dtype=dtype) for i, o in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoderLam(nn.Module):
    """Prototype-based mask decoder (reference: mask_decoder.py:169-363).
    Channels-last in, logits (B, C, h, w) out."""

    def __init__(self, transformer_dim: int, transformer: TwoWayTransformer,
                 spatial_convs: Optional[int] = None,
                 classification_layer_downsample_rate: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        td, ds, s = transformer_dim, classification_layer_downsample_rate, 2
        if ds <= 1:
            raise NotImplementedError("the decoder without upscaling is not "
                                      "ported")
        first = td // (ds // 2)
        self.compute_dtype = dtype
        self.transformer = transformer
        # indices follow the reference Sequential (activation at 2)
        self.output_upscaling = nn.Sequential(
            ConvTranspose2d(td, first, s, stride=s, dtype=dtype),
            LayerNorm2d(first, dtype=dtype),
            nn.GELU(approximate="tanh"),
            ConvTranspose2d(first, td // ds, s, stride=s, dtype=dtype))
        self.class_mlp = MLP(td, td, td // ds, 3, dtype=dtype)
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

    def forward(self, query_embeddings: torch.Tensor, image_pe: torch.Tensor,
                pe_result: dict) -> torch.Tensor:
        """query_embeddings (B, h, w, D), image_pe (1, h, w, D), pe_result
        with CLASS_EMBS (B, C, D) -> logits (B, C, 4h, 4w) in fp32. The
        reference also takes the class validity flags; its attention ignores
        them (see common.Attention), so this port takes none."""
        b, h, w, d = query_embeddings.shape
        class_embeddings, keys = self.transformer(
            query_embeddings, image_pe, pe_result[ResultDict.CLASS_EMBS])
        x = self.output_upscaling(keys.reshape(b, h, w, d))
        class_embeddings = self.class_mlp(class_embeddings)
        if self.spatial_convs is not None:
            x = self.spatial_convs(x)
        return torch.einsum("bnd,bhwd->bnhw", class_embeddings.float(),
                            x.float())
