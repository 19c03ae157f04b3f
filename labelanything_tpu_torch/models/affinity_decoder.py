"""DCAMA-style affinity mask decoder (counterpart of
``labelanything_tpu/models/affinity_decoder.py``; reference:
label_anything/models/mask_decoder.py:367-648).

The query image's features attend to every support image's features, with
the support masks, fused with their class-example embeddings, as values
(``AffinityTransformer``, one instance per (episode, class)); spatial convs
refine the result and three transposed convs upsample it 8 times to one
logit per pixel and class. A class that no example flags gets -inf logits
(the JAX package's dense form of the reference's batch-mask scatter), which
the bilinear upscale of ``Lam.postprocess_masks_fixed`` turns into -inf and
NaN (ROADMAP C4).

Module names are the JAX package's flax names (``up_conv0`` ... ``up_ln2``,
``out_conv``) and the reference's ``spatial_convs`` indices, so that
``utils.weights.state_dict_from_jax`` of a JAX affinity model loads with
``strict=True``.

``prototype_merge`` (few_type "PrototypeAffinity") is the JAX package's
reconstruction (JAX ``affinity_decoder.py:60-70, 181-264``): the
reference's branch cannot run (it splits heads 8 and 32 ways on the two
sides of one product and returns an unbound name), so both packages follow
the JAX version (ROADMAP C19). The class prototypes attend to the
class-maximum of the affinity maps, an MLP projects them to the last
up-conv's width, and a per-head prototype / affinity correlation joins the
upsampled maps before ``out_conv``.

Not ported: a ``transformer_feature_size`` other than the feature grid,
with which the JAX package cannot run (ROADMAP C3).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..typing import ResultDict
from .common import (AttentionMLPBlock, Conv2d, ConvTranspose2d, LayerNorm2d,
                     gelu)
from .mask_decoder import MLP
from .transformer import AffinityTransformer

# the prototype side's head split of prototype_merge
PROTO_HEADS = 8

CLASS_FUSIONS = ("sum", "mul", "softmax", "sigmoid")


class AffinityDecoder(nn.Module):
    """Affinity decoder (reference: mask_decoder.py:367-648). Channels-last
    in, logits (B, C, 8h, 8w) in the compute dtype out."""

    def __init__(self, transformer_dim: int, transformer: AffinityTransformer,
                 spatial_convs: Optional[int] = None,
                 classification_layer_downsample_rate: int = 8,
                 transformer_feature_size: Optional[int] = None,
                 class_fusion: str = "sum", prototype_merge: bool = False,
                 transformer_keys_are_images: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if class_fusion not in CLASS_FUSIONS:
            raise ValueError(f"unknown class_fusion {class_fusion!r}; one of "
                             f"{CLASS_FUSIONS}")
        td, ds = transformer_dim, classification_layer_downsample_rate
        depths = (td // (ds // 4), td // (ds // 2), td // ds)
        self.compute_dtype = dtype
        self.transformer = transformer
        self.transformer_feature_size = transformer_feature_size
        self.class_fusion = class_fusion
        self.transformer_keys_are_images = transformer_keys_are_images
        for i, (cin, cout) in enumerate(zip((td,) + depths[:2], depths)):
            self.add_module(f"up_conv{i}", ConvTranspose2d(
                cin, cout, 2, stride=2, dtype=dtype))
            self.add_module(f"up_ln{i}", LayerNorm2d(cout, dtype=dtype))
        self.prototype_merge = prototype_merge
        if prototype_merge:
            if depths[2] % PROTO_HEADS:
                raise ValueError("transformer_dim / downsample_rate must be "
                                 "divisible by the 8-way prototype head split")
            self.attn_token_to_image = AttentionMLPBlock(
                td, 1, 2048, 8, act=gelu, dtype=dtype)
            self.class_embedding_mlp = MLP(td, td, depths[2], 3, dtype=dtype)
            self.proto_ln = LayerNorm2d(PROTO_HEADS, dtype=dtype)
        self.out_conv = Conv2d(
            depths[2] + (PROTO_HEADS if prototype_merge else 0), 1, 1,
            dtype=dtype)
        self.spatial_convs = None
        if spatial_convs is not None:
            # conv at 3i, LayerNorm2d at 3i + 1, activation at 3i + 2
            layers = []
            for i in range(spatial_convs):
                layers.append(Conv2d(td, td, 3, padding=1, dtype=dtype))
                if i < spatial_convs - 1:
                    layers += [LayerNorm2d(td, dtype=dtype),
                               nn.GELU(approximate="tanh")]
            self.spatial_convs = nn.Sequential(*layers)

    def _apply_classes_to_features(self, features: torch.Tensor,
                                   classes: torch.Tensor) -> torch.Tensor:
        """features (B, M, C, h, w, D), classes (B, M, C, D) (reference:
        mask_decoder.py:493-509)."""
        cls = classes[:, :, :, None, None, :]
        if self.class_fusion == "sum":
            return features + cls
        if self.class_fusion == "mul":
            return features * cls
        if self.class_fusion == "softmax":
            b, m, c, d = classes.shape
            soft = torch.softmax(classes.reshape(b, m * c, d), dim=1)
            return features * soft.reshape(b, m, c, d)[:, :, :, None, None, :]
        return features * torch.sigmoid(cls)

    def forward(self, query_embeddings: torch.Tensor,
                support_embeddings: torch.Tensor, image_pe: torch.Tensor,
                pe_result: dict, flag_examples: torch.Tensor) -> torch.Tensor:
        """query_embeddings (B, h, w, D), support_embeddings (B, M, h, w,
        D), image_pe (1, h, w, D), pe_result with EXAMPLES_CLASS_SRC
        (B M C, h, w, D) and EXAMPLES_CLASS_EMBS (B, M, C, D), flag_examples
        (B, M, C) -> logits (B, C, 8h, 8w), -inf for a class no example
        flags."""
        b, m, h, w, d = support_embeddings.shape
        tfs = self.transformer_feature_size
        if tfs is not None and (tfs, tfs) != (h, w):
            raise NotImplementedError(
                f"transformer_feature_size {tfs} differs from the {h} x {w} "
                f"feature grid: the JAX package rescales the features but not "
                f"the positional map, and cannot run such a model (ROADMAP "
                f"C3); only None or the grid size is ported")
        support_masks = pe_result[ResultDict.EXAMPLES_CLASS_SRC]
        c = support_masks.shape[0] // (b * m)
        support_masks = self._apply_classes_to_features(
            support_masks.reshape(b, m, c, h, w, d),
            pe_result[ResultDict.EXAMPLES_CLASS_EMBS])

        # one instance per (episode, class): (B C, hw, D) queries against
        # (B C, M hw, D) keys and values
        q = query_embeddings.reshape(b, 1, h * w, d).expand(b, c, h * w, d)
        sm = support_masks.transpose(1, 2).reshape(b * c, m * h * w, d)
        if self.transformer_keys_are_images:
            se = support_embeddings.reshape(b, 1, m * h * w, d).expand(
                b, c, m * h * w, d).reshape(b * c, m * h * w, d)
        else:
            se = sm
        q = self.transformer(q.reshape(b * c, h * w, d), se, sm, image_pe)
        q = q.reshape(b * c, h, w, d)
        if self.spatial_convs is not None:
            q = self.spatial_convs(q)
        class_valid = flag_examples.bool().any(dim=1)
        if self.prototype_merge:
            logits = self._prototype_merge(
                q, pe_result[ResultDict.CLASS_EMBS], image_pe, class_valid)
        else:
            for i in range(3):
                q = gelu(self._up_ln(i)(self._up_conv(i)(q)))
            logits = self.out_conv(q).reshape(b, c, 8 * h, 8 * w)
        return torch.where(class_valid[:, :, None, None], logits,
                           float("-inf"))

    def _up_conv(self, i: int) -> nn.Module:
        return getattr(self, f"up_conv{i}")

    def _up_ln(self, i: int) -> nn.Module:
        return getattr(self, f"up_ln{i}")

    def _prototype_merge(self, q: torch.Tensor, prototypes: torch.Tensor,
                         image_pe: torch.Tensor,
                         class_valid: torch.Tensor) -> torch.Tensor:
        """q (B*C, h, w, D) after the spatial convs, prototypes (B, C, D),
        image_pe (1, h, w, D), class_valid (B, C) -> logits (B, C, 8h, 8w)
        (JAX ``_prototype_merge``)."""
        bc, h, w, d = q.shape
        b, c = class_valid.shape
        qd = q.reshape(b, c, h, w, d)
        # the class-maximum map, classes no example flags left out
        neg = torch.finfo(qd.dtype).min
        reduced = torch.where(class_valid[:, :, None, None, None], qd,
                              torch.full_like(qd, neg)).amax(dim=1)
        keys = (reduced + image_pe).reshape(b, h * w, d)
        protos = self.class_embedding_mlp(
            self.attn_token_to_image(prototypes, keys, keys))
        for i in range(2):
            q = gelu(self._up_ln(i)(self._up_conv(i)(q)))
        q = self._up_conv(2)(q)                       # (B*C, 8h, 8w, D3)
        h8, w8, d3 = q.shape[1:]
        aff = q.reshape(b, c, h8, w8, PROTO_HEADS, d3 // PROTO_HEADS)
        pr = protos.reshape(b, c, PROTO_HEADS, d3 // PROTO_HEADS).to(aff.dtype)
        proto_logits = torch.einsum("bcxyhd,bchd->bcxyh", aff, pr).reshape(
            bc, h8, w8, PROTO_HEADS)
        feats = torch.cat([gelu(self._up_ln(2)(q)),
                           gelu(self.proto_ln(proto_logits))], dim=-1)
        return self.out_conv(feats).reshape(b, c, h8, w8)
