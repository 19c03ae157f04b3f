"""Feature-pyramid backbones of the multi-level LAM and of
``preprocess_images_to_feature_pyramids`` (counterpart of
``labelanything_tpu/models/pyramid_encoders.py``; reference:
label_anything/models/build_encoder.py:118-152, ResNet-50 and Swin-B
through ``transformers.AutoBackbone``, stages 2 to 4).

Both wrap the port's own modules: PPNet's ResNet (``models/ppnet.py``) with
torchvision's strides and ReLUs, and DCAMA's Swin (``models/swin.py``). They
take channels-last images (B, H, W, 3) and return ``{"stageN": (B, h, w,
C)}`` channels-last maps, stage N being layer N (stride 4, 8, 16, 32).
Their state dicts are the wrapped modules' under ``resnet.`` / ``swin.``
(the names ``reference_baseline_state_dict`` gives PPNet's and DCAMA's
backbones), plus Swin's per-stage ``norm_stageN``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from .ppnet import ResNetSem
from .swin import SwinTransformer

_STAGE_TO_LAYER = {"stage1": "layer1", "stage2": "layer2",
                   "stage3": "layer3", "stage4": "layer4"}

# per-stage channel widths, for sizing the multi-level model
RESNET50_STAGE_DIMS = {"stage1": 256, "stage2": 512,
                       "stage3": 1024, "stage4": 2048}
SWIN_B_STAGE_DIMS = {"stage1": 128, "stage2": 256,
                     "stage3": 512, "stage4": 1024}


class ResNet50Backbone(nn.Module):
    """ResNet-50 with torchvision's strides and every ReLU (reference:
    build_encoder.py:118-125, ``microsoft/resnet-50``); BatchNorm on its
    running statistics."""

    def __init__(self, out_features: Sequence[str] = ("stage2", "stage3",
                                                      "stage4"),
                 layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.out_features = tuple(out_features)
        self.resnet = ResNetSem(layers=tuple(layers), quirk_last_relu=False,
                                dilated=False)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        maps = self.resnet.stages(x.permute(0, 3, 1, 2))
        return {s: maps[_STAGE_TO_LAYER[s]].permute(0, 2, 3, 1)
                for s in self.out_features}


class SwinBackbone(nn.Module):
    """Swin-B (reference: build_encoder.py:128-135, ``microsoft/swin-base-
    patch4-window12-384``): each requested stage's last block, through a
    LayerNorm of its own (eps 1e-5), as the Hugging Face backbone's
    ``hidden_states_norms``."""

    def __init__(self, out_features: Sequence[str] = ("stage2", "stage3",
                                                      "stage4"),
                 img_size: int = 384, embed_dim: int = 128,
                 depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32),
                 window_size: int = 12):
        super().__init__()
        self.out_features = tuple(out_features)
        self.stage_last = np.cumsum(depths) - 1
        self.swin = SwinTransformer(img_size=img_size, embed_dim=embed_dim,
                                    depths=tuple(depths),
                                    num_heads=tuple(num_heads),
                                    window_size=window_size)
        for stage in self.out_features:
            dim = embed_dim * 2 ** (int(stage[len("stage"):]) - 1)
            setattr(self, f"norm_{stage}", nn.LayerNorm(dim, eps=1e-5))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = self.swin(x)
        return {s: getattr(self, f"norm_{s}")(
                    feats[self.stage_last[int(s[len("stage"):]) - 1]])
                for s in self.out_features}


def build_resnet50(out_features=("stage2", "stage3", "stage4"),
                   **kwargs) -> ResNet50Backbone:
    """(reference: build_encoder.py:118-125)."""
    return ResNet50Backbone(out_features=tuple(out_features), **kwargs)


def build_swin_b(out_features=("stage2", "stage3", "stage4"),
                 image_size: int = 384, **kwargs) -> SwinBackbone:
    """(reference: build_encoder.py:128-135)."""
    return SwinBackbone(out_features=tuple(out_features), img_size=image_size,
                        **kwargs)
