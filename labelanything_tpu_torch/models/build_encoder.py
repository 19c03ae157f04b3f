"""Image-encoder builders (counterpart of
``labelanything_tpu/models/build_encoder.py``; reference:
label_anything/models/build_encoder.py): the SAM ViT-B, ViT-L and ViT-H at
the published widths of ``facebookresearch/segment-anything`` (ViT-H's
heads are 80 wide and run the packed rel-pos attention kernels;
``fused_window`` and ``int8_scores``, off by default, are
``ImageEncoderViT``'s opt-in kernels); the plain ViTs of Hugging Face's
``facebook/vit-mae-base``, ``google/vit-base-patch16-224-in21k`` and
``facebook/dino-vitb8`` (:class:`.vit.StandardViT`); and the pyramid
backbones ResNet-50, Swin-B and SegFormer's MiT-b0."""

from __future__ import annotations

from typing import Union

import torch

from .image_encoder import ImageEncoderViT
from .vit import StandardViT

vit_configs = dict(
    vit_h=dict(embed_dim=1280, depth=32, num_heads=16,
               global_attn_indexes=(7, 15, 23, 31)),
    vit_l=dict(embed_dim=1024, depth=24, num_heads=16,
               global_attn_indexes=(5, 11, 17, 23)),
    vit_b=dict(embed_dim=768, depth=12, num_heads=12,
               global_attn_indexes=(2, 5, 8, 11)),
)

SAM_IMAGE_SIZE = 1024
SAM_PATCH_SIZE = 16
PROMPT_EMBED_DIM = 256


def _build_vit(config_name: str, project_last_hidden: bool = True,
               image_size: int = SAM_IMAGE_SIZE,
               dtype: torch.dtype = torch.float32,
               remat: Union[bool, str, None] = False,
               fused_window: bool = False,
               int8_scores: bool = False) -> ImageEncoderViT:
    cfg = vit_configs[config_name]
    return ImageEncoderViT(
        img_size=image_size, patch_size=SAM_PATCH_SIZE,
        embed_dim=cfg["embed_dim"], depth=cfg["depth"],
        num_heads=cfg["num_heads"], mlp_ratio=4, out_chans=PROMPT_EMBED_DIM,
        qkv_bias=True, window_size=14,
        global_attn_indexes=cfg["global_attn_indexes"],
        project_last_hidden=project_last_hidden, dtype=dtype, remat=remat,
        fused_window=fused_window, int8_scores=int8_scores)


def build_vit_h(**kwargs) -> ImageEncoderViT:
    return _build_vit("vit_h", **kwargs)


def build_vit_l(**kwargs) -> ImageEncoderViT:
    return _build_vit("vit_l", **kwargs)


def build_vit_b(**kwargs) -> ImageEncoderViT:
    return _build_vit("vit_b", **kwargs)


def _plain_vit(patch_size: int, pretrain_grid: int = 14,
               project_last_hidden: bool = False, image_size=None,
               **kwargs) -> StandardViT:
    """A ViT-B of ``patch_size``: 768 wide, 12 blocks, 12 heads. It has no
    SAM neck and takes any image size, so ``project_last_hidden`` and
    ``image_size`` are not used."""
    return StandardViT(patch_size=patch_size, embed_dim=768, depth=12,
                       num_heads=12, pretrain_grid=pretrain_grid, **kwargs)


def build_vit_b_mae(**kwargs) -> StandardViT:
    """facebook/vit-mae-base (reference: build_encoder.py:103-106)."""
    return _plain_vit(16, **kwargs)


def build_vit_b_imagenet_i21k(**kwargs) -> StandardViT:
    """google/vit-base-patch16-224-in21k."""
    return _plain_vit(16, **kwargs)


def build_vit_dino_b8(**kwargs) -> StandardViT:
    """facebook/dino-vitb8: patches of 8, a 28 x 28 pretraining grid."""
    return _plain_vit(8, pretrain_grid=28, **kwargs)


def _build_resnet50(**kwargs):
    from .pyramid_encoders import build_resnet50

    return build_resnet50(**kwargs)


def _build_swin_b(**kwargs):
    from .pyramid_encoders import build_swin_b

    return build_swin_b(**kwargs)


def _build_mit_b0(**kwargs):
    from .segformer import build_mit_b0

    return build_mit_b0(**kwargs)


ENCODERS = {
    "vit_h": build_vit_h, "vit_l": build_vit_l, "vit_b": build_vit_b,
    "vit_b_mae": build_vit_b_mae,
    "vit_b_imagenet_i21k": build_vit_b_imagenet_i21k,
    "vit_dino_b8": build_vit_dino_b8,
    # the pyramid backbones (reference: build_encoder.py:118-152)
    "resnet50": _build_resnet50,
    "swin_b": _build_swin_b,
    "mit_b0": _build_mit_b0,
    "nvidia/segformer-b0-finetuned-ade-512-512": _build_mit_b0,
}
