"""SAM ViT encoder builders (counterpart of
``labelanything_tpu/models/build_encoder.py``; reference:
label_anything/models/build_encoder.py): ViT-B, ViT-L and ViT-H at the
published widths of ``facebookresearch/segment-anything``. ViT-H's heads
are 80 wide and run the packed rel-pos attention kernels."""

from __future__ import annotations

from typing import Union

import torch

from .image_encoder import ImageEncoderViT

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
               remat: Union[bool, str, None] = False) -> ImageEncoderViT:
    cfg = vit_configs[config_name]
    return ImageEncoderViT(
        img_size=image_size, patch_size=SAM_PATCH_SIZE,
        embed_dim=cfg["embed_dim"], depth=cfg["depth"],
        num_heads=cfg["num_heads"], mlp_ratio=4, out_chans=PROMPT_EMBED_DIM,
        qkv_bias=True, window_size=14,
        global_attn_indexes=cfg["global_attn_indexes"],
        project_last_hidden=project_last_hidden, dtype=dtype, remat=remat)


def build_vit_h(**kwargs) -> ImageEncoderViT:
    return _build_vit("vit_h", **kwargs)


def build_vit_l(**kwargs) -> ImageEncoderViT:
    return _build_vit("vit_l", **kwargs)


def build_vit_b(**kwargs) -> ImageEncoderViT:
    return _build_vit("vit_b", **kwargs)


ENCODERS = {"vit_h": build_vit_h, "vit_l": build_vit_l, "vit_b": build_vit_b}
