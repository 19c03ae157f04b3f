"""LAM model factory (counterpart of ``labelanything_tpu/models/build_lam.py``;
reference: label_anything/models/build_lam.py:96-300).

Builders return modules whose parameters are fp32 and whose compute dtype is
``dtype``; weights come from :mod:`..utils.weights` (a seeded init or JAX
parameters). Ported: a SAM ViT-B, ViT-L or ViT-H encoder, or none (precomputed
embeddings: ``build_lam_no_vit``), with the prototype decoder and the
two-way fusion transformer.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .build_encoder import build_vit_b, build_vit_h, build_vit_l
from .lam import Lam, Neck
from .mask_decoder import MaskDecoderLam
from .prompt_encoder import (IdentityClassEncoder, PromptImageEncoder,
                             RandomMatrixEncoder)
from .transformer import TwoWayTransformer

SAM_EMBED_DIM = 256

_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "fp32": torch.float32, "float32": torch.float32}


def norm_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """Accept the config's dtype strings ("bf16", "float32", ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[dtype.lower()]


def _two_way(embed_dim: int, dtype: torch.dtype,
             shared_keys: bool = False) -> TwoWayTransformer:
    return TwoWayTransformer(depth=2, embedding_dim=embed_dim, num_heads=8,
                             mlp_dim=2048, attention_downsample_rate=2,
                             dtype=dtype, shared_keys=shared_keys)


def _build_lam(build_vit=None, use_vit_sam_neck: bool = True,
               use_vit: bool = True, image_embed_dim: int = SAM_EMBED_DIM,
               embed_dim: int = SAM_EMBED_DIM, image_size: int = 1024,
               vit_patch_size: int = 16, class_attention: bool = False,
               example_attention: bool = False,
               example_class_attention: bool = True,
               spatial_convs: Optional[int] = None,
               classification_layer_downsample_rate: int = 8,
               fusion_transformer: str = "TwoWayTransformer",
               class_encoder: Optional[dict] = None,
               custom_preprocess: bool = True,
               dtype: Union[str, torch.dtype] = torch.float32,
               remat_encoder: Union[bool, str, None] = False,
               structured_fusion: bool = True, mask_factor: bool = True,
               shared_keys: bool = False) -> Lam:
    """Architecture factory (reference: build_lam.py:96-235).
    ``remat_encoder`` is the image encoder's ``remat``. The last three
    choose among exact forms of the prompt encoder's fusion (the JAX
    package's environment switches): ``structured_fusion`` and
    ``mask_factor`` are ``PromptImageEncoder``'s, ``shared_keys`` its
    transformer's (``ops/twoway_shared.py`` instead of expanded keys)."""
    if fusion_transformer != "TwoWayTransformer":
        raise NotImplementedError(f"fusion transformer {fusion_transformer!r} "
                                  f"is not ported")
    dtype = norm_dtype(dtype)
    grid = image_size // vit_patch_size

    vit = None
    if use_vit and build_vit is not None:
        # passed on only when set: a custom encoder factory need not know it
        remat = {"remat": remat_encoder} if remat_encoder else {}
        vit = build_vit(project_last_hidden=use_vit_sam_neck,
                        image_size=image_size, dtype=dtype, **remat)

    if class_encoder is not None:
        if class_encoder["name"] != "RandomMatrixEncoder":
            raise NotImplementedError(f"class encoder {class_encoder['name']!r}"
                                      f" is not ported")
        class_encoder_mod = RandomMatrixEncoder(
            class_encoder["bank_size"], class_encoder.get("embed_dim", embed_dim))
    else:
        class_encoder_mod = IdentityClassEncoder()

    neck = (None if image_embed_dim == embed_dim
            else Neck(image_embed_dim, embed_dim, dtype=dtype))
    prompt_encoder = PromptImageEncoder(
        embed_dim=embed_dim, image_embedding_size=(grid, grid),
        input_image_size=(image_size, image_size), mask_in_chans=16,
        transformer=_two_way(embed_dim, dtype, shared_keys),
        class_encoder=class_encoder_mod,
        example_class_attention=example_class_attention,
        class_attention=class_attention, example_attention=example_attention,
        dtype=dtype, structured_fusion=structured_fusion,
        mask_factor=mask_factor)
    mask_decoder = MaskDecoderLam(
        transformer_dim=embed_dim,
        transformer=_two_way(embed_dim, dtype),
        spatial_convs=spatial_convs,
        classification_layer_downsample_rate=classification_layer_downsample_rate,
        dtype=dtype)
    return Lam(prompt_encoder=prompt_encoder, mask_decoder=mask_decoder,
               image_encoder=vit, neck=neck, image_size=image_size,
               custom_preprocess=custom_preprocess)


build_lam = _build_lam


def build_lam_vit_b(**kwargs) -> Lam:
    return _build_lam(build_vit_b, **kwargs)


def build_lam_vit_l(**kwargs) -> Lam:
    return _build_lam(build_vit_l, **kwargs)


def build_lam_vit_h(**kwargs) -> Lam:
    return _build_lam(build_vit_h, **kwargs)


def build_lam_no_vit(**kwargs) -> Lam:
    return _build_lam(build_vit=None, use_vit=False, **kwargs)
