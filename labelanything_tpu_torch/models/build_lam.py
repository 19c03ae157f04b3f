"""LAM model factory (counterpart of ``labelanything_tpu/models/build_lam.py``;
reference: label_anything/models/build_lam.py:96-300).

Builders return modules whose parameters are fp32 and whose compute dtype is
``dtype``; weights come from :mod:`..utils.weights` (a seeded init or JAX
parameters). Ported: a SAM ViT-B, ViT-L or ViT-H encoder, or none (precomputed
embeddings: ``build_lam_no_vit``), with the two-way fusion transformer and
the prototype decoder (``few_type`` "Prototype") or the affinity decoder
("Affinity").
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .affinity_decoder import AffinityDecoder
from .build_encoder import build_vit_b, build_vit_h, build_vit_l
from .lam import Lam, Neck
from .mask_decoder import MaskDecoderLam
from .prompt_encoder import (IdentityClassEncoder, PromptImageEncoder,
                             RandomMatrixEncoder)
from .transformer import AffinityTransformer, TwoWayTransformer

SAM_EMBED_DIM = 256

_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "fp32": torch.float32, "float32": torch.float32}


def norm_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """Accept the config's dtype strings ("bf16", "float32", ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[dtype.lower()]


def _two_way(embed_dim: int, dtype: torch.dtype, shared_keys: bool = False,
             downsample_rate: int = 2) -> TwoWayTransformer:
    return TwoWayTransformer(depth=2, embedding_dim=embed_dim, num_heads=8,
                             mlp_dim=2048,
                             attention_downsample_rate=downsample_rate,
                             dtype=dtype, shared_keys=shared_keys)


def build_mask_decoder(embed_dim: int, decoder_attention_downsample_rate: int,
                       few_type: str = "Prototype",
                       spatial_convs: Optional[int] = None,
                       classification_layer_downsample_rate: int = 8,
                       transformer_feature_size: Optional[int] = None,
                       class_fusion: str = "sum",
                       transformer_keys_are_images: bool = True,
                       dtype: torch.dtype = torch.float32):
    """The decoder of ``few_type`` (reference: build_lam.py:238-298)."""
    if few_type == "Prototype":
        return MaskDecoderLam(
            transformer_dim=embed_dim,
            transformer=_two_way(
                embed_dim, dtype,
                downsample_rate=decoder_attention_downsample_rate),
            spatial_convs=spatial_convs,
            classification_layer_downsample_rate=(
                classification_layer_downsample_rate),
            dtype=dtype)
    if few_type == "Affinity":
        return AffinityDecoder(
            transformer_dim=embed_dim,
            transformer=AffinityTransformer(
                depth=2, embedding_dim=embed_dim, num_heads=8, mlp_dim=2048,
                attention_downsample_rate=decoder_attention_downsample_rate,
                dtype=dtype),
            spatial_convs=spatial_convs,
            classification_layer_downsample_rate=(
                classification_layer_downsample_rate),
            transformer_feature_size=transformer_feature_size,
            class_fusion=class_fusion,
            transformer_keys_are_images=transformer_keys_are_images,
            dtype=dtype)
    if few_type == "PrototypeAffinity":
        raise NotImplementedError("few_type 'PrototypeAffinity' (the "
                                  "affinity decoder's prototype_merge) is not "
                                  "ported (ROADMAP A13)")
    raise NotImplementedError(f"few_type {few_type!r} not implemented")


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
               shared_keys: bool = False, few_type: str = "Prototype",
               decoder_attention_downsample_rate: int = 2,
               class_fusion: str = "sum",
               transformer_keys_are_images: bool = True,
               transformer_feature_size: Optional[int] = None,
               apply_masks: bool = False, fused_window: bool = False,
               int8_scores: bool = False) -> Lam:
    """Architecture factory (reference: build_lam.py:96-235).
    ``remat_encoder`` is the image encoder's ``remat``. ``structured_fusion``,
    ``mask_factor`` and ``shared_keys`` choose among exact forms of the
    prompt encoder's fusion (the JAX package's environment switches):
    the first two are ``PromptImageEncoder``'s, the last its transformer's
    (``ops/twoway_shared.py`` instead of expanded keys). ``few_type`` and
    the four arguments after it go to :func:`build_mask_decoder`.
    ``fused_window`` and ``int8_scores`` are the image encoder's opt-in
    kernels (``models/image_encoder.py``), off by default."""
    if fusion_transformer != "TwoWayTransformer":
        raise NotImplementedError(f"fusion transformer {fusion_transformer!r} "
                                  f"is not ported")
    if apply_masks:
        raise NotImplementedError(
            "apply_masks=True is not ported: the port's attention takes no "
            "masks, as the reference's masking is a no-op (see "
            "models.common.Attention)")
    dtype = norm_dtype(dtype)
    grid = image_size // vit_patch_size

    vit = None
    if use_vit and build_vit is not None:
        # passed on only when set: a custom encoder factory need not know
        # them
        options = dict(remat=remat_encoder, fused_window=fused_window,
                       int8_scores=int8_scores)
        vit = build_vit(project_last_hidden=use_vit_sam_neck,
                        image_size=image_size, dtype=dtype,
                        **{k: v for k, v in options.items() if v})

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
    mask_decoder = build_mask_decoder(
        embed_dim, decoder_attention_downsample_rate, few_type=few_type,
        spatial_convs=spatial_convs,
        classification_layer_downsample_rate=(
            classification_layer_downsample_rate),
        transformer_feature_size=transformer_feature_size,
        class_fusion=class_fusion,
        transformer_keys_are_images=transformer_keys_are_images, dtype=dtype)
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
