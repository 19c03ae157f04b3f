"""LAM model factory (counterpart of ``labelanything_tpu/models/build_lam.py``;
reference: label_anything/models/build_lam.py:96-300).

Builders return modules whose parameters are fp32 and whose compute dtype is
``dtype``; weights come from :mod:`..utils.weights` (a seeded init or JAX
parameters). Ported: a SAM ViT-B, ViT-L or ViT-H encoder, or none (precomputed
embeddings: ``build_lam_no_vit``); the prompt encoder ``PromptImageEncoder``
or "TokenPool" (``PromptImagePoolEncoder``) with its variants; the
prototype decoder (``few_type`` "Prototype") behind a two-way, one-way or
identity fusion transformer, or the affinity decoder ("Affinity",
"PrototypeAffinity"); ``dropout`` wherever the JAX builder passes it.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .affinity_decoder import AffinityDecoder
from .build_encoder import build_vit_b, build_vit_h, build_vit_l
from .lam import Lam, Neck
from .mask_decoder import MaskDecoderLam
from .prompt_encoder import (IdentityClassEncoder, PromptImageEncoder,
                             PromptImagePoolEncoder, RandomMatrixEncoder)
from .transformer import (AffinityTransformer, IdentityTransformer,
                          OneWayTransformer, TwoWayTransformer)

SAM_EMBED_DIM = 256

# the JAX package's aliases (``labelanything_tpu/models/build_lam.py``)
_DTYPE_ALIASES = {"bf16": "bfloat16", "fp32": "float32", "fp16": "float16",
                  "half": "bfloat16", "float": "float32"}
# the compute dtypes the models' kernels take
MODEL_DTYPES = (torch.float32, torch.bfloat16)


def norm_dtype(dtype: Union[str, torch.dtype, None]) -> Optional[torch.dtype]:
    """The config's dtype strings as the JAX ``norm_dtype`` reads them: the
    aliases "bf16", "half" (bfloat16), "fp32", "float" (float32) and
    "fp16" (float16), else any numpy dtype name, case-insensitive; None
    and dtypes pass through."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = _DTYPE_ALIASES.get(dtype.lower(), dtype.lower())
    if name == "bfloat16":      # not a numpy dtype
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, np.dtype(name))).dtype


def model_dtype(dtype: Union[str, torch.dtype, None]) -> torch.dtype:
    """A model's compute dtype: :func:`norm_dtype`'s, float32 for None (a
    flax module's dtype None computes in its fp32 parameters' type); any
    dtype but float32 and bfloat16 is refused, since the kernels take
    those two only."""
    resolved = norm_dtype(dtype)
    if resolved is None:
        return torch.float32
    if resolved not in MODEL_DTYPES:
        raise ValueError(f"dtype {dtype!r} ({resolved}) has no route in the "
                         f"port: the models compute in float32 or bfloat16")
    return resolved


_FUSION_TRANSFORMERS = {"TwoWayTransformer": TwoWayTransformer,
                        "OneWayTransformer": OneWayTransformer}


def _fusion(name: str, embed_dim: int, dtype: torch.dtype,
            downsample_rate: int = 2, dropout: float = 0.0,
            shared_keys: bool = False) -> torch.nn.Module:
    """The fusion transformer ``name`` at depth 2, 8 heads, MLP 2048;
    "IdentityTransformer" takes no argument (JAX ``build_lam.py:74-84``)."""
    if name == "IdentityTransformer":
        return IdentityTransformer()
    if name not in _FUSION_TRANSFORMERS:
        raise ValueError(f"unknown fusion transformer {name!r}; one of "
                         f"{sorted(_FUSION_TRANSFORMERS)} or "
                         f"'IdentityTransformer'")
    extra = {"shared_keys": shared_keys} if shared_keys else {}
    return _FUSION_TRANSFORMERS[name](
        depth=2, embedding_dim=embed_dim, num_heads=8, mlp_dim=2048,
        attention_downsample_rate=downsample_rate, dtype=dtype,
        dropout=dropout, **extra)


def build_mask_decoder(embed_dim: int, decoder_attention_downsample_rate: int,
                       few_type: str = "Prototype",
                       fusion_transformer: str = "TwoWayTransformer",
                       segment_example_logits: bool = False,
                       spatial_convs: Optional[int] = None,
                       classification_layer_downsample_rate: int = 8,
                       conv_upsample_stride: int = 2,
                       transformer_feature_size: Optional[int] = None,
                       dropout: float = 0.0, class_fusion: str = "sum",
                       classification_levels: int = 1,
                       conv_classification: bool = False,
                       transformer_keys_are_images: bool = True,
                       dtype: torch.dtype = torch.float32):
    """The decoder of ``few_type`` (reference: build_lam.py:238-298). The
    affinity decoder takes no dropout, its transformer does (as in JAX)."""
    if few_type == "Prototype":
        return MaskDecoderLam(
            transformer_dim=embed_dim,
            transformer=_fusion(fusion_transformer, embed_dim, dtype,
                                decoder_attention_downsample_rate, dropout),
            spatial_convs=spatial_convs,
            classification_layer_downsample_rate=(
                classification_layer_downsample_rate),
            dtype=dtype, segment_example_logits=segment_example_logits,
            conv_upsample_stride=conv_upsample_stride,
            classification_levels=classification_levels,
            conv_classification=conv_classification, dropout=dropout)
    if few_type in ("Affinity", "PrototypeAffinity"):
        return AffinityDecoder(
            transformer_dim=embed_dim,
            transformer=AffinityTransformer(
                depth=2, embedding_dim=embed_dim, num_heads=8, mlp_dim=2048,
                attention_downsample_rate=decoder_attention_downsample_rate,
                dtype=dtype, dropout=dropout),
            spatial_convs=spatial_convs,
            classification_layer_downsample_rate=(
                classification_layer_downsample_rate),
            transformer_feature_size=transformer_feature_size,
            class_fusion=class_fusion,
            prototype_merge=few_type == "PrototypeAffinity",
            transformer_keys_are_images=transformer_keys_are_images,
            dtype=dtype)
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
               int8_scores: bool = False,
               class_embedding_dim: Optional[int] = None,
               conv_classification: bool = False,
               use_support_features_in_prompt_encoder: bool = True,
               classification_levels: int = 1,
               prompt_encoder: Optional[str] = None,
               segment_example_logits: bool = False,
               embeddings_per_example: Optional[int] = None,
               embedding_extraction: Optional[str] = None,
               dropout: float = 0.0) -> Lam:
    """Architecture factory (reference: build_lam.py:96-235).
    ``remat_encoder`` is the image encoder's ``remat``. ``structured_fusion``,
    ``mask_factor`` and ``shared_keys`` choose among exact forms of the
    prompt encoder's fusion (the JAX package's environment switches):
    the first two are ``PromptImageEncoder``'s, the last its transformer's
    (``ops/twoway_shared.py`` instead of expanded keys). ``few_type`` and
    the four arguments after it go to :func:`build_mask_decoder`.
    ``fused_window`` and ``int8_scores`` are the image encoder's opt-in
    kernels (``models/image_encoder.py``), off by default. The arguments
    after them are the JAX ``_build_lam``'s, with its defaults; one
    embedding per example implies ``segment_example_logits`` and the
    converse (JAX l.188-191). ``prompt_encoder`` is None or "TokenPool"."""
    if apply_masks:
        raise NotImplementedError(
            "apply_masks=True is not ported: the port's attention takes no "
            "masks, as the reference's masking is a no-op (see "
            "models.common.Attention)")
    dtype = model_dtype(dtype)
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

    if segment_example_logits and embeddings_per_example is None:
        embeddings_per_example = 1
    if embeddings_per_example and not segment_example_logits:
        segment_example_logits = True
    if prompt_encoder not in (None, "TokenPool"):
        raise ValueError(f"unknown prompt_encoder {prompt_encoder!r}; None "
                         f"or 'TokenPool'")
    pe_cls = (PromptImagePoolEncoder if prompt_encoder == "TokenPool"
              else PromptImageEncoder)

    neck = (None if image_embed_dim == embed_dim
            else Neck(image_embed_dim, embed_dim, dtype=dtype))
    prompt_encoder_mod = pe_cls(
        embed_dim=embed_dim, image_embedding_size=(grid, grid),
        input_image_size=(image_size, image_size), mask_in_chans=16,
        transformer=_fusion("TwoWayTransformer", embed_dim, dtype,
                            dropout=dropout, shared_keys=shared_keys),
        class_encoder=class_encoder_mod,
        example_class_attention=example_class_attention,
        class_attention=class_attention, example_attention=example_attention,
        dtype=dtype, structured_fusion=structured_fusion,
        mask_factor=mask_factor, class_embedding_dim=class_embedding_dim,
        use_support_features=use_support_features_in_prompt_encoder,
        embeddings_per_example=embeddings_per_example or 1,
        embedding_extraction=embedding_extraction, dropout=dropout)
    mask_decoder = build_mask_decoder(
        embed_dim, decoder_attention_downsample_rate, few_type=few_type,
        fusion_transformer=fusion_transformer,
        segment_example_logits=segment_example_logits,
        spatial_convs=spatial_convs,
        classification_layer_downsample_rate=(
            classification_layer_downsample_rate),
        transformer_feature_size=transformer_feature_size, dropout=dropout,
        class_fusion=class_fusion,
        classification_levels=classification_levels,
        conv_classification=conv_classification,
        transformer_keys_are_images=transformer_keys_are_images, dtype=dtype)
    return Lam(prompt_encoder=prompt_encoder_mod, mask_decoder=mask_decoder,
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
