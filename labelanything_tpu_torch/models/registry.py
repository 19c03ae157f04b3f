"""Model registry (counterpart of ``labelanything_tpu/models/registry.py``):
the LAM models, the baselines ported so far and, as in the JAX registry,
the image encoders of ``build_encoder.ENCODERS``."""

from __future__ import annotations

from .bam import build_bam
from .build_encoder import ENCODERS
from .build_lam import (build_lam, build_lam_dino_b8, build_lam_no_vit,
                        build_lam_vit_b, build_lam_vit_b_imagenet_i21k,
                        build_lam_vit_h, build_lam_vit_l, build_lam_vit_mae_b,
                        build_multilevel_lam)
from .dcama import build_dcama
from .denet import build_denet
from .fptrans import build_fptrans
from .hdmnet import build_hdmnet
from .panet import build_panet
from .ppnet import build_ppnet
from .similarity import build_similarity

model_registry = {
    "lam": build_lam,
    "lam_no_vit": build_lam_no_vit,
    "lam_h": build_lam_vit_h,
    "lam_l": build_lam_vit_l,
    "lam_b": build_lam_vit_b,
    "lam_mae_b": build_lam_vit_mae_b,
    "lam_dino_b8": build_lam_dino_b8,
    "lam_b_imagenet_i21k": build_lam_vit_b_imagenet_i21k,
    "multilevel_lam": build_multilevel_lam,
    "similarity": build_similarity,
    "panet": build_panet,
    "ppnet": build_ppnet,
    "denet": build_denet,
    "bam": build_bam,
    "hdmnet": build_hdmnet,
    "dcama": build_dcama,
    "fptrans": build_fptrans,
    **ENCODERS,
}
