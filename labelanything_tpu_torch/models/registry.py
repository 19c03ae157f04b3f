"""Model registry (counterpart of ``labelanything_tpu/models/registry.py``):
the LAM models and the baselines ported so far."""

from __future__ import annotations

from .bam import build_bam
from .build_lam import (build_lam, build_lam_no_vit, build_lam_vit_b,
                        build_lam_vit_h, build_lam_vit_l)
from .dcama import build_dcama
from .denet import build_denet
from .fptrans import build_fptrans
from .hdmnet import build_hdmnet
from .panet import build_panet
from .ppnet import build_ppnet

model_registry = {
    "lam": build_lam,
    "lam_no_vit": build_lam_no_vit,
    "lam_h": build_lam_vit_h,
    "lam_l": build_lam_vit_l,
    "lam_b": build_lam_vit_b,
    "panet": build_panet,
    "ppnet": build_ppnet,
    "denet": build_denet,
    "bam": build_bam,
    "hdmnet": build_hdmnet,
    "dcama": build_dcama,
    "fptrans": build_fptrans,
}
