"""Model registry (counterpart of ``labelanything_tpu/models/registry.py``):
the LAM models ported so far."""

from __future__ import annotations

from .build_lam import (build_lam, build_lam_no_vit, build_lam_vit_b,
                        build_lam_vit_h, build_lam_vit_l)

model_registry = {
    "lam": build_lam,
    "lam_no_vit": build_lam_no_vit,
    "lam_h": build_lam_vit_h,
    "lam_l": build_lam_vit_l,
    "lam_b": build_lam_vit_b,
}
