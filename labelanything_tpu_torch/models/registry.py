"""Model registry (counterpart of ``labelanything_tpu/models/registry.py``):
the LAM builders ported so far."""

from __future__ import annotations

from .build_lam import build_lam_no_vit, build_lam_vit_b

model_registry = {
    "lam_no_vit": build_lam_no_vit,
    "lam_b": build_lam_vit_b,
}
