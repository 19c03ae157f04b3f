"""How much of ``parameters/`` the port builds, and the dtype strings its
configs may give, on the CPU:

* every grid point's model block of each of the 100 files under
  ``parameters/`` builds through ``api.build_from_config`` (as ``Run``
  builds it) on the meta device, except in the files of :data:`UNPORTED`,
  each named with the ROADMAP A13 item that will unlock it; those must
  still fail, so that a slice that ports one takes it off the list;
* ROADMAP C16: the port's ``norm_dtype`` reads every alias, numpy dtype
  name and None as the JAX ``norm_dtype`` does, and the model builders
  refuse a dtype that no kernel takes (float16) with an error naming it.
"""

import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from labelanything_tpu.models import build_lam as jbuild
from labelanything_tpu_torch.api import build_from_config
from labelanything_tpu_torch.models import build_lam as tbuild
from labelanything_tpu_torch.utils.config import expand_experiment, load_yaml
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
PARAMETER_FILES = sorted(
    str(p.relative_to(REPO / "parameters"))
    for p in (REPO / "parameters").rglob("*.yaml"))

# the files whose models the port does not build yet, by ROADMAP A13 item
_ONEWAY = "A13.1: OneWay / Identity fusion transformers"
_CLASS_DIM = "A13.2: class_embedding_dim"
_PER_EXAMPLE = "A13.3: embeddings per example"
_VITS = "A13.4: the plain ViTs of models/vit.py"
UNPORTED = {
    "trainval/Ablations/mae_transformer.yaml": _ONEWAY,
    "validation/Ablations/transformer_spatial.yaml": _ONEWAY,
    "trainval/other/COCO_complete_256_oneway.yaml": _ONEWAY,
    "trainval/other/COCO_mae_oneway256.yaml": _ONEWAY,
    "trainval/other/Pascal/PASCAL_identity.yaml": _ONEWAY,
    "trainval/other/Affinity/4.3_AFClass_SAM.yaml": _CLASS_DIM,
    "trainval/other/Affinity/4.3.1_AFClass_MAE.yaml": _CLASS_DIM,
    "trainval/other/Affinity/4.3.2_AFClass_MAE_noconvs.yaml": _CLASS_DIM,
    "trainval/other/Affinity/4.4_AffinityPrototype.yaml": _CLASS_DIM,
    "trainval/pascal/mae_chooser.yaml": _PER_EXAMPLE,
    "trainval/pascal/mae_multiemb.yaml": _PER_EXAMPLE,
    "validation/Pascal/mae_multiemb.yaml": _PER_EXAMPLE,
    "validation/Pascal/mae_cross.yaml": _PER_EXAMPLE,
    "trainval/coco20i/mae_noembs.yaml": _VITS,
    "trainval/other/3_NewTraining_ViT.yaml": _VITS,
    "trainval/coco20i/mae_pool.yaml": "A13.5: the TokenPool prompt encoder",
    "trainval/pascal/mae_pool.yaml": "A13.5: the TokenPool prompt encoder",
    "trainval/pascal/mae_levels.yaml": "A13.5: classification_levels",
    "validation/Pascal/mae_levels.yaml": "A13.5: classification_levels",
    "trainval/pascal/mae_nodown.yaml": "A13.6: conv_classification",
    "trainval/other/Pascal/PASCAL_dropout.yaml": "A13.6: dropout",
    "trainval/other/COCO_multilevel.yaml": "A13.6: multilevel_lam",
    "validation/COCO/cosine.yaml": "A13.6: similarity",
    "trainval/pascal/PASCAL_256_pyramids.yaml": "A13.6: pyramids",
}


def test_the_hundred_files():
    assert len(PARAMETER_FILES) == 100
    assert set(UNPORTED) <= set(PARAMETER_FILES)
    assert len(UNPORTED) == 24


def _build_all(path: str) -> int:
    """Build every distinct model block of the file's grid; their count."""
    blocks = {repr(sorted(flat["model"].items())): dict(flat["model"])
              for flat in expand_experiment(
                  load_yaml(str(REPO / "parameters" / path)))}
    for block in blocks.values():
        with torch.device("meta"):
            model = build_from_config(block)
        assert sum(p.numel() for p in model.parameters()) > 0
    return len(blocks)


@pytest.mark.parametrize("path", PARAMETER_FILES)
def test_every_grid_point_builds(path):
    if path in UNPORTED:
        with pytest.raises((NotImplementedError, TypeError, ValueError)):
            _build_all(path)
    else:
        assert _build_all(path) >= 1


# ---- C16 ------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", [
    "bf16", "bfloat16", "fp32", "float32", "fp16", "float16", "half",
    "float", "FP32", "Float16", "float64", "int8", "uint8", "int32", None])
def test_norm_dtype_matches_jax(dtype):
    ours = tbuild.norm_dtype(dtype)
    ref = jbuild.norm_dtype(dtype)
    if dtype is None:
        assert ours is None and ref is None
        return
    assert ours == getattr(torch, jnp.dtype(ref).name)


def test_models_refuse_a_dtype_no_kernel_takes():
    assert tbuild.model_dtype(None) is torch.float32
    assert tbuild.model_dtype("half") is torch.bfloat16
    assert tbuild.model_dtype(torch.float32) is torch.float32
    for dtype in ("fp16", "float16", "float64"):
        with pytest.raises(ValueError, match=dtype):
            with torch.device("meta"):
                tbuild.build_lam_no_vit(image_embed_dim=32, embed_dim=32,
                                        image_size=64, dtype=dtype)
    with torch.device("meta"):
        model = tbuild.build_lam_no_vit(image_embed_dim=32, embed_dim=32,
                                        image_size=64, dtype="float")
    assert np.all([p.dtype == torch.float32 for p in model.parameters()])
