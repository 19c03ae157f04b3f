"""How much of ``parameters/`` the port builds, and the dtype strings its
configs may give, on the CPU:

* every grid point's model block of each of the 100 files under
  ``parameters/`` builds through ``api.build_from_config`` (as ``Run``
  builds it) on the meta device; :data:`UNPORTED` names the files the port
  could not build, each with the ROADMAP A13 item that would unlock it
  (none is left), and those would have to fail;
* the models of the 19 files of :data:`VARIANT_FILES` (the LAM variants)
  and of the 5 of :data:`LAST_FILES` (the plain ViTs, the multi-level
  LAM on MiT-b0, the ``is_pyramids`` neck, the similarity baseline) hold
  as many parameters as the JAX package's at every grid point;
* ROADMAP C16: the port's ``norm_dtype`` reads every alias, numpy dtype
  name and None as the JAX ``norm_dtype`` does, and the model builders
  refuse a dtype that no kernel takes (float16) with an error naming it.
"""

import functools
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from labelanything_tpu.models import build_lam as jbuild
from labelanything_tpu.models.registry import model_registry as jregistry
from labelanything_tpu_torch.api import build_from_config
from labelanything_tpu_torch.models import build_lam as tbuild
from labelanything_tpu_torch.utils.config import expand_experiment, load_yaml
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
PARAMETER_FILES = sorted(
    str(p.relative_to(REPO / "parameters"))
    for p in (REPO / "parameters").rglob("*.yaml"))

# the files whose models the port does not build yet, by ROADMAP A13 item
UNPORTED = {}
# the last five files the port learnt to build (A13 items 4 and 6)
LAST_FILES = (
    "trainval/coco20i/mae_noembs.yaml",
    "trainval/other/3_NewTraining_ViT.yaml",
    "trainval/other/COCO_multilevel.yaml",
    "validation/COCO/cosine.yaml",
    "trainval/pascal/PASCAL_256_pyramids.yaml",
)
# the LAM variants: OneWay / Identity fusion, class_embedding_dim and
# PrototypeAffinity, embeddings per example, TokenPool,
# classification_levels, conv_classification, dropout
VARIANT_FILES = (
    "trainval/Ablations/mae_transformer.yaml",
    "validation/Ablations/transformer_spatial.yaml",
    "trainval/other/COCO_complete_256_oneway.yaml",
    "trainval/other/COCO_mae_oneway256.yaml",
    "trainval/other/Pascal/PASCAL_identity.yaml",
    "trainval/other/Affinity/4.3_AFClass_SAM.yaml",
    "trainval/other/Affinity/4.3.1_AFClass_MAE.yaml",
    "trainval/other/Affinity/4.3.2_AFClass_MAE_noconvs.yaml",
    "trainval/other/Affinity/4.4_AffinityPrototype.yaml",
    "trainval/pascal/mae_chooser.yaml",
    "trainval/pascal/mae_multiemb.yaml",
    "validation/Pascal/mae_multiemb.yaml",
    "validation/Pascal/mae_cross.yaml",
    "trainval/coco20i/mae_pool.yaml",
    "trainval/pascal/mae_pool.yaml",
    "trainval/pascal/mae_levels.yaml",
    "validation/Pascal/mae_levels.yaml",
    "trainval/pascal/mae_nodown.yaml",
    "trainval/other/Pascal/PASCAL_dropout.yaml",
)


def test_the_hundred_files():
    assert len(PARAMETER_FILES) == 100
    assert not UNPORTED
    assert len(set(VARIANT_FILES)) == 19 and len(set(LAST_FILES)) == 5
    assert set(VARIANT_FILES) | set(LAST_FILES) <= set(PARAMETER_FILES)


def _blocks(path: str) -> dict:
    """The distinct model blocks of the file's grid."""
    return {repr(sorted(flat["model"].items())): dict(flat["model"])
            for flat in expand_experiment(
                load_yaml(str(REPO / "parameters" / path)))}


def _build_all(path: str) -> int:
    """Build every distinct model block of the file's grid; their count.
    Every model holds parameters but the similarity baseline, which has
    none."""
    blocks = _blocks(path)
    for block in blocks.values():
        with torch.device("meta"):
            model = build_from_config(block)
        assert (sum(p.numel() for p in model.parameters()) > 0
                or block["name"] == "similarity")
    return len(blocks)


@pytest.mark.parametrize("path", PARAMETER_FILES)
def test_every_grid_point_builds(path):
    if path in UNPORTED:
        with pytest.raises((NotImplementedError, TypeError, ValueError)):
            _build_all(path)
    else:
        assert _build_all(path) >= 1


@functools.lru_cache(maxsize=None)
def _jax_count(block_json: str) -> int:
    """Parameters of the JAX model of a model block (as JSON, without its
    name and checkpoint), from the shapes of its
    ``init`` on an episode with every prompt modality (flax creates a
    module's parameters when it is first called). A
    ``transformer_feature_size`` other than the grid is left out: the JAX
    package cannot trace it (ROADMAP C3), and it holds no parameter."""
    args = json.loads(block_json)
    grid = args.get("image_size", 1024) // 16
    if args.get("transformer_feature_size") not in (None, grid):
        del args["transformer_feature_size"]
    model = jbuild.build_lam_no_vit(**args)
    b, m, c, s, n = 1, 1, 2, args.get("image_size", 1024), 2
    f32 = jnp.float32
    batch = {
        "embeddings": jax.ShapeDtypeStruct(
            (b, m + 1, grid, grid, args.get("image_embed_dim", 256)), f32),
        "prompt_masks": jax.ShapeDtypeStruct((b, m, c, s // 4, s // 4), f32),
        "flag_masks": jax.ShapeDtypeStruct((b, m, c), jnp.int32),
        "prompt_points": jax.ShapeDtypeStruct((b, m, c, n, 2), f32),
        "flag_points": jax.ShapeDtypeStruct((b, m, c, n), jnp.int32),
        "prompt_bboxes": jax.ShapeDtypeStruct((b, m, c, n, 4), f32),
        "flag_bboxes": jax.ShapeDtypeStruct((b, m, c, n), jnp.int32),
        "flag_examples": jax.ShapeDtypeStruct((b, m, c), jnp.int32),
        "dims": jax.ShapeDtypeStruct((b, m + 1, 2), jnp.int32)}
    shapes = jax.eval_shape(model.init, jax.random.key(0), batch)
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))


@pytest.mark.parametrize("path", VARIANT_FILES)
def test_variant_parameter_counts_match_jax(path):
    for block in _blocks(path).values():
        assert block["name"] == "lam_no_vit"
        with torch.device("meta"):
            model = build_from_config(block)
        ours = sum(p.numel() for p in model.parameters())
        # the positional encoding's Gaussian matrix is a parameter in JAX
        # and a buffer in the port, as in the reference
        ours += model.prompt_encoder.pe_layer.\
            positional_encoding_gaussian_matrix.numel()
        args = {k: v for k, v in block.items()
                if k not in ("name", "checkpoint")}
        assert ours == _jax_count(json.dumps(args, sort_keys=True)), block


def _jax_count_any(block: dict) -> int:
    """Parameters of the JAX model of any model block, from the shapes of
    its ``init`` on an episode with mask prompts whose input the block
    reads: images at ``image_size`` for an encoder, a stage-dict cache of
    ResNet-50's stages 2 to 4 for ``is_pyramids``, 768-wide embeddings
    on the grid otherwise (the similarity baseline)."""
    args = {k: v for k, v in block.items() if k not in ("name",
                                                        "checkpoint")}
    model = jregistry[block["name"]](**args)
    b, m, c, s = 1, 1, 2, args.get("image_size", 1024)
    f32 = jnp.float32
    batch = {
        "prompt_masks": jax.ShapeDtypeStruct((b, m, c, s // 4, s // 4), f32),
        "flag_masks": jax.ShapeDtypeStruct((b, m, c), jnp.int32),
        "flag_examples": jax.ShapeDtypeStruct((b, m, c), jnp.int32),
        "dims": jax.ShapeDtypeStruct((b, m + 1, 2), jnp.int32)}
    if args.get("is_pyramids"):
        g = s // args.get("vit_patch_size", 16)
        batch["embeddings"] = {
            f"stage{i + 2}": jax.ShapeDtypeStruct(
                (b, m + 1, g >> i, g >> i, ch), f32)
            for i, ch in enumerate(args["intermediate_channel_sizes"])}
    elif block["name"] in ("lam_no_vit", "similarity"):
        g = s // 16
        batch["embeddings"] = jax.ShapeDtypeStruct(
            (b, m + 1, g, g, args.get("image_embed_dim", 768)), f32)
    else:
        batch["images"] = jax.ShapeDtypeStruct((b, m + 1, s, s, 3), f32)
    shapes = jax.eval_shape(model.init, jax.random.key(0), batch)
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))


@pytest.mark.parametrize("path", LAST_FILES)
def test_last_files_parameter_counts_match_jax(path):
    for block in _blocks(path).values():
        with torch.device("meta"):
            model = build_from_config(block)
        ours = sum(p.numel() for p in model.parameters())
        # the positional encodings' Gaussian matrices are parameters in
        # JAX and buffers in the port, as in the reference
        ours += sum(b.numel() for n, b in model.named_buffers()
                    if n.endswith("positional_encoding_gaussian_matrix"))
        assert ours == _jax_count_any(block), block
        if block["name"] == "similarity":
            assert ours == 0


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
