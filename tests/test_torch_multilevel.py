"""The feature-pyramid models of the port against the JAX package on the
CPU, at toy width:

* SegFormer's MiT (``models/segformer.py``) against the JAX module (and
  against Hugging Face's ``SegformerModel`` in ``test_torch_vit_plain.py``,
  which imports ``transformers`` once for both encoders);
* the pyramid backbones' stages (ResNet-50 with torchvision's strides,
  Swin) against the JAX ones, BatchNorm statistics included;
* ``PyramidLamNeck`` and an ``is_pyramids`` LAM on stage-dict caches
  against JAX, and the substitution's reorder of every stage;
* ``MultiLevelLam`` on stage-dict embeddings against JAX, and on images
  through MiT-b0 (at toy width, four levels at its strides) against JAX
  and against the port's own embeddings path;
* the similarity baseline with ``compare_size`` and ``custom_preprocess``
  against JAX, its row-blocked maxima equal to the unblocked ones, and
  ROADMAP C22 (``validation/COCO/cosine.yaml`` names no encoder and no
  cache, so its image batches raise in both packages);
* ``freeze_backbone`` picking MiT-b0's parameters as JAX's mask does.

Weights: seeded values of the JAX trees (``jax_params``), carried by
``utils.weights.state_dict_from_jax``. fp32 tolerance rtol 1e-3, atol 5e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from labelanything_tpu.data.synthetic import random_batch, random_full_batch
from labelanything_tpu.models import pyramid_encoders as jpe
from labelanything_tpu.models import pyramids as jpy
from labelanything_tpu.models import segformer as jseg
from labelanything_tpu.models import similarity as jsim
from labelanything_tpu.models.registry import model_registry as jregistry
from labelanything_tpu.train import optim as jo
from labelanything_tpu.train import substitutor as jsub
from labelanything_tpu.typing import BatchKeys, ResultDict
from labelanything_tpu_torch.models import pyramid_encoders as tpe
from labelanything_tpu_torch.models import pyramids as tpy
from labelanything_tpu_torch.models import segformer as tseg
from labelanything_tpu_torch.models import similarity as tsim
from labelanything_tpu_torch.models.registry import model_registry
from labelanything_tpu_torch.parallel.train_step import (init_train_state,
                                                         make_train_step)
from labelanything_tpu_torch.train import losses as tl
from labelanything_tpu_torch.train import substitutor as tsub
from labelanything_tpu_torch.utils.config import expand_experiment, load_yaml
from labelanything_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_baselines import seeded_variables
from tests.test_torch_lam_variants import (RME, TOL, compare_flagged,
                                           jax_params, jax_run, load)
from tests.torch_threads import one_torch_thread  # noqa: F401

IMG = 64
MIT_TOY = dict(embed_dims=(8, 16, 24, 32), depths=(1, 1, 2, 1),
               num_heads=(1, 2, 3, 4), sr_ratios=(8, 4, 2, 1))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(batch):
    return {k: ({s: torch.from_numpy(np.array(a)) for s, a in v.items()}
                if isinstance(v, dict) else torch.from_numpy(np.array(v)))
            for k, v in batch.items()}


def _stages_close(got: dict, want: dict, **tol):
    assert sorted(got) == sorted(want)
    for stage, value in want.items():
        np.testing.assert_allclose(got[stage].detach().numpy(),
                                   np.asarray(value), **(tol or TOL),
                                   err_msg=stage)


# ---- MiT ------------------------------------------------------------------- #

def test_mit_matches_jax():
    x = _x((2, IMG, IMG, 3), seed=8)
    jm = jseg.MixVisionTransformer(**MIT_TOY)
    params = jax_params(jm, x)
    want = jax_run(jm.apply, params, x)
    tm = load(tseg.MixVisionTransformer(**MIT_TOY), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _stages_close(got, want)
    assert got["stage1"].shape == (2, IMG // 4, IMG // 4, 8)


# ---- the pyramid backbones ------------------------------------------------ #

def test_resnet50_backbone_matches_jax():
    x = _x((2, IMG, IMG, 3), seed=30)
    jm = jpe.ResNet50Backbone(layers=(1, 1, 1, 1))
    shapes = jax.eval_shape(jm.init, jax.random.key(0), x)
    variables = seeded_variables(shapes, 3)
    want = jax_run(jm.apply, variables, x)
    tm = load(tpe.ResNet50Backbone(layers=(1, 1, 1, 1)), variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _stages_close(got, want)
    assert got["stage4"].shape == (2, IMG // 32, IMG // 32, 2048)


def test_swin_backbone_matches_jax():
    cfg = dict(img_size=IMG, embed_dim=16, depths=(1, 1, 2, 1),
               num_heads=(1, 2, 2, 4), window_size=4)
    x = _x((2, IMG, IMG, 3), seed=31)
    jm = jpe.SwinBackbone(**cfg)
    params = jax_params(jm, x)
    want = jax_run(jm.apply, params, x)
    tm = load(tpe.SwinBackbone(**cfg), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _stages_close(got, want)
    assert got["stage3"].shape == (2, IMG // 16, IMG // 16, 64)


# ---- the is_pyramids neck and LAM ----------------------------------------- #

SIZES = (8, 16, 32)


def _pyramid(b, n, seed=0):
    """A stage-dict cache of a 64-px image at ResNet's strides 8, 16, 32."""
    rng = np.random.default_rng(seed)
    return {f"stage{i + 2}": rng.standard_normal(
        (b, n, IMG // 8 >> i, IMG // 8 >> i, c)).astype(np.float32)
        for i, c in enumerate(SIZES)}


def test_pyramid_neck_matches_jax():
    pyramid = {k: v[:, 0] for k, v in _pyramid(2, 1).items()}
    jm = jpy.PyramidLamNeck(intermediate_channel_sizes=SIZES, d_model=32)
    params = jax_params(jm, pyramid)
    want = jax_run(jm.apply, params, pyramid)
    tm = tpy.PyramidLamNeck(SIZES, d_model=32).eval()
    # the renames of the neck take it where a LAM holds it
    tm.load_state_dict({k[len("neck."):]: v for k, v in state_dict_from_jax(
        {"neck": params["params"]}).items()}, strict=True)
    with torch.no_grad():
        got = tm({k: torch.from_numpy(v) for k, v in pyramid.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the sine table on its own, to float rounding
    pe = tpy.pyramid_sine_position_embedding((5, 7), 32)
    np.testing.assert_allclose(
        pe.numpy(), np.asarray(jpy.pyramid_sine_position_embedding((5, 7), 32)),
        rtol=1e-6, atol=1e-6)


PYRAMID_LAM = dict(image_embed_dim=768, embed_dim=32, image_size=IMG,
                   vit_patch_size=8, spatial_convs=3, class_attention=False,
                   example_class_attention=False, example_attention=True,
                   is_pyramids=True, intermediate_channel_sizes=list(SIZES),
                   class_encoder=RME)


def test_is_pyramids_lam_matches_jax():
    """``PASCAL_256_pyramids.yaml``'s block at toy width on stage-dict
    caches, the forward and then a substitution pass: the reorder of every
    stage equal to JAX's, and one train step of the port on it."""
    batch = random_batch(batch_size=2, num_examples=2, num_classes=3,
                         image_size=IMG, seed=4, include_points=False,
                         include_boxes=False)
    batch[BatchKeys.EMBEDDINGS] = _pyramid(2, 3, seed=5)
    jm = jregistry["lam_no_vit"](**PYRAMID_LAM)
    params = jax_params(jm, batch)
    want = np.asarray(jax_run(jm.apply, params, batch)[ResultDict.LOGITS])
    tm = load(model_registry["lam_no_vit"](**PYRAMID_LAM), params)
    with torch.no_grad():
        got = tm(_t(batch))[ResultDict.LOGITS].numpy()
    compare_flagged(got, want, batch)

    perm = jsub.rotation_permutation(2, 3)
    stages = {BatchKeys.EMBEDDINGS: batch[BatchKeys.EMBEDDINGS]}
    ref = jsub.apply_permutation(stages, perm)[BatchKeys.EMBEDDINGS]
    ours = tsub.apply_permutation(_t(stages), perm)[BatchKeys.EMBEDDINGS]
    for stage, value in ref.items():
        np.testing.assert_array_equal(ours[stage].numpy(), np.asarray(value))

    # a training batch (prompts and ground truths of the query too, the pad
    # band ignored), every class flagged
    full = random_full_batch(batch_size=2, num_examples=2, num_classes=3,
                             image_size=IMG, seed=6, include_points=False,
                             include_boxes=False)
    full[BatchKeys.EMBEDDINGS] = batch[BatchKeys.EMBEDDINGS]
    for key in (BatchKeys.FLAG_MASKS, BatchKeys.FLAG_EXAMPLES):
        full[key] = np.ones_like(full[key])
    sub = tsub.Substitutor(substitute=True)
    sub.reset(_t(full))
    assert sub.num_examples == 3
    passes = list(sub)
    assert len(passes) == 4
    state = init_train_state(tm, tl.LabelAnythingLoss({"focal":
                                                       {"weight": 1.0}}),
                             "cpu", learning_rate=1e-3)
    neck = tm.neck[0].final_conv.weight.detach().clone()
    state, aux = make_train_step()(state, *passes[1], None)
    assert torch.isfinite(aux["loss"]) and state.step == 1
    assert not torch.equal(tm.neck[0].final_conv.weight, neck)


# ---- MultiLevelLam ---------------------------------------------------------- #

MULTILEVEL = dict(embed_dims=(16, 32), vit_patch_sizes=(8, 16),
                  image_size=IMG, example_attention=True,
                  example_class_attention=False, class_encoder=RME)


def test_multilevel_lam_matches_jax():
    batch = random_batch(batch_size=2, num_examples=2, num_classes=3,
                         image_size=IMG, seed=7, include_points=False,
                         include_boxes=False)
    rng = np.random.default_rng(8)
    batch[BatchKeys.EMBEDDINGS] = {
        "stage3": rng.standard_normal((2, 3, 4, 4, 32)).astype(np.float32),
        "stage2": rng.standard_normal((2, 3, 8, 8, 16)).astype(np.float32)}
    jm = jregistry["multilevel_lam"](**MULTILEVEL)
    params = jax_params(jm, batch)
    out = jax_run(jm.apply, params, batch)
    tm = load(model_registry["multilevel_lam"](**MULTILEVEL), params)
    with torch.no_grad():
        result = tm(_t(batch))
    compare_flagged(result[ResultDict.LOGITS].numpy(),
                    np.asarray(out[ResultDict.LOGITS]), batch)
    np.testing.assert_allclose(
        result[ResultDict.EXAMPLES_CLASS_EMBS].numpy(),
        np.asarray(out[ResultDict.EXAMPLES_CLASS_EMBS]), **TOL)


# MiT-b0's layout at toy width: widths a multiple of 16, so that every
# level's two-way transformers (8 heads at half width) can take them
MIT_LEVELS = dict(embed_dims=(16, 16, 32, 32), depths=(1, 1, 1, 1),
                  num_heads=(1, 2, 2, 4), sr_ratios=(8, 4, 2, 1))


@pytest.fixture
def toy_mit(monkeypatch):
    """Both packages' ``mit_b0`` builders at :data:`MIT_LEVELS`, and the
    stage widths that size the levels to match."""
    dims = {f"stage{i + 1}": d for i, d in enumerate(MIT_LEVELS["embed_dims"])}
    for seg in (jseg, tseg):
        build = seg.build_mit_b0
        monkeypatch.setattr(seg, "build_mit_b0", lambda build=build, **kw:
                            build(**{**kw, **MIT_LEVELS}))
        monkeypatch.setattr(seg, "MIT_B0_STAGE_DIMS", dims)


def test_multilevel_images_path_matches_jax(toy_mit):
    """``COCO_multilevel.yaml``'s path: with ``encoder: mit_b0`` both
    packages take images through MiT (as they come, unnormalized) to four
    levels at MiT's strides, sorted by stage, against JAX; the port's
    images path also gives exactly its embeddings path's logits, and
    ``apply_masks`` is refused as the single-level builder refuses it."""
    block = dict(image_size=IMG, encoder="mit_b0", class_encoder=RME,
                 example_attention=True)
    batch = random_batch(batch_size=1, num_examples=2, num_classes=2,
                         image_size=IMG, with_images=True, seed=2,
                         include_points=False, include_boxes=False)
    jm = jregistry["multilevel_lam"](**block)
    params = jax_params(jm, batch)
    want = np.asarray(jax_run(jm.apply, params, batch)[ResultDict.LOGITS])
    model = load(model_registry["multilevel_lam"](**block), params)
    assert [enc.image_embedding_size for enc in
            model.prompt_encoder.prompt_encoders] == [(16, 16), (8, 8),
                                                      (4, 4), (2, 2)]
    tbatch = _t(batch)
    with torch.no_grad():
        got = model(tbatch)[ResultDict.LOGITS]
        images = tbatch.pop(BatchKeys.IMAGES)
        stages = model.image_encoder(images.reshape((-1,) + images.shape[2:]))
        tbatch[BatchKeys.EMBEDDINGS] = {k: v.reshape((1, 3) + v.shape[1:])
                                        for k, v in stages.items()}
        again = model(tbatch)[ResultDict.LOGITS]
    compare_flagged(got.numpy(), want, batch)
    torch.testing.assert_close(got, again, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="apply_masks"):
        model_registry["multilevel_lam"](**block, apply_masks=True)


def test_freeze_backbone_picks_mit():
    """COCO_multilevel.yaml's block (MiT-b0): JAX's optimizer mask, on a
    tree of MiT-b0's parameters under ``image_encoder`` beside a decoder's,
    picks as many as the port freezes, all of its MiT-b0."""
    flat = expand_experiment(load_yaml(
        "parameters/trainval/other/COCO_multilevel.yaml"))[0]
    block = {k: v for k, v in flat["model"].items() if k != "name"}
    mit = jax.eval_shape(jseg.build_mit_b0().init, jax.random.key(0),
                         jnp.zeros((1, IMG, IMG, 3)))
    tree = {"model": {"params": {"image_encoder": mit["params"],
                                 "mask_decoder": {"w": jnp.zeros(3)}}}}
    picked = sum(int(np.prod(leaf.shape)) for leaf, b in zip(
        jax.tree.leaves(tree), jax.tree.leaves(jo.backbone_mask(tree))) if b)
    with torch.device("meta"):
        model = model_registry["multilevel_lam"](**block)
    state = init_train_state(model, tl.LabelAnythingLoss(
        {"focal": {"weight": 1.0}}), "meta", freeze_backbone=True)
    frozen = sum(p.numel() for p in state.model.parameters()
                 if not p.requires_grad)
    assert frozen == picked == sum(
        p.numel() for p in model.image_encoder.parameters()) > 3e6


# ---- the similarity baseline ------------------------------------------------ #

def _similarity_batch(seed=0, m=3, c=3):
    rng = np.random.default_rng(seed)
    batch = {
        BatchKeys.EMBEDDINGS: rng.standard_normal((2, m, 6, 6, 8)).astype(
            np.float32),
        BatchKeys.PROMPT_MASKS: (rng.random((2, m - 1, c, 16, 16)) < 0.3
                                 ).astype(np.float32),
        BatchKeys.DIMS: np.array([[[40, 30]] * m, [[25, 40]] * m], np.int32)}
    return batch


@pytest.mark.parametrize("options", [
    dict(image_size=40, compare_size=10, custom_preprocess=True),
    dict(image_size=40, compare_size=None, custom_preprocess=False)])
def test_similarity_matches_jax(options):
    batch = _similarity_batch()
    jm = jsim.build_similarity(**options)
    want = np.asarray(jax_run(jm.apply, {}, batch)[ResultDict.LOGITS])
    got = tsim.build_similarity(**options)(_t(batch))[ResultDict.LOGITS]
    assert got.shape == want.shape == (2, 3, 40, 40)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got.numpy()), finite)
    np.testing.assert_allclose(got.numpy()[finite], want[finite], rtol=1e-5,
                               atol=1e-6)


def test_similarity_row_blocks_are_the_same_maxima():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, 50, 8)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal((2, 3, 40, 8)).astype(np.float32))
    masks = torch.from_numpy((rng.random((2, 3, 4, 40)) < 0.2).astype(
        np.float32))
    masks[0, :, 3] = 0                       # a class with no support pixel
    whole = tsim.class_max_similarity(q, s, masks)
    for block in (4 * 2 * 3 * 40 * 7, 1):   # 7 rows a block, one
        # the same products; the matmul's blocking may round an ulp apart
        torch.testing.assert_close(
            tsim.class_max_similarity(q, s, masks, block_bytes=block), whole,
            rtol=1e-6, atol=1e-6)
    assert torch.isneginf(whole[0, 3]).all() and torch.isfinite(whole[1]).all()


def test_c22_cosine_yaml_cannot_run_as_it_stands():
    """``validation/COCO/cosine.yaml``: no encoder in the model block and no
    ``emb_dir`` in its sets, so the batches carry images (JAX
    ``data/coco.py:137-138``) and the model raises in both packages; on an
    embedding cache it runs."""
    flat = expand_experiment(load_yaml(
        "parameters/validation/COCO/cosine.yaml"))[0]
    block = {k: v for k, v in flat["model"].items() if k != "name"}
    assert not any("emb_dir" in d for d in flat["dataset"]["datasets"]
                   .values())
    batch = _similarity_batch(c=2)
    images = dict(batch, **{BatchKeys.IMAGES: np.zeros((2, 3, 32, 32, 3),
                                                       np.float32)})
    del images[BatchKeys.EMBEDDINGS]
    with pytest.raises(ValueError, match="Encoder is None"):
        jregistry["similarity"](**block).apply({}, images)
    with pytest.raises(ValueError, match="Encoder is None"):
        model_registry["similarity"](**block)(_t(images))
    # the file's compare_size 128 cut to 16 (the 128 x 128 grid's
    # similarities are 4 GiB at this batch)
    out = model_registry["similarity"](**dict(block, compare_size=16))(
        _t(batch))
    assert out[ResultDict.LOGITS].shape == (2, 2, 480, 480)
    assert torch.isfinite(out[ResultDict.LOGITS]).all()
