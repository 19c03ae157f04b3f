"""The plain ViT encoders (MAE, ImageNet-21k, DINO-B/8) of the port against
the JAX package on the CPU, at toy width:

* ``ops.resize.resize_cubic`` against ``jax.image.resize(method="cubic",
  antialias=False)`` within 1e-5, and its distance from torch's bicubic;
* ``models.vit.StandardViT`` against the JAX module at its pretraining grid
  and off it (the position table interpolated), weights carried by
  ``utils.weights.state_dict_from_jax``;
* ``StandardViT`` against Hugging Face's ``ViTModel`` built from a random
  local ``ViTConfig``, its state dict loaded with ``strict=True``: at the
  pretraining grid they agree; off it they part (ROADMAP C23: the JAX
  package and the port interpolate by ``jax.image.resize``'s cubic, HF by
  torch's bicubic); SegFormer's MiT (``models/segformer.py``) against HF's
  ``SegformerModel`` likewise;
* the three plain-ViT LAMs (``lam_mae_b``, ``lam_dino_b8``,
  ``lam_b_imagenet_i21k``) through the registries, their encoders cut to 2
  blocks 48 wide in both packages; the full-size layouts are held by
  ``tests/test_torch_coverage.py``;
* one AdamW step of ``trainval/other/3_NewTraining_ViT.yaml``'s block
  (class and example attention, ``backbone_lr``, focal + dice +
  ``prompt_contrastive``) through both ``make_train_step``s, and
  ``freeze_backbone`` picking the encoder's parameters as JAX's mask does.

fp32 tolerance: rtol 1e-3, atol 5e-4 unless stated.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from labelanything_tpu.data.synthetic import random_batch, random_full_batch
from labelanything_tpu.models import build_encoder as jbe
from labelanything_tpu.models import lam as jlam
from labelanything_tpu.models import vit as jvit
from labelanything_tpu.models.registry import model_registry as jregistry
from labelanything_tpu.parallel import train_step as jts
from labelanything_tpu.train import losses as jl
from labelanything_tpu.train import optim as jo
from labelanything_tpu.typing import BatchKeys, ResultDict
from labelanything_tpu_torch.models import build_encoder as tbe
from labelanything_tpu_torch.models import vit as tvit
from labelanything_tpu_torch.models import segformer as tseg
from labelanything_tpu_torch.models.registry import model_registry
from labelanything_tpu_torch.ops.resize import resize_cubic
from labelanything_tpu_torch.parallel.train_step import (init_train_state,
                                                         make_train_step)
from labelanything_tpu_torch.train import losses as tl
from labelanything_tpu_torch.train import substitutor as ts
from labelanything_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_lam_variants import (FAST_COMPILE, RME, TOL,
                                           compare_flagged, jax_params,
                                           jax_run, load)
from tests.test_torch_run import CHANGE_REL_L2, ELEMENT_STEPS, _rel_l2
from tests.torch_threads import one_torch_thread  # noqa: F401

TOY_VIT = dict(embed_dim=48, depth=2, num_heads=2)
MIT_TOY = dict(embed_dims=(8, 16, 24, 32), depths=(1, 1, 2, 1),
               num_heads=(1, 2, 3, 4), sr_ratios=(8, 4, 2, 1))


def _images(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---- resize_cubic ---------------------------------------------------------- #

@pytest.mark.parametrize("n_in,n_out", [(14, 30), (28, 60), (2, 4), (30, 14)])
def test_resize_cubic_matches_jax(n_in, n_out):
    x = _images((1, n_in, n_in, 24), seed=n_in)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, n_out, n_out, 24),
                                       method="cubic", antialias=False))
    got = resize_cubic(torch.from_numpy(x), (n_out, n_out)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # torch's bicubic (a = -0.75, edges repeated) is another function
    bicubic = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=(n_out, n_out),
        mode="bicubic").permute(0, 2, 3, 1).numpy()
    assert np.abs(bicubic - want).max() > 0.05


# ---- StandardViT ----------------------------------------------------------- #

def _vit_pair(**kw):
    jm = jvit.StandardViT(patch_size=16, mlp_ratio=2.0, pretrain_grid=4,
                          **TOY_VIT, **kw)
    tm = tvit.StandardViT(patch_size=16, mlp_ratio=2.0, pretrain_grid=4,
                          **TOY_VIT, **kw)
    return jm, tm


@pytest.mark.parametrize("size", [64, 96])
def test_standard_vit_matches_jax(size):
    """64 px is the 4 x 4 pretraining grid, 96 px a 6 x 6 grid (the table
    interpolated by the cubic resize)."""
    x = _images((2, size, size, 3), seed=size)
    jm, tm = _vit_pair()
    params = jax_params(jm, x)
    want = jax_run(jm.apply, params, x)
    tm = load(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (2, size // 16, size // 16, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def hugging_face():
    """``transformers`` without its TensorFlow half, or a skip."""
    os.environ.setdefault("USE_TF", "0")
    return pytest.importorskip("transformers")


def test_standard_vit_matches_hf_and_c23():
    """A random ``ViTModel`` (tanh GELU, the form the JAX package and the
    port take; HF's default is the erf form, ROADMAP C1) loads into the
    port with ``strict=True`` and agrees at its pretraining grid. Off it
    the position tables differ (C23): the port stays on the JAX
    package's cubic, which HF's bicubic misses by more than the
    tolerance."""
    transformers = hugging_face()
    cfg = transformers.ViTConfig(
        hidden_size=48, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=96, image_size=64, patch_size=16,
        hidden_act="gelu_pytorch_tanh", hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    hf = transformers.ViTModel(cfg, add_pooling_layer=False).eval()
    with torch.no_grad():
        hf.embeddings.cls_token.normal_(0, 0.5)
        hf.embeddings.position_embeddings.normal_(0, 0.5)
    _, tm = _vit_pair()
    tm.load_state_dict(hf.state_dict(), strict=True)
    tm.eval()
    for size in (64, 96):
        x = _images((2, size, size, 3), seed=size)
        with torch.no_grad():
            ref = hf(torch.from_numpy(x).permute(0, 3, 1, 2),
                     interpolate_pos_encoding=True).last_hidden_state[:, 1:]
            got = tm(torch.from_numpy(x))
        ref = ref.reshape(got.shape).numpy()
        if size == 64:
            np.testing.assert_allclose(got.numpy(), ref, **TOL)
        else:
            assert np.abs(got.numpy() - ref).max() > 10 * TOL["atol"]


def test_mit_matches_hugging_face():
    """HF's SegformerModel state dict into the port, strictly; HF's
    LayerNorms take eps 1e-5 in the blocks, the port 1e-6 as the JAX
    package, within the tolerance at these scales."""
    transformers = hugging_face()
    cfg = transformers.SegformerConfig(
        num_encoder_blocks=4, depths=list(MIT_TOY["depths"]),
        hidden_sizes=list(MIT_TOY["embed_dims"]),
        num_attention_heads=list(MIT_TOY["num_heads"]),
        sr_ratios=list(MIT_TOY["sr_ratios"]), patch_sizes=[7, 3, 3, 3],
        strides=[4, 2, 2, 2], mlp_ratios=[4] * 4, hidden_act="gelu",
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        drop_path_rate=0.0, layer_norm_eps=1e-6, reshape_last_stage=True)
    torch.manual_seed(7)
    hf = transformers.SegformerModel(cfg).eval()
    tm = tseg.MixVisionTransformer(**MIT_TOY).eval()
    tm.load_state_dict(hf.state_dict(), strict=True)
    x = _images((2, 3, 64, 64), seed=9)
    with torch.no_grad():
        hs = hf(torch.from_numpy(x), output_hidden_states=True).hidden_states
        got = tm(torch.from_numpy(x).permute(0, 2, 3, 1))
    for i in range(4):
        np.testing.assert_allclose(got[f"stage{i + 1}"].permute(0, 3, 1, 2)
                                   .numpy(), hs[i].numpy(), **TOL)


# ---- the three plain-ViT LAMs ---------------------------------------------- #

@pytest.fixture
def toy_vits(monkeypatch):
    """Both packages' plain-ViT builders at TOY_VIT's width and depth, their
    patch size and pretraining grid as published."""
    def shrink(cls):
        return lambda **kw: cls(**{**kw, **TOY_VIT})

    monkeypatch.setattr(jbe, "StandardViT", shrink(jvit.StandardViT))
    monkeypatch.setattr(tbe, "StandardViT", shrink(tvit.StandardViT))


@pytest.mark.parametrize("name,patch", [("lam_mae_b", 16),
                                        ("lam_dino_b8", 8),
                                        ("lam_b_imagenet_i21k", 16)])
def test_plain_vit_lams_match_jax(toy_vits, name, patch):
    block = dict(image_embed_dim=48, embed_dim=32, image_size=64,
                 vit_patch_size=patch, spatial_convs=1, class_encoder=RME)
    batch = random_batch(batch_size=1, num_examples=2, num_classes=3,
                         image_size=64, with_images=True, seed=3,
                         include_points=False, include_boxes=False)
    jm = jregistry[name](**block)
    params = jax_params(jm, batch)
    want = np.asarray(jax_run(jm.apply, params, batch)[ResultDict.LOGITS])
    tm = load(model_registry[name](**block), params)
    grid = tm.image_encoder.pretrain_grid
    assert (tm.image_encoder.patch_size, grid) == ((8, 28) if patch == 8
                                                   else (16, 14))
    with torch.no_grad():
        got = tm({k: torch.from_numpy(v) for k, v in batch.items()})[
            ResultDict.LOGITS].numpy()
    compare_flagged(got, want, batch)


# ---- 3_NewTraining_ViT.yaml's step ----------------------------------------- #

LR, BACKBONE_LR = 5e-5, 1e-5
NEW_TRAINING = dict(image_embed_dim=48, embed_dim=32, image_size=64,
                    spatial_convs=3, class_attention=True,
                    example_attention=True,
                    fusion_transformer="TwoWayTransformer",
                    class_encoder={"name": "RandomMatrixEncoder",
                                   "bank_size": 10})
COMPONENTS = {"focal": {"weight": 0.725}, "dice": {"weight": 0.025},
              "prompt_contrastive": {"weight": 0.25}}


def _episode():
    full = random_full_batch(batch_size=2, num_examples=2, num_classes=2,
                             image_size=64, with_images=True, seed=5)
    sub = ts.Substitutor(num_points=1, substitute=False)
    sub.reset({k: torch.from_numpy(v) for k, v in full.items()})
    return next(sub)


class WithExampleFlags:
    """The JAX model with ROADMAP C24 taken out: its result also holds the
    batch's example flags, which the ``prompt_contrastive`` loss reads (the
    port's Lam puts them there)."""

    def __init__(self, model):
        self.model = model

    def apply(self, params, batch, **kwargs):
        out = self.model.apply(params, batch, **kwargs)
        return {**out, BatchKeys.FLAG_EXAMPLES: batch[BatchKeys.FLAG_EXAMPLES]}


def test_c24_prompt_contrastive_reads_flags_the_jax_result_lacks(
        monkeypatch):
    """The JAX prompt encoder's result holds the example flags, but
    ``Lam.__call__`` leaves them out of the model's result (shown on the
    JAX ``__call__`` with its ``_forward`` stubbed), and the JAX train step
    hands its loss that result alone: the loss raises on the 7 files that
    weigh ``prompt_contrastive``. The port's result lacks them too, and its
    train step hands the loss the batch's (``loss_inputs``): a step runs."""
    batch = random_batch(batch_size=1, num_examples=2, num_classes=2,
                         image_size=64, embed_dim=48)
    flags = batch[BatchKeys.FLAG_EXAMPLES]
    stub = (jnp.zeros((1, 2, 16, 16)),
            {ResultDict.EXAMPLES_CLASS_EMBS: jnp.ones((1, 2, 2, 32)),
             BatchKeys.FLAG_EXAMPLES: jnp.asarray(flags)})
    monkeypatch.setattr(jlam.Lam, "_forward",
                        lambda self, b, deterministic=True: stub)
    block = dict(image_embed_dim=48, embed_dim=32, image_size=64)
    out = jregistry["lam_no_vit"](**block).apply({}, batch)
    assert BatchKeys.FLAG_EXAMPLES not in out
    target = np.zeros((1, 64, 64), np.int64)
    with pytest.raises(KeyError):
        jl.LabelAnythingLoss(components={"prompt_contrastive": {
            "weight": 1.0}}).init(jax.random.key(0), out,
                                  jnp.asarray(target))
    model = model_registry["lam_no_vit"](**block)
    with torch.no_grad():
        result = model.eval()({k: torch.from_numpy(v)
                               for k, v in batch.items()})
    assert BatchKeys.FLAG_EXAMPLES not in result
    state = init_train_state(model, tl.LabelAnythingLoss(COMPONENTS), "cpu")
    state, aux = make_train_step()(state, batch, target, None)
    assert torch.isfinite(aux["loss"]) and state.step == 1
    assert float(aux["components"]["prompt_contrastive"]) > 0


@pytest.fixture(scope="module")
def new_training_step():
    """The JAX side, once: one AdamW step with the backbone's own rate."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jbe, "StandardViT",
               lambda **kw: jvit.StandardViT(**{**kw, **TOY_VIT}))
    try:
        batch, gt = _episode()
        jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        model = jregistry["lam_mae_b"](**NEW_TRAINING)
        loss = jl.LabelAnythingLoss(components=COMPONENTS,
                                    class_weighting=True)
        loss_params = {"params": {"t_prime": np.log(np.full(1, 10.0, np.float32)),
                                  "bias": np.full(1, -10.0, np.float32)}}
        params = {"model": jax_params(model, jbatch), "loss": loss_params}
        params0 = jax.tree.map(np.asarray, params)
        tx = jo.build_optimizer(params, name="AdamW", learning_rate=LR,
                                backbone_lr=BACKBONE_LR)
        step = jts.make_train_step(WithExampleFlags(model), loss, tx).jitted
        state = jts.init_train_state(jax.tree.map(jnp.asarray, params0), tx)
        args = (state, jbatch, jnp.asarray(gt.numpy()), jax.random.key(7))
        state, aux = step.lower(*args, loss_scale=1.0, apply_update=True,
                                use_accum=False).compile(FAST_COMPILE)(*args)
        after = jax.tree.map(np.asarray, state.params)
    finally:
        mp.undo()
    # the bank rows the JAX step drew: the ones AdamW moved
    bank = [p["params"]["prompt_encoder"]["class_encoder"]["pos_embedding"][
        0, 0] for p in (params0["model"], after["model"])]
    rows = tuple(int(r) for r in np.nonzero(
        (bank[0] != bank[1]).any(axis=-1))[0])
    assert len(rows) == 2 and rows[0] == 0, rows
    return dict(batch=batch, gt=gt, params0=params0, loss=float(aux["loss"]),
                after=after, rows=rows)


def _port_state(params0, rows=None, **optimizer_args):
    model = model_registry["lam_mae_b"](**NEW_TRAINING)
    model.load_state_dict(state_dict_from_jax(params0["model"]), strict=True)
    model.prompt_encoder.class_encoder.rows = rows
    loss = tl.LabelAnythingLoss(COMPONENTS, class_weighting=True)
    return init_train_state(model, loss, "cpu", learning_rate=LR,
                            **optimizer_args)


def test_new_training_vit_step_matches_jax(toy_vits, new_training_step):
    """Loss within 1e-5 relative; after the step every parameter within 2
    lr of JAX's (AdamW's first step moves an element by about lr, the sign
    of a noise-level gradient deciding), the encoder's by its own rate:
    they moved by about 1e-5 and the rest by about 5e-5. As a first step
    moves every element by about its rate whatever the gradient, the
    change as a whole is held to JAX's, within ``CHANGE_REL_L2`` relative
    L2, once over every parameter and once over the encoder's alone: a
    gradient of another sign, or the rates swapped between the groups,
    would miss it by far."""
    ref = new_training_step
    state = _port_state(ref["params0"], ref["rows"], backbone_lr=BACKBONE_LR)
    assert [g["lr"] for g in state.optimizer.param_groups] == [LR,
                                                               BACKBONE_LR]
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, aux = make_train_step()(state, ref["batch"], ref["gt"], None, 1.0,
                                   apply_update=True, use_accum=False)
    np.testing.assert_allclose(float(aux["loss"]), ref["loss"], rtol=1e-5)
    after = state_dict_from_jax(ref["after"]["model"])
    moves = {"enc": [], "rest": []}
    for key, value in state.model.state_dict().items():
        if key.endswith("positional_encoding_gaussian_matrix"):
            continue
        got, want = value.numpy(), after[key].numpy()
        rate = BACKBONE_LR if key.startswith("image_encoder.") else LR
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=ELEMENT_STEPS * rate, err_msg=key)
        moves["enc" if rate == BACKBONE_LR else "rest"].append(
            np.abs(got - before[key].numpy()).max())
    assert 0.9 * BACKBONE_LR < max(moves["enc"]) < 1.1 * BACKBONE_LR
    assert 0.9 * LR < max(moves["rest"]) < 1.1 * LR
    got = state.model.state_dict()
    keys = [k for k in got
            if not k.endswith("positional_encoding_gaussian_matrix")]
    encoder = [k for k in keys if k.startswith("image_encoder.")]
    for part in (keys, encoder):
        whole = lambda sd: np.concatenate([sd[k].numpy().ravel()
                                           for k in part])
        assert _rel_l2(whole(got) - whole(before),
                       whole(after) - whole(before)) <= CHANGE_REL_L2
    t_prime = ref["after"]["loss"]["params"]["t_prime"]
    np.testing.assert_allclose(state.loss.t_prime.detach().numpy(), t_prime,
                               rtol=0, atol=ELEMENT_STEPS * LR)


def test_freeze_backbone_picks_the_plain_vit(toy_vits, new_training_step):
    """JAX's optimizer mask and the port's parameter groups pick the same
    parameters as the backbone: the StandardViT's."""
    tree = new_training_step["params0"]["model"]
    picked = sum(leaf.size for leaf, b in zip(
        jax.tree.leaves(tree), jax.tree.leaves(jo.backbone_mask(tree))) if b)
    state = _port_state({"model": tree}, freeze_backbone=True)
    frozen = [p for p in state.model.parameters() if not p.requires_grad]
    assert sum(p.numel() for p in frozen) == picked > 0
    assert sum(p.numel() for p in state.model.image_encoder.parameters()) \
        == picked
