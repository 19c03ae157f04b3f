"""The port's training slice against the JAX package's, on the CPU.

Losses, schedules, optimizers, metrics and the substitutor are held against
their JAX counterparts on seeded numpy inputs, and one whole train step of
a toy ``lam_b`` (images path, encoder trainable) against the JAX
``make_train_step`` from the same weights and batch: loss, every
parameter's gradient, and every parameter after AdamW.

Toy size: 64 px, patch 16 (a 4 x 4 grid), encoder depth 2 with block 1
global, window 3 (windows pad 4 -> 6), embed 128 with 2 heads of 64, LAM
embed 32, class bank 10, fp32. JAX draws the class rows of
``RandomMatrixEncoder`` from its own random stream; with one foreground
class the draw is read off the bank's gradient and the port is pinned to it.
"""

import inspect

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from labelanything_tpu.data.synthetic import random_full_batch as j_full_batch
from labelanything_tpu.models import build_lam as jbl
from labelanything_tpu.models.image_encoder import ImageEncoderViT as JViT
from labelanything_tpu.parallel import train_step as jts
from labelanything_tpu.train import losses as jl
from labelanything_tpu.train import metrics as jm
from labelanything_tpu.train import optim as jo
from labelanything_tpu.train import substitutor as js
from labelanything_tpu.typing import BatchKeys, IGNORE_INDEX, ResultDict
from labelanything_tpu_torch.data.synthetic import random_full_batch
from labelanything_tpu_torch.experiment.run import drop_absent_modalities
from labelanything_tpu_torch.models import build_lam as tbl
from labelanything_tpu_torch.models import common as tcommon
from labelanything_tpu_torch.models.image_encoder import ImageEncoderViT as TViT
from labelanything_tpu_torch.models.prompt_encoder import RandomMatrixEncoder
from labelanything_tpu_torch.parallel.train_step import (init_train_state,
                                                         make_eval_step,
                                                         make_train_step)
from labelanything_tpu_torch.train import losses as tl
from labelanything_tpu_torch.train import metrics as tm
from labelanything_tpu_torch.train import optim as to
from labelanything_tpu_torch.train import substitutor as ts
from labelanything_tpu_torch.utils.weights import (init_weights,
                                                  state_dict_from_jax)
from tests.test_torch_baselines import jax_init
from tests.test_torch_image_encoder import nonzero_rel_pos
from tests.torch_threads import one_torch_thread  # noqa: F401

TOY_VIT = dict(img_size=64, patch_size=16, embed_dim=128, depth=2,
               num_heads=2, window_size=3, global_attn_indexes=(1,),
               out_chans=32)
TOY_LAM = dict(use_vit_sam_neck=False, image_embed_dim=128, embed_dim=32,
               image_size=64, spatial_convs=3, class_attention=False,
               example_attention=True, example_class_attention=False,
               class_encoder={"name": "RandomMatrixEncoder", "bank_size": 10})
LR = 5e-5


def _t(tree):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in tree.items()}


# ---- losses ---------------------------------------------------------------

def _logits_target(seed=0, b=2, c=3, s=12):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, c, s, s)).astype(np.float32) * 2.0
    logits[:, 2, :, -2:] = -np.inf          # a masked class band
    target = rng.integers(0, 2, (b, s, s)).astype(np.int32)
    target[0, :3, :3] = 2
    target[:, :, -1] = IGNORE_INDEX
    return logits, target


def _both(j_fn, t_fn, logits, target):
    """(value, dvalue/dlogits) of a JAX loss and of its port."""
    jv, jg = jax.value_and_grad(j_fn)(jnp.asarray(logits), jnp.asarray(target))
    x = torch.tensor(logits, requires_grad=True)
    tv = t_fn(x, torch.as_tensor(target))
    tv.backward()
    return float(jv), np.asarray(jg), float(tv.detach()), x.grad.numpy()


@pytest.mark.parametrize("name,kwargs", [
    ("focal_loss", {}), ("focal_loss", {"gamma": 3.0}),
    ("dice_loss", {}), ("dice_loss", {"average": "micro"}),
    ("false_positive_loss", {}),
])
def test_logits_losses_match_jax(name, kwargs):
    """Values to 1e-5 relative, gradients w.r.t. logits to 1e-5 / 1e-7
    (fp32, sums in another order); -inf logits get a zero gradient."""
    logits, target = _logits_target()
    jv, jg, tv, tg = _both(lambda l, t: getattr(jl, name)(l, t, **kwargs),
                           lambda l, t: getattr(tl, name)(l, t, **kwargs),
                           logits, target)
    assert np.isfinite(tv) and np.isfinite(tg).all()
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-7)
    assert (tg[np.isneginf(logits)] == 0).all()


def test_cross_entropy_and_weight_matrix_match_jax():
    logits, target = _logits_target(seed=1)
    ours = tl.cross_entropy_per_pixel(torch.as_tensor(logits),
                                      torch.as_tensor(target)).numpy()
    ref = np.asarray(jl.cross_entropy_per_pixel(jnp.asarray(logits),
                                                jnp.asarray(target)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)
    assert (ours[target == IGNORE_INDEX] == 0).all()
    for c in (3, 5):        # 5: two classes with no pixel keep weight 1
        wm, cw = tl.get_weight_matrix_from_labels(torch.as_tensor(target), c)
        jwm, jcw = jl.get_weight_matrix_from_labels(jnp.asarray(target), c)
        np.testing.assert_allclose(cw.numpy(), np.asarray(jcw), rtol=1e-6)
        np.testing.assert_allclose(wm.numpy(), np.asarray(jwm), rtol=1e-6)


def _embedding_result(seed=2, b=2, m=3, c=3, d=16):
    rng = np.random.default_rng(seed)
    flags = rng.integers(0, 2, (b, m, c)).astype(np.int32)
    flags[..., 0] = 1
    return {ResultDict.EXAMPLES_CLASS_EMBS:
            rng.standard_normal((b, m, c, d)).astype(np.float32),
            BatchKeys.FLAG_EXAMPLES: flags}


def test_embedding_losses_match_jax():
    result = _embedding_result()
    embs = result[ResultDict.EXAMPLES_CLASS_EMBS]
    jr = {k: jnp.asarray(v) for k, v in result.items()}
    tr = _t(result)
    np.testing.assert_allclose(
        float(tl.loss_orthogonality(torch.as_tensor(embs[:, 0]))),
        float(jl.loss_orthogonality(jnp.asarray(embs[:, 0]))), rtol=1e-5)
    np.testing.assert_allclose(
        float(tl.class_embedding_contrastive_loss(tr)),
        float(jl.class_embedding_contrastive_loss(jr)), rtol=1e-5)
    t_prime, bias = np.log(10.0, dtype=np.float32), np.float32(-10.0)
    ours = tl.prompt_contrastive_loss(tr, torch.tensor([t_prime]),
                                      torch.tensor([bias]))
    ref = jl.prompt_contrastive_loss(jr, jnp.asarray([t_prime]),
                                     jnp.asarray([bias]))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)


@pytest.mark.parametrize("components,class_weighting", [
    ({"focal": {"weight": 1.0}}, True),
    ({"focal": {"weight": 0.7, "gamma": 2.0}, "dice": {"weight": 0.3},
      "prompt_contrastive": {"weight": 0.1}}, False),
])
def test_label_anything_loss_matches_jax(components, class_weighting):
    """Total, components and d total / d logits against the flax module
    (rtol 1e-5; gradients also atol 1e-7)."""
    logits, target = _logits_target(seed=3)
    result = dict(_embedding_result(b=2), **{ResultDict.LOGITS: logits})
    j_mod = jl.LabelAnythingLoss(components=components,
                                 class_weighting=class_weighting)
    jr = {k: jnp.asarray(v) for k, v in result.items()}
    variables = j_mod.init(jax.random.key(0), jr, jnp.asarray(target))

    def j_total(lg):
        out = j_mod.apply(variables, {**jr, ResultDict.LOGITS: lg},
                          jnp.asarray(target))
        return out["value"], out["components"]

    (jv, jparts), jg = jax.value_and_grad(j_total, has_aux=True)(
        jnp.asarray(logits))
    t_mod = tl.LabelAnythingLoss(components, class_weighting=class_weighting)
    tr = _t(result)
    tr[ResultDict.LOGITS].requires_grad_()
    out = t_mod(tr, torch.as_tensor(target))
    out["value"].backward()
    np.testing.assert_allclose(float(out["value"].detach()), float(jv), rtol=1e-5)
    assert sorted(out["components"]) == sorted(jparts)
    for name, value in jparts.items():
        np.testing.assert_allclose(float(out["components"][name]),
                                   float(value), rtol=1e-5)
    np.testing.assert_allclose(tr[ResultDict.LOGITS].grad.numpy(),
                               np.asarray(jg), rtol=1e-5, atol=1e-7)
    names = sorted(n for n, _ in t_mod.named_parameters())
    assert names == (["bias", "t_prime"] if "prompt_contrastive" in components
                     else [])


def test_unported_loss_component_raises():
    for name in ("rmi", "nonsense"):
        with pytest.raises(ValueError, match="Unknown or unported"):
            tl.LabelAnythingLoss({name: {"weight": 1.0}})
    # the GuidedPooler's regularizer is ported
    masks = tl.LabelAnythingLoss({"masks": {"weight": 1.0}})
    assert "masks" in masks.components


def test_bf16_logits_reduce_in_fp32():
    logits, target = _logits_target(seed=4)
    mod = tl.LabelAnythingLoss({"focal": {"weight": 1.0}})
    half = mod(torch.as_tensor(logits).bfloat16(), torch.as_tensor(target))
    assert half["value"].dtype == torch.float32


# ---- schedules and optimizers ----------------------------------------------

@pytest.mark.parametrize("cfg", [
    dict(name="constant"),
    dict(name="constant_with_warmup", num_warmup_steps=4),
    dict(name="constant_with_warmup"),
    dict(name="linear", num_warmup_steps=3, num_training_steps=12),
    dict(name="cosine", num_warmup_steps=3, num_training_steps=12),
    dict(name="cosine"),
])
@pytest.mark.parametrize("div", [1, 3])
def test_schedules_match_optax(cfg, div):
    """lr of steps 0..19 through LambdaLR against the optax schedule
    (rtol 1e-6, atol 1e-12)."""
    ref_fn = jo.build_scheduler(learning_rate=LR, **cfg)
    p = torch.nn.Parameter(torch.zeros(1))
    opt, sched = to.build_optimizer([("model.w", p)], learning_rate=LR,
                                    scheduler=cfg, schedule_div=div)
    for step in range(20):
        np.testing.assert_allclose(sched.get_last_lr()[0],
                                   float(ref_fn(step // div)),
                                   rtol=1e-6, atol=1e-12)
        opt.step()
        sched.step()
    with pytest.raises(ValueError, match="Unknown scheduler"):
        to.build_scheduler(name="nope")


@pytest.mark.parametrize("kwargs", [
    dict(name="AdamW"),
    dict(name="AdamW", weight_decay=0.1, backbone_lr=1e-3),
    dict(name="AdamW", freeze_backbone=True),
    dict(name="SGD", weight_decay=0.05, momentum=0.9,
         scheduler=dict(name="linear", num_warmup_steps=1,
                        num_training_steps=4)),
])
def test_optimizer_steps_match_optax(kwargs):
    """Three steps of about lr = 1e-2 each on the same gradients; the
    parameters agree to 5e-7, that is 2e-5 of a step (the two Adam
    updates round in another order)."""
    rng = np.random.default_rng(0)
    shapes = {("image_encoder", "w"): (4, 3), ("neck", "w"): (5,),
              ("prompt_encoder", "pe_layer",
               "positional_encoding_gaussian_matrix"): (2, 3)}
    params = {}
    for path, shape in shapes.items():
        node = params
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = rng.standard_normal(shape).astype(np.float32)
    jparams = {"model": jax.tree.map(jnp.asarray, params), "loss": {}}
    tx = jo.build_optimizer(jparams, learning_rate=1e-2, **kwargs)
    opt_state = tx.init(jparams)

    trainable = [p for p in shapes if p[-1] == "w"]   # the matrix is a buffer
    tparams = {".".join(("model",) + p): torch.nn.Parameter(torch.tensor(
        np.asarray(_get(params, p)))) for p in trainable}
    opt, sched = to.build_optimizer(tparams.items(), learning_rate=1e-2,
                                    **kwargs)
    for _ in range(3):
        grads = jax.tree.map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape), jnp.float32),
            jparams)
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p in trainable:
            param = tparams[".".join(("model",) + p)]
            if param.requires_grad:
                param.grad = torch.tensor(np.asarray(_get(grads["model"], p)))
        opt.step()
        sched.step()
    for p in trainable:
        np.testing.assert_allclose(
            tparams[".".join(("model",) + p)].detach().numpy(),
            np.asarray(_get(jparams["model"], p)), rtol=0, atol=5e-7)
    frozen = tparams["model.image_encoder.w"]
    assert frozen.requires_grad == (not kwargs.get("freeze_backbone", False))
    # the Gaussian matrix never moves on the JAX side either
    key = ("prompt_encoder", "pe_layer", "positional_encoding_gaussian_matrix")
    np.testing.assert_array_equal(np.asarray(_get(jparams["model"], key)),
                                  _get(params, key))


def _get(tree, path):
    for part in path:
        tree = tree[part]
    return tree


def test_unreached_parameters_step_as_in_optax():
    """Two AdamW steps of the port's train step on a toy ``lam_no_vit``
    (weight decay 0.1): the first batch has mask prompts alone, so the
    point embeddings get no gradient until the second, which has every
    prompt kind; ``no_mask_embed`` and the prompt encoder's final attention
    get none in either. optax updates every leaf, with zeros where the loss
    does not reach: the port's parameters after both steps equal the JAX
    package's AdamW on the same gradients (None as zeros) to 5e-7, at lr
    1e-2 (a skipped leaf's first Adam step would be 0.26 lr off the second
    one's, and a leaf never reached would not decay)."""
    model = tbl._build_lam(build_vit=None, use_vit=False, **dict(
        TOY_LAM, image_embed_dim=32))
    init_weights(model, seed=3)
    loss = tl.LabelAnythingLoss({"focal": {"weight": 1.0}},
                                class_weighting=True)
    state = init_train_state(model, loss, "cpu", learning_rate=1e-2,
                             name="AdamW", weight_decay=0.1)
    named = dict(model.named_parameters())
    start = {k: p.detach().numpy().copy() for k, p in named.items()}
    step = make_train_step()
    all_grads = []
    for kinds in (("masks",), ("points", "boxes", "masks")):
        full = random_full_batch(batch_size=2, num_examples=2, num_classes=2,
                                 image_size=64, embed_dim=32, seed=5)
        for kind, flag in (("points", BatchKeys.FLAG_POINTS),
                           ("boxes", BatchKeys.FLAG_BBOXES)):
            if kind not in kinds:
                full[flag] = np.zeros_like(full[flag])
        sub = ts.Substitutor(num_points=1, substitute=False)
        sub.reset(_t(full))
        batch, gt = next(sub)
        batch = drop_absent_modalities(batch)
        step(state, batch, gt, torch.Generator().manual_seed(0), 1.0,
             apply_update=False)
        all_grads.append({k: None if p.grad is None else p.grad.numpy().copy()
                          for k, p in named.items()})
        step(state, batch, gt, torch.Generator().manual_seed(0), 1.0,
             apply_update=True, use_accum=False)
    first, second = all_grads
    late = "prompt_encoder.point_embeddings.0.weight"
    never = "prompt_encoder.no_mask_embed.weight"
    assert first[late] is None and second[late] is not None
    assert first[never] is None and second[never] is None

    tree = {}
    for key, value in start.items():
        node = tree
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.asarray(value)
    jparams = {"model": tree, "loss": {}}
    tx = jo.build_optimizer(jparams, name="AdamW", learning_rate=1e-2,
                            weight_decay=0.1)
    opt_state = tx.init(jparams)
    for grads in all_grads:
        jgrads = jax.tree.map(jnp.zeros_like, jparams)
        for key, g in grads.items():
            if g is not None:
                node = jgrads["model"]
                parts = key.split(".")
                for part in parts[:-1]:
                    node = node[part]
                node[parts[-1]] = jnp.asarray(g)
        updates, opt_state = tx.update(jgrads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    for key, param in named.items():
        ref = np.asarray(_get(jparams["model"], key.split(".")))
        np.testing.assert_allclose(param.detach().numpy(), ref, rtol=0,
                                   atol=5e-7, err_msg=key)
    for key in (late, never):
        assert not np.array_equal(named[key].detach().numpy(), start[key])


# ---- metrics ----------------------------------------------------------------

def _preds_target(seed=5, b=3, c=4, s=16):
    rng = np.random.default_rng(seed)
    preds = rng.integers(0, c, (b, s, s)).astype(np.int32)
    target = rng.integers(0, c - 1, (b, s, s)).astype(np.int32)  # class 3 absent
    target[:, :, -3:] = IGNORE_INDEX
    return preds, target


def test_confusion_matrices_match_jax():
    preds, target = _preds_target()
    tp, tt = torch.as_tensor(preds), torch.as_tensor(target)
    jp, jt = jnp.asarray(preds), jnp.asarray(target)
    np.testing.assert_array_equal(
        tm.confusion_matrix_per_sample(tp, tt, 4).numpy(),
        np.asarray(jm.confusion_matrix_per_sample(jp, jt, 4)))
    np.testing.assert_array_equal(tm.confusion_matrix(tp, tt, 4).numpy(),
                                  np.asarray(jm.confusion_matrix(jp, jt, 4)))
    np.testing.assert_array_equal(
        tm.binary_confusion_matrix(tp, tt).numpy(),
        np.asarray(jm.binary_confusion_matrix(jp, jt)))
    lut = np.array([[0, 3, 5, 1], [0, 2, 2, 4], [0, 1, 2, 3]], np.int32)
    cm_ps = jm.confusion_matrix_per_sample(jp, jt, 4)
    np.testing.assert_array_equal(
        tm.fold_confusion_global(torch.as_tensor(np.array(cm_ps)),
                                 torch.as_tensor(lut), 6).numpy(),
        np.asarray(jm.fold_confusion_global(cm_ps, jnp.asarray(lut), 6)))


@pytest.mark.parametrize("fn", ["mean_iou", "strict_mean_iou"])
def test_iou_metrics_match_jax(fn):
    preds, target = _preds_target(seed=6)
    cm = np.array(jm.confusion_matrix(jnp.asarray(preds),
                                      jnp.asarray(target), 4))
    np.testing.assert_allclose(float(getattr(tm, fn)(torch.as_tensor(cm))),
                               float(getattr(jm, fn)(jnp.asarray(cm))),
                               rtol=1e-6)
    iou, valid = tm.iou_per_class(torch.as_tensor(cm))
    jiou, jvalid = jm.iou_per_class(jnp.asarray(cm))
    np.testing.assert_allclose(iou.numpy(), np.asarray(jiou), rtol=1e-6)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    cm2 = np.array(jm.binary_confusion_matrix(jnp.asarray(preds),
                                              jnp.asarray(target)))
    np.testing.assert_allclose(float(tm.fb_iou(torch.as_tensor(cm2))),
                               float(jm.fb_iou(jnp.asarray(cm2))), rtol=1e-6)


# ---- substitutor -----------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 5])
def test_rotation_and_division_match_jax(n):
    full = j_full_batch(batch_size=2, num_examples=n - 1, num_classes=3,
                        image_size=32, with_images=True, seed=n)
    for it in range(1, n + 1):
        perm = ts.rotation_permutation(it, n)
        assert perm == js.rotation_permutation(it, n)
        ours = ts.apply_permutation(_t(full), perm)
        ref = js.apply_permutation(jax.tree.map(jnp.asarray, full), perm)
        for key, value in ref.items():
            np.testing.assert_array_equal(ours[key].numpy(), np.asarray(value),
                                          err_msg=key)
    ours, gt = ts.divide_query_examples(_t(full))
    ref, jgt = js.divide_query_examples(full)
    assert sorted(ours) == sorted(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(value))
    np.testing.assert_array_equal(gt.numpy(), jgt)


def test_point_slots_match_jax():
    full = j_full_batch(batch_size=2, num_examples=2, num_classes=3,
                        image_size=32, with_images=True, seed=1)
    rng = np.random.default_rng(0)
    points = rng.uniform(0, 32, (2, 3, 1, 2)).astype(np.float32)
    labels = rng.integers(-1, 2, (2, 3, 1)).astype(np.int32)
    ours = ts.write_query_points(ts.preallocate_point_slots(_t(full), 4),
                                 torch.as_tensor(points),
                                 torch.as_tensor(labels), 3)
    ref = js.write_query_points(
        js.preallocate_point_slots(jax.tree.map(jnp.asarray, full), 4),
        jnp.asarray(points), jnp.asarray(labels), 3)
    for key in (BatchKeys.PROMPT_POINTS, BatchKeys.FLAG_POINTS):
        assert ours[key].dtype == torch.as_tensor(np.asarray(ref[key])).dtype
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(ref[key]))


def test_generate_points_from_errors_invariants():
    """The draw is random, so its invariants are held, not its values:
    every labelled point lies on an error pixel of that class with the
    right sign; classes without errors and the background get label 0;
    both packages agree on which (sample, class) pairs have points."""
    preds, target = _preds_target(seed=7, b=2, c=4, s=12)
    preds[1][target[1] == 2] = 2                   # class 2 of sample 1: no
    preds[1][(preds[1] == 2) & (target[1] != 2)] = 0          # errors at all
    points, labels = ts.generate_points_from_errors(
        torch.as_tensor(preds), torch.as_tensor(target),
        torch.Generator().manual_seed(0), num_classes=4, num_points=2)
    jpoints, jlabels = js.generate_points_from_errors(
        jnp.asarray(preds), jnp.asarray(target), jax.random.key(0),
        num_classes=4, num_points=2)
    assert points.shape == (2, 4, 2, 2) and labels.shape == (2, 4, 2)
    assert labels.dtype == torch.int32
    labels, points = labels.numpy(), points.numpy()
    np.testing.assert_array_equal(labels != 0, np.asarray(jlabels) != 0)
    assert (labels[:, 0] == 0).all() and (labels[1, 2] == 0).all()
    seen = 0
    for b, c, n in zip(*np.nonzero(labels)):
        x, y = points[b, c, n].astype(int)
        assert target[b, y, x] != IGNORE_INDEX
        missed = target[b, y, x] == c and preds[b, y, x] != c
        hallucinated = target[b, y, x] != c and preds[b, y, x] == c
        assert labels[b, c, n] == (1 if missed else -1)
        assert missed or hallucinated
        seen += 1
    assert seen > 0
    # without replacement: the two points of a pair differ
    assert (points[0, 1, 0] != points[0, 1, 1]).any()


def test_substitutor_passes_match_jax():
    full = j_full_batch(batch_size=1, num_examples=2, num_classes=2,
                        image_size=32, with_images=True, seed=2)
    ours, ref = ts.Substitutor(num_points=1), js.Substitutor(num_points=1)
    ours.reset(_t(full))
    ref.reset(jax.tree.map(jnp.asarray, full))
    passes = 0
    for (batch, gt), (jbatch, jgt) in zip(ours, ref):
        assert sorted(batch) == sorted(jbatch)
        for key in (BatchKeys.IMAGES, BatchKeys.PROMPT_MASKS, BatchKeys.DIMS,
                    BatchKeys.FLAG_EXAMPLES):
            np.testing.assert_array_equal(batch[key].numpy(),
                                          np.asarray(jbatch[key]))
        np.testing.assert_array_equal(gt.numpy(), np.asarray(jgt))
        assert batch[BatchKeys.PROMPT_POINTS].shape == \
            jbatch[BatchKeys.PROMPT_POINTS].shape
        preds = torch.zeros_like(gt)
        ours.generate_new_points(preds, gt, num_classes=2)
        ref.generate_new_points(jnp.zeros_like(jgt), jgt, jax.random.key(0), 2)
        passes += 1
    assert passes == 4      # N + 1 passes for N = 3 images
    single = ts.Substitutor(substitute=False)
    single.reset(_t(full))
    assert len(list(single)) == 1


@pytest.mark.parametrize("threshold,classes,expected", [
    (None, [[{1, 2}, {3}]], True),
    (0.5, [], True),
    (0.5, [[{1, 2}, {1, 2}], [{1}, {1, 2}]], True),     # mean 0.75
    (0.5, [[{1, 2}, {3}], [{1}, {1, 2}]], False),        # mean 0.25
    (0.2, [[{1}]], True),                                # one example: 1.0
])
def test_substitution_gate_matches_jax(threshold, classes, expected):
    ours = ts.Substitutor(threshold=threshold)
    ref = js.Substitutor(threshold=threshold)
    assert ours.calculate_if_substitute(classes) == expected
    assert ref.calculate_if_substitute(classes) == expected


# ---- models: row draw, dropout, remat ---------------------------------------

def test_random_matrix_encoder_row_draw():
    enc = RandomMatrixEncoder(bank_size=10, embed_dim=4)
    with torch.no_grad():
        enc.pos_embedding.copy_(
            torch.arange(10.0)[None, None, :, None].expand(1, 1, 10, 4))
    dense, sparse = torch.zeros(1, 1, 3, 2, 2, 4), torch.zeros(1, 1, 3, 1, 4)
    enc.eval()
    assert enc(dense, sparse)[1][0, 0, :, 0, 0].tolist() == [0, 1, 2]
    enc.train()       # no generator handed over: still rows 0..C-1
    assert enc(dense, sparse)[1][0, 0, :, 0, 0].tolist() == [0, 1, 2]
    generator = torch.Generator().manual_seed(3)
    draws = {tuple(enc(dense, sparse, generator)[1][0, 0, :, 0, 0].tolist())
             for _ in range(20)}
    assert len(draws) > 5
    for rows in draws:
        assert rows[0] == 0 and len(set(rows)) == 3
        assert all(1 <= r <= 9 for r in rows[1:])
    again = enc(dense, sparse, torch.Generator().manual_seed(3))
    same = enc(dense, sparse, torch.Generator().manual_seed(3))
    assert same[1][0, 0, :, 0, 0].tolist() == again[1][0, 0, :, 0, 0].tolist()
    enc.rows = (0, 7, 4)
    d, s = enc(dense, sparse, generator)
    assert s[0, 0, :, 0, 0].tolist() == [0, 7, 4]
    assert d[0, 0, :, 1, 1, 0].tolist() == [0, 7, 4]
    enc.rows = (0, 1)
    with pytest.raises(ValueError, match="classes"):
        enc(dense, sparse)


def test_slice_has_no_dropout():
    """Every dropout rate of the lam_b slice is 0 by the default of the
    JAX ``_build_lam``, which the port's copies, and no configuration of
    the slice sets one: every dropout layer of the built slice is the
    identity (rate 0), and none is torch's."""
    for build in (jbl._build_lam, tbl._build_lam):
        assert inspect.signature(build).parameters["dropout"].default == 0.0
    model = tbl._build_lam(build_vit=_port_vit, **TOY_LAM)
    assert not [m for m in model.modules()
                if isinstance(m, torch.nn.modules.dropout._DropoutNd)]
    rates = [m.rate for m in model.modules() if isinstance(m, tcommon.Dropout)]
    assert rates and set(rates) == {0.0}


def test_remat_policies():
    for policy in ("attn", "dots"):
        with pytest.raises(NotImplementedError, match="not ported"):
            TViT(remat=policy, **TOY_VIT)
    with pytest.raises(ValueError, match="unknown remat"):
        TViT(remat="everything", **TOY_VIT)


# ---- the slice as a whole ---------------------------------------------------

def _jax_vit(project_last_hidden, dtype, remat=False):
    return JViT(use_rel_pos=True, project_last_hidden=project_last_hidden,
                dtype=dtype, remat=remat, **TOY_VIT)


def _port_vit(project_last_hidden, image_size, dtype, remat=False):
    return TViT(project_last_hidden=project_last_hidden, dtype=dtype,
                remat=remat, **TOY_VIT)


def _episode():
    """1-way 2-shot, batch 2, all prompt kinds, as the fine-tune bench."""
    full = random_full_batch(batch_size=2, num_examples=2, num_classes=2,
                             image_size=64, with_images=True, seed=5)
    sub = ts.Substitutor(num_points=1, substitute=False)
    sub.reset(_t(full))
    return next(sub)


def _port_state(params, rows, **optimizer_args):
    model = tbl._build_lam(build_vit=_port_vit, **TOY_LAM)
    model.load_state_dict(state_dict_from_jax(params["model"]), strict=True)
    model.prompt_encoder.class_encoder.rows = rows
    loss = tl.LabelAnythingLoss({"focal": {"weight": 1.0}},
                                class_weighting=True)
    optimizer_args.setdefault("name", "AdamW")
    return init_train_state(model, loss, "cpu", learning_rate=LR,
                            **optimizer_args)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX side, run once: gradients of one pass (scaled by 0.5) and
    the parameters after accumulating two such passes. 0.5 g + 0.5 g is g
    exactly in floating point, so the same parameters are what one plain
    AdamW step on g gives (``use_accum=False``, scale 1), and the JAX step
    is not compiled a third time for that."""
    batch, gt = _episode()
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jgt = jnp.asarray(gt.numpy())
    model = jbl._build_lam(build_vit=_jax_vit, **TOY_LAM)
    loss = jl.LabelAnythingLoss(components={"focal": {"weight": 1.0}},
                                class_weighting=True)
    params = {"model": nonzero_rel_pos(jax_init(model, jbatch)), "loss": {}}
    params0 = _np_tree(params)
    tx = jo.build_optimizer(params, name="AdamW", learning_rate=LR)
    step = jts.make_train_step(model, loss, tx)
    rng = jax.random.key(7)
    state = jts.init_train_state(jax.tree.map(jnp.asarray, params0), tx)
    state, aux = step(state, jbatch, jgt, rng, 0.5, apply_update=False)
    half_grads = _np_tree(state.accum)
    state, _ = step(state, jbatch, jgt, rng, 0.5, apply_update=True)
    accumulated = _np_tree(state.params)
    bank = half_grads["model"]["params"]["prompt_encoder"]["class_encoder"][
        "pos_embedding"][0, 0]
    rows = np.nonzero(np.abs(bank).sum(axis=-1))[0]
    assert len(rows) == 2 and rows[0] == 0, rows
    return dict(batch=batch, gt=gt, params0=params0, loss=float(aux["loss"]),
                preds=np.asarray(aux["preds"]), half_grads=half_grads,
                accumulated=accumulated,
                rows=tuple(int(r) for r in rows))


def _assert_adamw_close(state, before, ref_after, grads):
    """AdamW's first step moves every element by lr * g / (|g| + 1e-8):
    where |g| > 1e-6 the two packages' parameters agree to 1e-3 of a step
    plus one fp32 ulp of the parameter; below that the sign of a
    noise-level gradient decides, so the parameters are only held within
    2 lr of each other."""
    ours = state.model.state_dict()
    assert sorted(ours) == sorted(ref_after)
    for key, ref in ref_after.items():
        got, ref = ours[key].detach().numpy(), ref.numpy()
        if key not in grads:       # the Gaussian matrix: a buffer, frozen
            np.testing.assert_array_equal(got, before[key].numpy())
            np.testing.assert_array_equal(ref, before[key].numpy())
            continue
        np.testing.assert_allclose(got, ref, rtol=0, atol=2.001 * LR,
                                   err_msg=key)
        big = np.abs(grads[key].numpy()) > 1e-6
        assert (np.abs(got - ref)[big]
                <= 1e-3 * LR + 2.0 ** -23 * np.abs(ref)[big]).all(), key
        moved = np.abs(got - before[key].numpy())[big]
        assert (moved > 0.9 * LR - 2.0 ** -23 * np.abs(ref)[big]).all(), key


def test_train_step_matches_jax(jax_run):
    """Loss to 1e-5 relative; every gradient within 1e-3 of its tensor's
    largest element plus 1e-8 (fp32, other summation orders through two
    encoder blocks and two transformers); then the AdamW step."""
    before = state_dict_from_jax(jax_run["params0"]["model"])
    ref_grads = state_dict_from_jax(jax_run["half_grads"]["model"])
    state = _port_state(jax_run["params0"], jax_run["rows"])
    step = make_train_step(num_classes=2, with_confmat=True)
    state, aux = step(state, jax_run["batch"], jax_run["gt"], None, 0.5,
                      apply_update=False)
    np.testing.assert_allclose(float(aux["loss"]), jax_run["loss"], rtol=1e-5)
    assert (aux["preds"].numpy() == jax_run["preds"]).mean() > 0.999
    assert state.step == 0
    named = dict(state.model.named_parameters())
    assert set(named) < set(ref_grads)          # all but the buffer
    grads = {}
    for key, param in named.items():
        ref = ref_grads[key].numpy()
        got = (np.zeros_like(ref) if param.grad is None
               else param.grad.numpy())
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-3 * np.abs(ref).max() + 1e-8,
                                   err_msg=key)
        grads[key] = 2.0 * torch.as_tensor(ref)
    for name in ("rel_pos_h", "rel_pos_w"):     # fed by dr alone
        for block in (0, 1):
            key = f"image_encoder.blocks.{block}.attn.{name}"
            assert np.abs(ref_grads[key].numpy()).max() > 0, key
    assert int(aux["confmat"].sum()) == int(
        (jax_run["gt"] != IGNORE_INDEX).sum())
    np.testing.assert_array_equal(aux["confmat_ps"].sum(dim=0).numpy(),
                                  aux["confmat"].numpy())

    # second accumulation pass: the update is on 0.5 g + 0.5 g
    state, _ = step(state, jax_run["batch"], jax_run["gt"], None, 0.5,
                    apply_update=True)
    assert state.step == 1
    assert all(p.grad is None for p in state.model.parameters())
    _assert_adamw_close(state, before,
                        state_dict_from_jax(jax_run["accumulated"]["model"]),
                        grads)

    # one plain step on this pass's gradients alone, stale .grad dropped
    state = _port_state(jax_run["params0"], jax_run["rows"])
    for p in state.model.parameters():
        p.grad = torch.ones_like(p)
    state, _ = step(state, jax_run["batch"], jax_run["gt"], None, 1.0,
                    apply_update=True, use_accum=False)
    _assert_adamw_close(state, before,
                        state_dict_from_jax(jax_run["accumulated"]["model"]),
                        grads)


def _grads_of(jax_run, **kwargs):
    model = tbl._build_lam(build_vit=_port_vit, **dict(TOY_LAM, **kwargs))
    model.load_state_dict(state_dict_from_jax(jax_run["params0"]["model"]))
    model.prompt_encoder.class_encoder.rows = jax_run["rows"]
    loss = tl.LabelAnythingLoss({"focal": {"weight": 1.0}},
                                class_weighting=True)
    state = init_train_state(model, loss, "cpu", learning_rate=LR)
    state, aux = make_train_step()(state, jax_run["batch"], jax_run["gt"],
                                   None, 1.0, apply_update=False)
    return float(aux["loss"]), {k: p.grad for k, p in
                                model.named_parameters()}


def test_remat_full_gives_the_same_gradients(jax_run):
    loss, grads = _grads_of(jax_run)
    for remat in (True, "full"):
        loss_r, grads_r = _grads_of(jax_run, remat_encoder=remat)
        assert loss_r == loss
        for key, g in grads.items():
            if g is None:
                assert grads_r[key] is None, key
            else:
                torch.testing.assert_close(grads_r[key], g, rtol=1e-6,
                                           atol=1e-9, msg=key)


def test_freeze_backbone_leaves_the_encoder_alone(jax_run):
    state = _port_state(jax_run["params0"], jax_run["rows"],
                        freeze_backbone=True)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, aux = make_train_step()(state, jax_run["batch"], jax_run["gt"],
                                   None, 1.0, apply_update=True,
                                   use_accum=False)
    np.testing.assert_allclose(float(aux["loss"]), jax_run["loss"], rtol=1e-5)
    moved = 0
    for key, value in state.model.state_dict().items():
        if key.startswith("image_encoder."):
            assert torch.equal(value, before[key]), key
        else:
            moved += int(not torch.equal(value, before[key]))
    assert moved > 20
    assert not any(p.requires_grad
                   for p in state.model.image_encoder.parameters())


def test_eval_step_and_row_draw_in_train_mode(jax_run):
    state = _port_state(jax_run["params0"], None)
    aux = make_eval_step(num_classes=2)(state.model, jax_run["batch"],
                                        jax_run["gt"])
    assert not state.model.training
    assert aux["preds"].shape == jax_run["gt"].shape
    assert int(aux["confmat"].sum()) == int(aux["confmat2"].sum())
    # unpinned, the step draws the rows from the generator it is given
    step = make_train_step()
    losses = []
    for seed in (0, 0, 1):
        state = _port_state(jax_run["params0"], None)
        _, aux = step(state, jax_run["batch"], jax_run["gt"],
                      torch.Generator().manual_seed(seed), 1.0,
                      apply_update=False)
        losses.append(float(aux["loss"]))
        assert state.model.training
    assert losses[0] == losses[1]


def test_entry_points_default_to_the_card(monkeypatch):
    """Serving and training build on the first CUDA card unless the caller
    names another device; a config handed to ``init_train_state`` is built
    where the state is to live, with the seed's weights."""
    from labelanything_tpu_torch import api

    for fn in (api.build_on_device, api.LabelAnything.__init__,
               api.LabelAnything.from_jax_params, init_train_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(tbl, "build_vit_b", _port_vit)
    config = dict(TOY_LAM, name="lam_b")
    loss = tl.LabelAnythingLoss({"focal": {"weight": 1.0}})
    states = [init_train_state(config, loss, "cpu", seed=3, learning_rate=LR)
              for _ in range(2)]
    served = api.LabelAnything(config, "cpu", seed=3)
    for key, value in states[0].model.state_dict().items():
        assert value.device.type == "cpu"
        assert torch.equal(value, states[1].model.state_dict()[key]), key
        assert torch.equal(value, served.model.state_dict()[key]), key
    assert float(states[0].model.neck[0].weight.abs().sum()) > 0
