"""The LAM variants that 19 files of ``parameters/`` set, ported against the
JAX package on the CPU at toy width: OneWay / Identity fusion,
``class_embedding_dim`` with PrototypeAffinity and the support features
left out, embeddings per example (adaptive pool, GuidedPooler,
EmbeddingTransformer) with the ``masks`` loss, TokenPool,
``classification_levels``, ``conv_classification``, the decoder without
upscaling, and dropout.

The JAX modules take seeded values of their ``jax.eval_shape`` trees
(``tests.test_torch_baselines.seeded_variables``: nonzero biases and norm
offsets, so a misplaced parameter shows), the port's the same values
through ``utils.weights.state_dict_from_jax`` with ``strict=True``.
Everything is held at the golden harness's fp32 tolerance, rtol 1e-3 /
atol 5e-4; logits on the classes some example flags (a class that none
flags is -inf before the upscale in both packages, ROADMAP C4).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from labelanything_tpu.data.synthetic import random_batch
from labelanything_tpu.models import build_lam as jbl
from labelanything_tpu.models import mask_decoder as jmd
from labelanything_tpu.models import transformer as jtr
from labelanything_tpu.train import losses as jlosses
from labelanything_tpu.typing import BatchKeys, ResultDict
from labelanything_tpu.utils.torch_import import convert_state_dict
from labelanything_tpu_torch.api import LabelAnything, build_from_config
from labelanything_tpu_torch.models import common as tcommon
from labelanything_tpu_torch.models import mask_decoder as tmd
from labelanything_tpu_torch.models import transformer as ttr
from labelanything_tpu_torch.ops import fused_twoway as ft
from labelanything_tpu_torch.train import losses as tlosses
from labelanything_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_baselines import seeded_variables
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-3, atol=5e-4)
D = 32                      # toy width
RME = {"name": "RandomMatrixEncoder", "bank_size": 10}


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_params(module, *args, seed=0, **kwargs):
    """Seeded values of a flax module's parameter tree."""
    shapes = jax.eval_shape(
        lambda *a: module.init(jax.random.key(seed), *a, **kwargs), *args)
    return seeded_variables(shapes, seed)


# XLA's CPU backend at optimization level 0: the same computation, compiled
# in about two thirds of the time
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def jax_run(fn, *args):
    """``fn(*args)`` compiled by ``jax.jit`` with :data:`FAST_COMPILE`."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def load(module: torch.nn.Module, params) -> torch.nn.Module:
    module.load_state_dict(state_dict_from_jax(params), strict=True)
    return module.eval()


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


# ---- (a) the fusion transformers ----------------------------------------- #

def _fusion_inputs(seed=0, b=2, hw=(4, 5), n=3):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((b,) + hw + (D,)).astype(np.float32)
    pe = rng.standard_normal((1,) + hw + (D,)).astype(np.float32)
    tok = rng.standard_normal((b, n, D)).astype(np.float32)
    return img, pe, tok


def test_oneway_transformer_matches_jax():
    img, pe, tok = _fusion_inputs()
    jm = jtr.OneWayTransformer(depth=2, embedding_dim=D, num_heads=8,
                               mlp_dim=64)
    params = jax_params(jm, img, pe, tok)
    jq, jk = jax_run(jm.apply, params, img, pe, tok)
    tm = load(ttr.OneWayTransformer(2, D, 8, 64), params)
    with torch.no_grad():
        tq, tk = tm(_t(img), _t(pe), _t(tok))
    _close(tq, jq)
    _close(tk, jk)
    assert jk.shape == (2, 20, D)


def test_identity_transformer_matches_jax():
    img, pe, tok = _fusion_inputs()
    jq, jk = jtr.IdentityTransformer().apply({}, img, pe, tok)
    tq, tk = ttr.IdentityTransformer()(_t(img), _t(pe), _t(tok))
    assert not list(ttr.IdentityTransformer().parameters())
    np.testing.assert_array_equal(tq.numpy(), _np(jq))
    np.testing.assert_array_equal(tk.numpy(), _np(jk))


# ---- (b) the mask decoder without upscaling (no file sets it) ------------ #

def test_mask_decoder_without_upscaling_matches_jax():
    """``conv_upsample_stride`` and the downsample rate 1: no up-convs and
    no class MLP; one embedding per (example, class), a class that one
    example leaves out takes the other's logit, a class that none flags
    is -inf."""
    rng = np.random.default_rng(0)
    b, m, c, h = 2, 2, 3, 4
    query = rng.standard_normal((b, h, h, D)).astype(np.float32)
    pe = rng.standard_normal((1, h, h, D)).astype(np.float32)
    embs = rng.standard_normal((b, m, c, D)).astype(np.float32)
    flags = np.ones((b, m, c), np.int32)
    flags[0, :, 2] = 0
    flags[1, 1, 1] = 0
    pe_result = {ResultDict.EXAMPLES_CLASS_EMBS: embs,
                 BatchKeys.FLAG_EXAMPLES: flags}
    options = dict(classification_layer_downsample_rate=1,
                   conv_upsample_stride=1, spatial_convs=1,
                   segment_example_logits=True)
    # no fusion: the identity transformer hands the decoder its inputs
    jm = jmd.MaskDecoderLam(transformer_dim=D,
                            transformer=jtr.IdentityTransformer(), **options)
    jpr = {k: jnp.asarray(v) for k, v in pe_result.items()}
    params = jax_params(jm, query, None, pe, jpr, None)
    want = _np(jax_run(lambda *a: jm.apply(*a), params, query, None, pe,
                       jpr, None))
    tm = load(tmd.MaskDecoderLam(D, ttr.IdentityTransformer(), **options),
              params)
    assert tm.output_upscaling is None and tm.class_mlp is None
    with torch.no_grad():
        got = tm(_t(query), _t(pe),
                 {k: _t(v) for k, v in pe_result.items()}).numpy()
    assert got.shape == want.shape == (b, c, h, h)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got[0, 2]).all()
    sel = np.isfinite(want)
    assert sel.sum() == (b * c - 1) * h * h
    np.testing.assert_allclose(got[sel], want[sel], **TOL)


def test_mask_embedding_loss_matches_jax():
    rng = np.random.default_rng(7)
    masks = tuple(rng.random((4, 6, 1, 5, 5)).astype(np.float32)
                  for _ in range(2))
    for alpha, beta, gamma in ((0.2, 0.4, 0.4), (1.0, 0.0, 2.0)):
        want = jax_run(lambda m: jlosses.mask_embedding_loss(
            {ResultDict.MASK_EMBEDDINGS: m}, alpha, beta, gamma), masks)
        got = tlosses.mask_embedding_loss(
            {ResultDict.MASK_EMBEDDINGS: tuple(map(_t, masks))},
            alpha, beta, gamma)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    # as a component of the loss module, beside focal
    logits = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    target = rng.integers(0, 3, (2, 8, 8)).astype(np.int32)
    components = {"focal": {"weight": 0.8}, "masks": {"weight": 0.2}}
    jres = {ResultDict.LOGITS: jnp.asarray(logits),
            ResultDict.MASK_EMBEDDINGS: tuple(map(jnp.asarray, masks))}
    want = jax_run(lambda r, t: jlosses.LabelAnythingLoss(components).apply(
        {}, r, t), jres, jnp.asarray(target))
    got = tlosses.LabelAnythingLoss(components)(
        {ResultDict.LOGITS: _t(logits),
         ResultDict.MASK_EMBEDDINGS: tuple(map(_t, masks))}, _t(target))
    np.testing.assert_allclose(got["value"].item(), float(want["value"]),
                               rtol=1e-5)


# ---- (d) whole lam_no_vit models, one per model block of the files ------- #

# toy widths of each distinct model block (64 px, a 4 x 4 grid of 48-wide
# embeddings), named by the files that set them
BLOCKS = {
    # the one-way and identity blocks of mae_transformer.yaml and
    # transformer_spatial.yaml are these without the example merge and the
    # class bank, both held in every other block
    "oneway(mae_transformer,transformer_spatial,COCO_*oneway*)": dict(
        fusion_transformer="OneWayTransformer", spatial_convs=3,
        example_attention=True, example_class_attention=False,
        class_encoder=RME),
    "identity(mae_transformer,transformer_spatial,PASCAL_identity)": dict(
        fusion_transformer="IdentityTransformer", spatial_convs=3,
        example_attention=True, example_class_attention=False,
        class_encoder=RME),
    "afclass(4.3,4.3.1)": dict(
        spatial_convs=3, class_attention=True, example_attention=True,
        class_embedding_dim=48, few_type="Affinity", class_fusion="sigmoid",
        class_encoder=RME),
    "afclass_noconvs(4.3.2)": dict(
        class_attention=True, example_attention=True, class_embedding_dim=48,
        few_type="Affinity", class_fusion="sigmoid", class_encoder=RME),
    "prototype_affinity(4.4)": dict(
        embed_dim=64, spatial_convs=3, class_attention=True,
        example_attention=True, class_embedding_dim=96,
        use_support_features_in_prompt_encoder=False,
        few_type="PrototypeAffinity", class_fusion="sigmoid",
        class_encoder=RME),
    "chooser(mae_chooser)": dict(
        spatial_convs=3, example_class_attention=False,
        embeddings_per_example=4, embedding_extraction="pooler",
        classification_levels=2),
    "multiemb(mae_multiemb)": dict(
        spatial_convs=3, example_class_attention=False,
        embeddings_per_example=4),
    "multiemb9(validation/mae_multiemb)": dict(
        spatial_convs=3, example_class_attention=False,
        embeddings_per_example=9),
    "cross(mae_cross)": dict(
        spatial_convs=3, example_class_attention=False,
        embeddings_per_example=4, embedding_extraction="cross_attention"),
    "pool(mae_pool)": dict(spatial_convs=3, prompt_encoder="TokenPool",
                           class_encoder=RME),
    "levels(mae_levels)": dict(spatial_convs=3, example_class_attention=False,
                               classification_levels=2),
    "nodown(mae_nodown)": dict(spatial_convs=3,
                               classification_layer_downsample_rate=1,
                               conv_classification=True, class_encoder=RME),
    "dropout(PASCAL_dropout)": dict(spatial_convs=3, example_attention=True,
                                    example_class_attention=False,
                                    dropout=0.5, class_encoder=RME),
}


def toy_block(name: str) -> dict:
    return {"image_embed_dim": 48, "embed_dim": D, "image_size": 64,
            **BLOCKS[name]}


def toy_episode(seed=0, masks_only=True):
    batch = random_batch(batch_size=2, num_examples=2, num_classes=3,
                         image_size=64, embed_dim=48, seed=seed,
                         include_points=not masks_only,
                         include_boxes=not masks_only)
    batch[BatchKeys.FLAG_EXAMPLES][0, :, 2] = 0
    return batch


def compare_flagged(got, want, batch):
    """Flagged classes within TOL where JAX's logit is finite (the pad band
    of the fixed frame is -inf in both), and most of them finite."""
    flagged = batch[BatchKeys.FLAG_EXAMPLES].any(axis=1)
    sel = flagged[:, :, None, None] & np.isfinite(want)
    assert sel.sum() > 0.5 * flagged.sum() * want.shape[-1] ** 2
    np.testing.assert_array_equal(np.isfinite(got[sel]), True)
    np.testing.assert_allclose(got[sel], want[sel], **TOL)


def block_params(config: dict, seed: int = 0) -> dict:
    """Seeded values (as :func:`jax_params`) of the JAX model's tree, its
    shapes from the JAX package's own converter of the port's state-dict
    layout (``utils/torch_import.convert_state_dict``) rather than a trace
    of ``init``, a third of a block's JAX time: the same tree, but for the
    converter's one gap, which takes PrototypeAffinity's LayerNorm2d
    ``proto_ln`` for a LayerNorm (``scale``; the flax module's leaves are
    ``weight`` and ``bias``)."""
    with torch.device("meta"):
        model = build_from_config(dict(config, name="lam_no_vit"))
    tree = convert_state_dict({k: np.zeros(tuple(v.shape), np.float32)
                               for k, v in model.state_dict().items()})
    proto_ln = tree.get("mask_decoder", {}).get("proto_ln")
    if proto_ln is not None:
        proto_ln["weight"] = proto_ln.pop("scale")
    return seeded_variables({"params": tree}, seed)


def _top_level_call(module, method_name) -> bool:
    return method_name == "__call__" and len(module.scope.path) == 1


def compare_pe_result(got: dict, want: dict) -> None:
    """Every entry of the prompt encoder's result."""
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if key == ResultDict.MASK_EMBEDDINGS:
            for g, w in zip(got[key], value):
                _close(g, w)
        elif key == BatchKeys.FLAG_EXAMPLES:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(value))
        else:
            assert tuple(got[key].shape) == value.shape, key
            _close(got[key], value)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_lam_variant_matches_jax(name):
    """The whole forward in eval() mode (JAX's deterministic one), and the
    two modules inside it on the same inputs: the prompt encoder's every
    output (the class-embedding projections, the gate of the support
    features, the k x k pool, the pooler's choices, the cross-attention
    extraction, TokenPool) and the decoder's logits (one-way / identity
    fusion, per-example logits, two levels, convolutional classification,
    PrototypeAffinity)."""
    config = toy_block(name)
    init = toy_episode(masks_only=False)
    jm = jbl.build_lam_no_vit(**config)
    params = block_params(config)
    la = LabelAnything.from_jax_params(dict(config, name="lam_no_vit"),
                                       params, "cpu")
    seen = {}
    for part in ("prompt_encoder", "mask_decoder"):
        getattr(la.model, part).register_forward_hook(
            lambda mod, args, out, part=part: seen.__setitem__(part, out))
    # TokenPool: points, boxes and masks (coco20i/mae_pool.yaml trains on
    # all three); the others: masks, the validation files' prompts
    episodes = ([init] if "TokenPool" in config.values()
                else [toy_episode(seed=1)])
    for batch in episodes:
        want, state = jax_run(
            lambda p, x: jm.apply(p, x, capture_intermediates=_top_level_call,
                                  mutable=["intermediates"]),
            params, jax.tree.map(jnp.asarray, batch))
        inner = state["intermediates"]
        got = la(batch)
        assert sorted(got) == sorted(want)
        compare_flagged(got[ResultDict.LOGITS].numpy(),
                        _np(want[ResultDict.LOGITS]), batch)
        _close(got[ResultDict.EXAMPLES_CLASS_EMBS],
               want[ResultDict.EXAMPLES_CLASS_EMBS])
        compare_pe_result(seen["prompt_encoder"],
                          inner["prompt_encoder"]["__call__"][0])
        dec, jdec = (seen["mask_decoder"].numpy(),
                     _np(inner["mask_decoder"]["__call__"][0]))
        assert dec.shape == jdec.shape
        flagged = batch[BatchKeys.FLAG_EXAMPLES].any(axis=1)
        sel = flagged[:, :, None, None] & np.isfinite(jdec)
        assert sel.any()
        np.testing.assert_allclose(dec[sel], jdec[sel], **TOL)


# ---- (e) dropout --------------------------------------------------------- #

def _dropout_model():
    config = toy_block("dropout(PASCAL_dropout)")
    la = LabelAnything(dict(config, name="lam_no_vit"), "cpu", seed=0)
    return la.model, toy_episode(seed=1)


def _train_logits(model, batch, seed):
    gen = torch.Generator().manual_seed(seed)
    with tcommon.dropout_generator(gen), torch.no_grad():
        return model({k: _t(v) for k, v in batch.items()})[ResultDict.LOGITS]


def test_dropout_masks_follow_the_generator():
    """In train() mode: the same generator seed gives the same forward, a
    different one another, the eval() forward differs from both; without a
    generator the forward refuses to draw from the global one."""
    model, batch = _dropout_model()
    model.train()
    a, b = _train_logits(model, batch, 3), _train_logits(model, batch, 3)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    c = _train_logits(model, batch, 4)
    finite = torch.isfinite(a) & torch.isfinite(c)
    assert not torch.equal(a[finite], c[finite])
    with pytest.raises(RuntimeError, match="generator"):
        model({k: _t(v) for k, v in batch.items()})
    model.eval()
    with torch.no_grad():
        e = model({k: _t(v) for k, v in batch.items()})[ResultDict.LOGITS]
    assert not torch.equal(e[finite], a[finite])


@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_dropout_keep_rate_and_scale(rate):
    """One mask of 200 000 elements keeps 1 - rate of them within 5
    binomial standard deviations, and the kept ones are scaled by
    1 / (1 - rate); eval() is the identity."""
    drop = tcommon.Dropout(rate)
    x = torch.full((400, 500), 3.0)
    with tcommon.dropout_generator(torch.Generator().manual_seed(0)):
        y = drop.train()(x)
    kept = y != 0
    n = x.numel()
    sd = (n * rate * (1 - rate)) ** 0.5
    assert abs(kept.sum().item() - n * (1 - rate)) < 5 * sd
    torch.testing.assert_close(y[kept], torch.full_like(y[kept],
                                                        3.0 / (1 - rate)))
    assert torch.equal(drop.eval()(x), x)


def test_fused_route_refuses_a_training_forward_with_dropout(monkeypatch):
    """K7's route (``fused_twoway_ok``, patched to admit the CPU) takes a
    forward in eval() mode, or in train() mode at rate 0; a train()-mode
    forward with dropout takes the module path by rule, never reaching
    the kernel."""
    img, pe, tok = _fusion_inputs()
    args = [_t(x) for x in (img, pe, tok)]
    calls = []
    monkeypatch.setattr(ft, "fused_twoway_ok", lambda *a, **k: True)

    def fused(*a, **k):
        calls.append(1)
        raise AssertionError("the fused kernel was called")

    monkeypatch.setattr(ft, "fused_twoway_transformer", fused)
    for rate in (0.0, 0.2):
        module = ttr.TwoWayTransformer(2, D, 8, 64, dropout=rate)
        with pytest.raises(AssertionError, match="fused kernel"):
            module.eval()(*args)
        module.train()
        assert module.drops() == (rate > 0)
        if rate == 0.0:
            with pytest.raises(AssertionError, match="fused kernel"):
                module(*args)
        else:
            with tcommon.dropout_generator(torch.Generator().manual_seed(0)):
                q, k = module(*args)
            assert torch.isfinite(k).all()
    assert len(calls) == 3


def test_train_step_dropout_follows_the_seed_and_the_step():
    """The train step's dropout generator is the run's seed, the update
    count and the pass's index since the last update: the same three give
    the same stream (a resumed run draws the same masks), another update
    count another; two passes of the dropout block, one accumulating, then
    an update, on the CPU."""
    from labelanything_tpu_torch.parallel import train_step as ts

    model, batch = _dropout_model()
    state = ts.init_train_state(
        model, tlosses.LabelAnythingLoss({"focal": {"weight": 1.0}}), "cpu",
        dropout_seed=42, name="AdamW", learning_rate=1e-4)

    def draw():
        gen = ts.pass_dropout_generator(state, torch.device("cpu"))
        return torch.rand(8, generator=gen)

    first = draw()
    assert torch.equal(first, draw())
    state.step += 1
    assert not torch.equal(first, draw())
    state.step -= 1
    gt = batch.pop(BatchKeys.GROUND_TRUTHS)     # IGNORE_INDEX in the pad
    step = ts.make_train_step()
    state, aux = step(state, batch, gt, None, apply_update=False)
    assert (state.step, state.passes) == (0, 1)
    assert torch.isfinite(aux["loss"])
    assert not torch.equal(first, draw())
    state, aux = step(state, batch, gt, None)
    assert (state.step, state.passes) == (1, 0)
    assert torch.isfinite(aux["loss"])


def test_variant_checkpoint_round_trip(tmp_path):
    """A variant's config and weights through ``save_pretrained`` /
    ``from_pretrained``: the keys of the block come back, and the model
    gives the same logits (NaN where the two levels merge the -inf of a
    class that no example flags)."""
    config = dict(toy_block("chooser(mae_chooser)"), name="lam_no_vit")
    la = LabelAnything(config, "cpu", seed=3)
    la.save_pretrained(str(tmp_path / "ckpt"))
    back = LabelAnything.from_pretrained(str(tmp_path / "ckpt"), "cpu")
    assert back.config == config
    batch = toy_episode(seed=2)
    torch.testing.assert_close(back(batch)[ResultDict.LOGITS],
                               la(batch)[ResultDict.LOGITS], rtol=0, atol=0,
                               equal_nan=True)
