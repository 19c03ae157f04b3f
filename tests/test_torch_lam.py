"""The port's LAM slice (pixels to logits) against the JAX package's, on the
CPU, and the original PyTorch LabelAnything's golden outputs through the
port.

Toy size of the ViT-B slice: 128 px, patch 16, encoder depth 2 (block 1
global), window 3 (padded windows), embed 128 with 2 heads, LAM embed 64,
3 spatial convs, class bank 10, with the slice's attention flags (example
attention only) and the pre-neck encoder state through the LAM neck. JAX
initializes the weights; the relative-position tables are then filled with
nonzero values; ``utils/weights.py`` carries them across with
``strict=True``.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from labelanything_tpu.data.synthetic import random_batch
from labelanything_tpu.models import build_lam as jbl
from labelanything_tpu.models.image_encoder import ImageEncoderViT as JViT
from labelanything_tpu.typing import BatchKeys, ResultDict
from labelanything_tpu_torch.api import LabelAnything
from labelanything_tpu_torch.models import build_lam as tbl
from labelanything_tpu_torch.models.image_encoder import ImageEncoderViT as TViT
from labelanything_tpu_torch.models.lam import Lam, Neck
from labelanything_tpu_torch.models.mask_decoder import MaskDecoderLam
from labelanything_tpu_torch.models.prompt_encoder import (
    IdentityClassEncoder, PromptImageEncoder)
from labelanything_tpu_torch.models.transformer import TwoWayTransformer
from labelanything_tpu_torch.utils.weights import state_dict_from_jax
from tests.golden import CASES, load_fixture, make_weights
from tests.test_torch_baselines import jax_init
from tests.test_torch_image_encoder import TOY_VIT, nonzero_rel_pos
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-3, atol=5e-4)   # tests/golden.py:165
TOY_LAM = dict(use_vit_sam_neck=False, image_embed_dim=128, embed_dim=64,
               image_size=128, spatial_convs=3, class_attention=False,
               example_attention=True, example_class_attention=False,
               class_encoder={"name": "RandomMatrixEncoder", "bank_size": 10})
PROMPTS = {
    "all": (BatchKeys.PROMPT_POINTS, BatchKeys.PROMPT_BBOXES,
            BatchKeys.PROMPT_MASKS),
    "points_boxes": (BatchKeys.PROMPT_POINTS, BatchKeys.PROMPT_BBOXES),
    "masks": (BatchKeys.PROMPT_MASKS,),
}
_FLAGS = {BatchKeys.PROMPT_POINTS: BatchKeys.FLAG_POINTS,
          BatchKeys.PROMPT_BBOXES: BatchKeys.FLAG_BBOXES,
          BatchKeys.PROMPT_MASKS: BatchKeys.FLAG_MASKS}


def _episode(prompts="all"):
    batch = random_batch(batch_size=2, num_examples=2, num_classes=3,
                         image_size=128, with_images=True, seed=3)
    for key in set(_FLAGS) - set(PROMPTS[prompts]):
        del batch[key], batch[_FLAGS[key]]
    return batch


def _support(batch):
    """The episode's examples alone (the query image dropped)."""
    out = dict(batch)
    out[BatchKeys.IMAGES] = batch[BatchKeys.IMAGES][:, 1:]
    out[BatchKeys.DIMS] = batch[BatchKeys.DIMS][:, 1:]
    return out


def _jax_vit(project_last_hidden, dtype):
    return JViT(use_rel_pos=True, project_last_hidden=project_last_hidden,
                dtype=dtype, **TOY_VIT)


def _port_vit(project_last_hidden, image_size, dtype):
    return TViT(project_last_hidden=project_last_hidden, dtype=dtype, **TOY_VIT)


@pytest.fixture(scope="module")
def models():
    jm = jbl._build_lam(build_vit=_jax_vit, **TOY_LAM)
    batch = jax.tree.map(jnp.asarray, _episode())
    params = nonzero_rel_pos(jax_init(jm, batch))
    tm = tbl._build_lam(build_vit=_port_vit, **TOY_LAM).eval()
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, tm


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _assert_logits_close(ours, ref):
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(ours), finite)
    np.testing.assert_array_equal(ours[~finite], ref[~finite])
    np.testing.assert_allclose(ours[finite], ref[finite], **TOL)


@pytest.mark.parametrize("prompts", sorted(PROMPTS))
def test_lam_forward_matches_jax(models, prompts):
    jm, params, tm = models
    batch = _episode(prompts)
    ref = jax.jit(jm.apply)(params, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        ours = tm(_t(batch))
    logits = ours[ResultDict.LOGITS].numpy()
    assert logits.shape == (2, 3, 128, 128)
    # the pad region of the query (dims (128, 115)) is 0 / -inf
    assert np.isneginf(logits[:, 1:, :, 120:]).all()
    assert (logits[:, 0, :, 120:] == 0).all()
    _assert_logits_close(logits, ref[ResultDict.LOGITS])
    np.testing.assert_allclose(
        ours[ResultDict.EXAMPLES_CLASS_EMBS].numpy(),
        np.asarray(ref[ResultDict.EXAMPLES_CLASS_EMBS]), **TOL)


def test_export_state_dict_copy_matches_jax_package(models):
    """The port keeps its own copy of the JAX package's
    ``export_state_dict``; on the full toy ``lam_b`` tree the two give the
    same keys and arrays."""
    from labelanything_tpu.utils.torch_import import export_state_dict as ref
    from labelanything_tpu_torch.utils.weights import export_state_dict

    _, params, _ = models
    ours, theirs = export_state_dict(params), ref(params)
    assert sorted(ours) == sorted(theirs) and len(ours) > 100
    for key, value in theirs.items():
        assert ours[key].dtype == value.dtype, key
        np.testing.assert_array_equal(ours[key], value, err_msg=key)


def test_serving_split_matches_jax(models):
    jm, params, tm = models
    batch = _episode()
    support = _support(batch)
    ref_embs = jax.jit(functools.partial(
        jm.apply, method="generate_class_embeddings"))(
            params, jax.tree.map(jnp.asarray, support))
    ref = jax.jit(functools.partial(jm.apply, method="predict"))(
        params, jax.tree.map(jnp.asarray, batch), ref_embs)
    with torch.no_grad():
        embs = tm.generate_class_embeddings(_t(support))
        ours = tm.predict(_t(batch), embs)
    for key in (ResultDict.CLASS_EMBS, ResultDict.EXAMPLES_CLASS_EMBS):
        np.testing.assert_allclose(embs[key].numpy(),
                                   np.asarray(ref_embs[key]), **TOL)
    _assert_logits_close(ours.numpy(), ref)
    # the split agrees with the whole-episode forward
    with torch.no_grad():
        whole = tm(_t(batch))[ResultDict.LOGITS]
    _assert_logits_close(ours.numpy(), whole.numpy())


def test_label_anything_api(models, monkeypatch):
    _, params, tm = models
    config = dict(TOY_LAM, name="lam_b")
    batch = _episode()
    with torch.no_grad():
        ref = tm(_t(batch))[ResultDict.LOGITS].numpy()
    # the api builds ViT-B; the toy encoder's builder stands in for it
    monkeypatch.setattr(tbl, "build_vit_b", _port_vit)
    la = LabelAnything.from_jax_params(config, params, "cpu")
    seeded = [LabelAnything(config, "cpu", seed=7) for _ in range(2)]
    _assert_logits_close(la.predict(batch).numpy(), ref)
    embs = la.generate_class_embeddings(_support(batch))
    _assert_logits_close(la.predict(batch, embs).numpy(), ref)
    a, b = (s.predict(batch) for s in seeded)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    rel = seeded[0].model.image_encoder.blocks[0].attn.rel_pos_h
    assert rel.abs().min() > 0


def test_bf16_serving_path(models):
    """bf16 compute: logits come back bf16 with the 0 / -inf pad fill and
    agree with fp32 to bf16 precision."""
    _, params, tm32 = models
    tm16 = tbl._build_lam(build_vit=_port_vit, dtype="bf16", **TOY_LAM)
    tm16.load_state_dict(state_dict_from_jax(params), strict=True)
    batch = _t(_episode())
    with torch.no_grad():
        ref = tm32(batch)[ResultDict.LOGITS]
        ours = tm16(batch)[ResultDict.LOGITS]
    assert ours.dtype == torch.bfloat16
    finite = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(ours), finite)
    err = (ours.float() - ref)[finite].abs().max().item()
    assert err < 0.05 * ref[finite].abs().max().item(), err


# -- golden fixtures of the original PyTorch LabelAnything ------------------

def _channels_last(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -3, -1)))


def _two_way(d, heads, mlp):
    return TwoWayTransformer(depth=2, embedding_dim=d, num_heads=heads,
                             mlp_dim=mlp, attention_downsample_rate=2)


def _prompt_encoder(g):
    return PromptImageEncoder(
        embed_dim=g.D, image_embedding_size=(g.GRID, g.GRID),
        input_image_size=(g.IMG, g.IMG), mask_in_chans=16,
        transformer=_two_way(g.D, g.HEADS, g.MLP),
        class_encoder=IdentityClassEncoder())


def _replay_two_way(case, g):
    img, pe, tokens = case._inputs()
    module = _two_way(g.D, g.HEADS, g.MLP)
    return module, lambda: dict(zip("qk", module(
        _channels_last(img), _channels_last(pe), torch.from_numpy(tokens))))


def _replay_mask_decoder(case, g):
    query, image_pe, class_embs, ex, _ = case._inputs()   # flags unused
    module = MaskDecoderLam(transformer_dim=g.D,
                            transformer=_two_way(g.D, g.HEADS, g.MLP))
    pe_result = {ResultDict.CLASS_EMBS: torch.from_numpy(class_embs),
                 ResultDict.EXAMPLES_CLASS_EMBS: torch.from_numpy(ex)}
    return module, lambda: {"seg": module(
        _channels_last(query), _channels_last(image_pe), pe_result)}


def _replay_prompt_encoder(case, g):
    (coords, labels, boxes, bflags, masks, mflags, flag_examples,
     emb) = case._inputs()
    module = _prompt_encoder(g)
    t = torch.from_numpy
    # the case's prompt modalities only, as the reference ran it
    use = lambda kind, pair: (tuple(map(t, pair)) if case.use in ("all", kind)
                              else None)

    def run():
        out = module(_channels_last(emb), use("points", (coords, labels)),
                     use("boxes", (boxes, bflags)), use("masks", (masks, mflags)),
                     t(flag_examples))
        return {"class_embs": out[ResultDict.CLASS_EMBS],
                "examples_class_embs": out[ResultDict.EXAMPLES_CLASS_EMBS],
                "examples_class_src":
                    out[ResultDict.EXAMPLES_CLASS_SRC].permute(0, 3, 1, 2)}

    return module, run


def _replay_lam_full(case, g):
    (coords, labels, boxes, bflags, masks, mflags, flag_examples, emb,
     dims) = case._inputs()
    module = Lam(prompt_encoder=_prompt_encoder(g),
                 mask_decoder=MaskDecoderLam(
                     transformer_dim=g.D,
                     transformer=_two_way(g.D, g.HEADS, g.MLP)),
                 neck=Neck(case.image_embed_dim, g.D), image_size=g.IMG)
    batch = {BatchKeys.EMBEDDINGS: _channels_last(emb),
             BatchKeys.PROMPT_POINTS: coords, BatchKeys.FLAG_POINTS: labels,
             BatchKeys.PROMPT_BBOXES: boxes, BatchKeys.FLAG_BBOXES: bflags,
             BatchKeys.PROMPT_MASKS: masks, BatchKeys.FLAG_MASKS: mflags,
             BatchKeys.FLAG_EXAMPLES: flag_examples, BatchKeys.DIMS: dims}
    return module, lambda: {"logits": module(_t(batch))[ResultDict.LOGITS]}


REPLAYS = {
    "two_way_transformer": _replay_two_way,
    "mask_decoder": _replay_mask_decoder,
    "prompt_image_encoder_all": _replay_prompt_encoder,
    "prompt_image_encoder_points": _replay_prompt_encoder,
    "prompt_image_encoder_boxes": _replay_prompt_encoder,
    "prompt_image_encoder_masks": _replay_prompt_encoder,
    "lam_full": _replay_lam_full,
}


@pytest.mark.parametrize("name", sorted(REPLAYS))
def test_golden_replay(name):
    """Reference-layout weights from the fixture's seed load into the port
    with ``strict=True``; its outputs match the committed reference
    outputs at the case's tolerance."""
    import tests.golden as g

    case = CASES[name]
    shapes, outputs = load_fixture(name)
    module, run = REPLAYS[name](case, g)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in
                            make_weights(case, shapes).items()}, strict=True)
    with torch.no_grad():
        ours = {k: v.numpy() for k, v in run().items()}
    case.compare(ours, outputs)


@pytest.mark.slow
@pytest.mark.parametrize("name,options", [
    ("canonical_full_forward", {}),
    ("sam_released_full_forward", {}),
    ("sam_released_full_forward", {"fused_window": True}),
], ids=["canonical", "sam_released", "sam_released_fused_window"])
def test_golden_full_forward_replay(name, options):
    """The two full-size fixtures (``lam_no_vit`` at 480 px; ``lam_b`` at
    1024 px, with the fused windowed block too) through the port on the
    CPU, at the cases' own tolerances. Slow, as in
    tests/test_parity_golden.py: a full ViT-B forward at 1024 px in fp32."""
    from tests.torch_golden_replay import replay

    ours, ref = replay(name, **options)
    CASES[name].compare(ours, ref)
