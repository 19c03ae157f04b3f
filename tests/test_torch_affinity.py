"""The affinity decoder's path (few_type "Affinity", ``lam_no_vit``) and the
plain flash attention (K6) of the port against the JAX package, on the CPU.

The episodes are made by the JAX package's ``random_batch`` from a seed
with mask prompts only (the configuration's ``val_prompt_types: [mask]``);
the port's model takes the JAX model's parameters through
``state_dict_from_jax``. Logits are compared on the flagged classes
(rtol 1e-3 / atol 5e-4); a class that no example flags has no finite logit
in either package (ROADMAP C4). The flash twin is held against the JAX
Pallas kernel in interpret mode within 2e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from labelanything_tpu.data.synthetic import random_batch
from labelanything_tpu.models import build_lam as jbl
from labelanything_tpu.ops import flash_attention as jfa
from labelanything_tpu.typing import ResultDict
from labelanything_tpu_torch.api import LabelAnything, build_from_config
from labelanything_tpu_torch.models.affinity_decoder import AffinityDecoder
from labelanything_tpu_torch.ops import attention
from labelanything_tpu_torch.ops import flash_attention as fa
from tests.test_torch_baselines import jax_init
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-3, atol=5e-4)
CUDA = torch.device("cuda")


# (a) the plain twin and the wrapper on CPU tensors against the JAX kernel

def _qkv(shape_q, shape_k, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in (shape_q, shape_k, shape_k)]


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("q_len,k_len", [(1152, 1152), (1024, 2048)])
def test_flash_twin_matches_jax_kernel(q_len, k_len, dh):
    """The JAX Pallas kernel in interpret mode, as tests/test_ops.py runs
    it, against ``flash_attention_plain`` and the port's ``flash_attention``
    on CPU tensors; 1152 leaves a ragged last tile."""
    q, k, v = _qkv((1, 2, q_len, dh), (1, 2, k_len, dh))
    scale = dh ** -0.5
    old = jfa._INTERPRET
    jfa._INTERPRET = True
    try:
        want = np.asarray(jfa.flash_attention(*map(jnp.asarray, (q, k, v)),
                                              scale))
    finally:
        jfa._INTERPRET = old
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    before = dict(fa.LAUNCHES)
    for fn in (fa.flash_attention_plain, fa.flash_attention):
        np.testing.assert_allclose(fn(tq, tk, tv, scale).numpy(), want,
                                   rtol=2e-5, atol=2e-5)
    assert fa.LAUNCHES == before


def test_flash_gradients_match_jax():
    """The wrapper's backward (the twin recomputed under autograd) against
    the JAX ``flash_attention``'s custom VJP, which recomputes through
    ``_xla_ref``."""
    q, k, v = _qkv((1, 2, 96, 32), (1, 2, 80, 32))
    ct = np.random.default_rng(6).standard_normal((1, 2, 96, 32)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jfa._xla_ref(a, b, c, 0.2),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(ct))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(fa.flash_attention(*leaves, 0.2), leaves,
                              torch.from_numpy(ct))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)


def test_flash_function_gradcheck():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, dtype=torch.float64,
                           requires_grad=True)
               for shape in ((1, 2, 5, 4), (1, 2, 7, 4), (1, 2, 7, 4)))
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.flash_attention(a, b, c, 0.7), (q, k, v))


# (b) the route rule, and no way from a CUDA-typed call to the twin

RULE_CASES = [
    (dict(), True),                              # the affinity decoder's call
    (dict(q_len=1024, k_len=1024), True),
    (dict(q_len=1152, k_len=2048, head_dim=64), True),
    (dict(head_dim=128), True),
    (dict(head_dim=256), True),
    (dict(device=torch.device("cpu")), False),
    (dict(q_len=896), False),                    # under 1024 tokens
    (dict(k_len=900), False),                    # a 30 x 30 grid
    (dict(q_len=1025), False),                   # a CLS token
    (dict(k_len=4160), False),                   # not 128-aligned
    (dict(head_dim=80), False),                  # ViT-H's heads
    (dict(head_dim=16), False),
]


@pytest.mark.parametrize("change,expected", RULE_CASES)
def test_flash_route_rule(change, expected):
    case = dict(device=CUDA, q_len=4096, k_len=8192, head_dim=32)
    case.update(change)
    assert attention.flash_ok(**case) is expected


def test_flash_cuda_route_never_falls_back():
    """Off the CPU the wrapper launches its kernel or raises: a tensor on
    another device type is refused, and so are shapes that do not fit."""
    q, k = (torch.zeros(s, device="meta") for s in ((1, 2, 1024, 32),
                                                    (1, 2, 2048, 32)))
    before = dict(fa.LAUNCHES)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fa.flash_attention(q, k, k, 0.2)
    with pytest.raises(ValueError, match="differ"):
        fa.flash_attention(q, k[:, :1], k[:, :1], 0.2)
    with pytest.raises(ValueError, match="B, H, K, dh"):
        fa.flash_attention(q, k, k[..., :16], 0.2)
    assert fa.LAUNCHES == before


# (c) the affinity lam_no_vit at toy size against the JAX model

TOY = dict(image_embed_dim=48, embed_dim=32, image_size=96, spatial_convs=3,
           class_attention=True, example_attention=True, few_type="Affinity",
           class_encoder={"name": "RandomMatrixEncoder", "bank_size": 10})


def _episode(image_size=96, embed_dim=48, num_examples=2, num_classes=3,
             seed=0):
    """Mask prompts only; with seed 0 the first episode's class 1 has no
    flagged example."""
    return random_batch(batch_size=2, num_examples=num_examples,
                        num_classes=num_classes, image_size=image_size,
                        embed_dim=embed_dim, seed=seed, include_points=False,
                        include_boxes=False)


def _jax_model(config, batch):
    jm = jbl.build_lam_no_vit(**config)
    params = jax_init(jm, jax.tree.map(jnp.asarray, batch))
    return jm, params


@pytest.fixture(scope="module")
def toy_params():
    """One parameter tree serves every class fusion and key choice: they
    change no parameter."""
    return _jax_model(TOY, _episode())[1]


def _compare(logits, want, batch):
    """Flagged classes within TOL on the finite entries (the pad band is
    -inf in both); an unflagged class has no finite logit in either."""
    flagged = batch["flag_examples"].any(axis=1)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(logits), finite)
    sel = flagged[:, :, None, None] & finite
    assert sel.any()
    np.testing.assert_allclose(logits[sel], want[sel], **TOL)
    assert not finite[~flagged].any()


def _run_both(config, params, batch):
    jm = jbl.build_lam_no_vit(**config)
    want = np.asarray(jax.jit(jm.apply)(
        params, jax.tree.map(jnp.asarray, batch))[ResultDict.LOGITS])
    la = LabelAnything.from_jax_params(dict(config, name="lam_no_vit"),
                                       params, "cpu")
    return la, la(batch)[ResultDict.LOGITS].numpy(), want


@pytest.mark.parametrize("keys_are_images", [True, False],
                         ids=["keys_images", "keys_masks"])
@pytest.mark.parametrize("class_fusion", ["mul", "sum", "softmax", "sigmoid"])
def test_affinity_lam_matches_jax(toy_params, class_fusion, keys_are_images):
    batch = _episode()
    assert not batch["flag_examples"].any(axis=1).all()
    config = dict(TOY, class_fusion=class_fusion,
                  transformer_keys_are_images=keys_are_images)
    la, logits, want = _run_both(config, toy_params, batch)
    assert isinstance(la.model.mask_decoder, AffinityDecoder)
    assert logits.shape == want.shape == (2, 3, 96, 96)
    _compare(logits, want, batch)


def test_affinity_lam_through_the_flash_route(monkeypatch):
    """At 512 px (a 32 x 32 grid, 1024 query tokens against 1024 support
    tokens, heads 256 / 8 = 32 wide) the affinity attention meets the
    route rule: with the device clause set aside on the CPU, both blocks
    go through ``flash_attention`` (the twin on CPU tensors) and the
    logits still match the JAX model."""
    config = dict(TOY, image_embed_dim=32, embed_dim=256, image_size=512,
                  decoder_attention_downsample_rate=1, spatial_convs=None,
                  class_attention=False, example_attention=False)
    batch = _episode(image_size=512, embed_dim=32, num_examples=1,
                     num_classes=2)
    params = _jax_model(config, batch)[1]
    calls = []
    rule = attention.flash_ok

    def on_any_device(device, q_len, k_len, head_dim):
        ok = rule(CUDA, q_len, k_len, head_dim)
        calls.append(((q_len, k_len, head_dim), ok))
        return ok

    monkeypatch.setattr(attention, "flash_ok", on_any_device)
    _, logits, want = _run_both(config, params, batch)
    assert [c for c, ok in calls if ok] == [(1024, 1024, 32)] * 2
    _compare(logits, want, batch)


def test_transformer_feature_size_of_the_grid_is_the_plain_model(toy_params):
    """``transformer_feature_size`` equal to the feature grid (6 at 96 px)
    rescales nothing: the JAX model and the port give the logits of the
    model without it."""
    batch = _episode()
    _, logits, want = _run_both(dict(TOY, transformer_feature_size=6),
                                toy_params, batch)
    _compare(logits, want, batch)
    _, plain, _ = _run_both(TOY, toy_params, batch)
    np.testing.assert_array_equal(logits, plain)


# (d) what the port refuses

def test_affinity_raises():
    """A ``transformer_feature_size`` other than the grid (the JAX fault,
    ROADMAP C3), ``PrototypeAffinity`` at a width whose last up-conv the
    8-way prototype heads do not divide (the JAX decoder asserts it too),
    ``apply_masks`` and ``predict`` against cached class embeddings."""
    batch = _episode()
    la = LabelAnything(dict(TOY, name="lam_no_vit",
                            transformer_feature_size=4), "cpu", seed=0)
    with pytest.raises(NotImplementedError, match="ROADMAP C3"):
        la(batch)
    assert (TOY["embed_dim"] // 8) % 8
    with pytest.raises(ValueError, match="8-way prototype head split"):
        build_from_config(dict(TOY, few_type="PrototypeAffinity"))
    with pytest.raises(NotImplementedError, match="apply_masks"):
        build_from_config(dict(TOY, apply_masks=True))
    with pytest.raises(ValueError, match="class_fusion"):
        build_from_config(dict(TOY, class_fusion="max"))
    la = LabelAnything(dict(TOY, name="lam_no_vit"), "cpu", seed=0)
    support = {k: v[:, 1:] if k in ("embeddings", "dims") else v
               for k, v in batch.items()}
    embs = la.generate_class_embeddings(support)
    with pytest.raises(NotImplementedError, match="whole episode"):
        la.predict(batch, embs)
    # the whole episode through predict is served
    assert la.predict(batch).shape == (2, 3, 96, 96)


def test_affinity_sam_config_builds_at_full_width():
    """The model block of parameters/trainval/other/Affinity/4.2_Affinity_SAM
    .yaml without ``transformer_feature_size``, at full width on the meta
    device: the decoder's attention is the K6 call of the served traffic."""
    import yaml

    path = "parameters/trainval/other/Affinity/4.2_Affinity_SAM.yaml"
    with open(path) as fh:
        block = yaml.safe_load(fh)["parameters"]["model"]
    config = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict)
                  else v[0]) for k, v in block.items()}
    assert config.pop("transformer_feature_size") == 48
    assert config["few_type"] == "Affinity" and config["class_fusion"] == "mul"
    with torch.device("meta"):
        model = build_from_config(config)
    dec = model.mask_decoder
    assert isinstance(dec, AffinityDecoder) and dec.class_fusion == "mul"
    assert len(dec.transformer.layers) == 2 and len(dec.spatial_convs) == 7
    attn = dec.transformer.layers[0].attention.attn
    head_dim = attn.q_proj.out_features // attn.num_heads
    # 4096 query tokens of the 64 x 64 grid against 2 support images
    assert head_dim == 32 and attention.flash_ok(CUDA, 4096, 2 * 4096,
                                                 head_dim)
    assert [getattr(dec, f"up_conv{i}").out_channels for i in range(3)] == [
        256, 128, 64]
