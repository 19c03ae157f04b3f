"""The port's fused TwoWayTransformer (``ops/fused_twoway.py``), its
shared-keys form (``ops/twoway_shared.py``) and the episode-decode model
built on them, against the JAX package on the CPU.

The CUDA kernel cannot run here; what stands in for it is its plain twin
``twoway_plain``, which a CPU tensor takes. It is held against the JAX
Pallas kernel in interpret mode and the JAX module path (sizes of
``tests/test_fused_twoway.py``: 3 instances, 10 x 10 grid, width 64, 4
heads, 12 tokens, MLP 256), the shared-keys form against the JAX blockdiag
path, and a toy ``lam_no_vit`` (6 x 6 grid, width 32) against the JAX model
with and without mask prompts. Inputs are seeded numpy arrays fed to both.
"""

import flax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import labelanything_tpu.ops.fused_twoway as jft
import labelanything_tpu.ops.twoway_blockdiag as jbd
from labelanything_tpu.data.synthetic import random_batch
from labelanything_tpu.models import build_lam as jbl
from labelanything_tpu.models.transformer import TwoWayTransformer as JTwoWay
from labelanything_tpu.typing import BatchKeys, ResultDict
from labelanything_tpu_torch.api import LabelAnything, build_from_config
from labelanything_tpu_torch.models.transformer import TwoWayTransformer
from labelanything_tpu_torch.ops import flash_attention as fa
from labelanything_tpu_torch.ops import fused_twoway as ft
from labelanything_tpu_torch.ops.twoway_shared import twoway_shared
from labelanything_tpu_torch.utils.weights import state_dict_from_jax

B, H, W, D, N, HEADS, MLP = 3, 10, 10, 64, 12, 4, 256
ATOL = 3e-5     # tests/test_fused_twoway.py's own bound, fp32
TOL = dict(rtol=1e-3, atol=5e-4)   # whole-model parity, tests/golden.py


def _jax_modes(fused=False, blockdiag=False):
    """Context of the JAX package's path switches, as its own tests set
    them: the Pallas kernel in interpret mode, the blockdiag path forced on
    the CPU, or neither (the module path)."""
    class Modes:
        def __enter__(self):
            self.old = (jft._ENABLE, jft._INTERPRET, jbd._ENABLE, jbd._FORCE)
            jft._ENABLE = jft._INTERPRET = fused
            jbd._ENABLE = jbd._FORCE = blockdiag

        def __exit__(self, *exc):
            jft._ENABLE, jft._INTERPRET, jbd._ENABLE, jbd._FORCE = self.old

    return Modes()


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    img = (0.5 * rng.standard_normal((B, H, W, D))).astype(np.float32)
    pe = (0.5 * rng.standard_normal((1, H, W, D))).astype(np.float32)
    tok = (0.5 * rng.standard_normal((B, N, D))).astype(np.float32)
    jtr = JTwoWay(depth=2, embedding_dim=D, num_heads=HEADS, mlp_dim=MLP)
    with _jax_modes():
        params = jtr.init(jax.random.key(0), *map(jnp.asarray, (img, pe, tok)))
    flat = flax.traverse_util.flatten_dict(params["params"])
    r2 = np.random.default_rng(1)
    flat = {k: jnp.asarray(0.2 * r2.standard_normal(v.shape), v.dtype)
            for k, v in flat.items()}
    params = {"params": flax.traverse_util.unflatten_dict(flat)}
    ttr = TwoWayTransformer(2, D, HEADS, MLP)
    ttr.load_state_dict(state_dict_from_jax(params), strict=True)
    return jtr, params, ttr, img, pe, tok


def _flat(img, pe, tok):
    """The module's operands as the fused function takes them."""
    t = torch.from_numpy
    return (t(img).reshape(img.shape[0], -1, D), t(tok),
            t(pe).reshape(-1, D))


def _loss(q, k):
    return (q ** 2).sum() + (k ** 2).sum()


# (a) the twin against the JAX kernel (interpret mode) and the JAX module

@pytest.mark.parametrize("mode", ["pallas_interpret", "module"])
def test_twoway_plain_matches_jax(setup, mode):
    jtr, params, ttr, img, pe, tok = setup
    with _jax_modes(fused=mode == "pallas_interpret"):
        q_ref, k_ref = jtr.apply(params, *map(jnp.asarray, (img, pe, tok)))
    keys, queries, key_pe = _flat(img, pe, tok)
    with torch.no_grad():
        q, k = ft.twoway_plain(keys, queries, key_pe, ft.twoway_params(ttr),
                               2, HEADS)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_ref), atol=ATOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(k_ref), atol=ATOL)


# (b) its gradients against jax.grad of the same loss

def test_twoway_gradients_match_jax(setup):
    jtr, params, ttr, img, pe, tok = setup

    def loss(pp):
        q, k = jtr.apply(pp, *map(jnp.asarray, (img, pe, tok)))
        return jnp.sum(jnp.square(q)) + jnp.sum(jnp.square(k))

    with _jax_modes():
        ref = state_dict_from_jax(jax.tree.map(np.asarray,
                                               jax.grad(loss)(params)))
    keys, queries, key_pe = _flat(img, pe, tok)
    ttr.zero_grad()
    _loss(*ft.fused_twoway_transformer(keys, queries, key_pe,
                                       ft.twoway_params(ttr), 2,
                                       HEADS)).backward()
    grads = {name: p.grad for name, p in ttr.named_parameters()}
    assert sorted(grads) == sorted(ref)
    for name, want in ref.items():
        diff = (grads[name] - want).abs().max().item()
        scale = want.abs().max().item()
        # the JAX test's rule; k_proj biases have a true gradient of zero
        assert diff < max(1e-3 * scale, 1e-5), (name, diff, scale)


# (c) the module routed through the function against its module path

def test_module_routes_through_fused_function(setup, monkeypatch):
    _, _, ttr, img, pe, tok = setup
    args = [torch.from_numpy(x) for x in (img, pe, tok)]
    calls = []
    real = ft.FusedTwoWay.apply

    def counted(*a):
        calls.append(1)
        return real(*a)

    outs, grads = [], []
    for routed in (False, True):
        if routed:
            monkeypatch.setattr(ft, "fused_twoway_ok", lambda *a, **k: True)
            monkeypatch.setattr(ft.FusedTwoWay, "apply", counted)
        ttr.zero_grad()
        q, k = ttr(*args)
        _loss(q, k).backward()
        outs.append((q.detach(), k.detach()))
        grads.append({n: p.grad.clone() for n, p in ttr.named_parameters()})
    assert calls == [1]
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for name, want in grads[0].items():
        torch.testing.assert_close(grads[1][name], want, rtol=1e-4,
                                   atol=1e-5, msg=name)
    # inside plain_attention() the module path is taken again
    calls.clear()
    with fa.plain_attention(), torch.no_grad():
        ttr(*args)
    assert not calls


# (d) the autograd function in float64

@pytest.fixture
def one_thread():
    """``gradcheck`` is thousands of tiny ops: with torch's default thread
    count they spend their time contending with the other test workers'
    threads (minutes instead of seconds), so it runs on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_fused_function_gradcheck(one_thread):
    torch.manual_seed(0)
    d, heads, mlp, s, n, g = 8, 2, 16, 4, 2, 2
    tr = TwoWayTransformer(1, d, heads, mlp).double()
    with torch.no_grad():
        for p in tr.parameters():
            p.copy_(0.3 * torch.randn_like(p))
    params = [p.detach().requires_grad_() for p in ft.twoway_params(tr)]
    keys = torch.randn(g, s, d, dtype=torch.float64, requires_grad=True)
    queries = torch.randn(g, n, d, dtype=torch.float64, requires_grad=True)
    pe = torch.randn(s, d, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda k, q, e, *p: ft.fused_twoway_transformer(k, q, e, p, 1, heads),
        (keys, queries, pe, *params))


# (e) the route rule, and no way from a CUDA-typed call to the twin

CUDA = torch.device("cuda")
RULE_CASES = [
    (dict(), True),                                  # the decode path
    (dict(dtype=torch.float32), False),              # the module path
    (dict(tokens=8), True),
    (dict(tokens=1, mlp_dim=64), True),
    (dict(device=torch.device("cpu")), False),
    (dict(dtype=torch.float16), False),
    (dict(dim=512), False),                          # lam_b / lam_l / lam_h
    (dict(heads=4), False),
    (dict(downsample=1), False),
    (dict(tokens=9), False),
    (dict(tokens=0), False),
    (dict(mlp_dim=4096), False),
    (dict(mlp_dim=100), False),
    (dict(act=F.gelu), False),
]


@pytest.mark.parametrize("change,expected", RULE_CASES)
def test_fused_twoway_ok_rule(change, expected):
    case = dict(device=CUDA, dtype=torch.bfloat16, tokens=6, dim=256, heads=8,
                mlp_dim=2048, downsample=2, act=F.relu)
    case.update(change)
    assert ft.fused_twoway_ok(**case) is expected
    # the kernel itself is compiled for fp32 too, for direct parity calls
    assert ft.fused_twoway_compiled(**case) is (
        expected or change == dict(dtype=torch.float32))


def test_fused_cuda_route_never_falls_back():
    """Off the CPU the function launches its kernel or raises: a tensor on
    another device type is refused, and so is a shape the kernel is not
    compiled for; neither reaches the twin."""
    tr = TwoWayTransformer(2, D, HEADS, MLP)
    params = ft.twoway_params(tr)
    keys, queries, pe = (torch.zeros(s, device="meta")
                         for s in ((2, 9, D), (2, 3, D), (9, D)))
    before = fa.LAUNCHES["fused_twoway"]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ft.fused_twoway_transformer(keys, queries, pe, params, 2, HEADS)
    with pytest.raises(ValueError, match="do not fit together"):
        ft.fused_twoway_transformer(keys, queries[:1], pe, params, 2, HEADS)
    with pytest.raises(ValueError, match="parameters"):
        ft.fused_twoway_transformer(keys, queries, pe, params[:-1], 2, HEADS)
    assert fa.LAUNCHES["fused_twoway"] == before
    assert ft.twoway_param_count(2) == len(params) == 82
    # the buffer the fp32 kernel reads holds the matrices transposed
    flat32 = ft.pack_params(params, torch.float32)
    flat16 = ft.pack_params(params, torch.bfloat16)
    assert flat32.shape == flat16.shape and flat16.dtype == torch.bfloat16
    wq = params[0].detach()
    assert torch.equal(flat32[:wq.numel()], wq.t().reshape(-1))
    assert torch.equal(flat16[:wq.numel()], wq.reshape(-1).bfloat16())


# (f), (g) the shift arguments: expanded, rank 1 and rank 16

def _shift_case(setup, group, with_map, seed):
    _, _, ttr, img, pe, _ = setup
    rng = np.random.default_rng(seed)
    g = B * group
    mk = lambda *s: (0.3 * rng.standard_normal(s)).astype(np.float32)
    shift, smap, proj = mk(g, D), mk(g, H, W, 16), mk(16, D)
    tok = (0.5 * rng.standard_normal((g, N, D))).astype(np.float32)
    if not with_map:
        smap = proj = None
    full = np.repeat(img, group, axis=0) + shift[:, None, None, :]
    if with_map:
        full = full + smap @ proj
    return shift, smap, proj, tok, full


def _shift_args(shift, smap, proj, conv=torch.from_numpy):
    out = dict(image_shift=conv(shift))
    if smap is not None:
        out.update(image_shift_map=conv(smap), image_shift_proj=conv(proj))
    return out


@pytest.mark.parametrize("shared", [False, True], ids=["expanded", "shared"])
@pytest.mark.parametrize("with_map", [False, True], ids=["rank1", "rank16"])
def test_shift_arguments_match_expanded_keys(setup, with_map, shared,
                                             monkeypatch):
    _, _, ttr, img, pe, _ = setup
    shift, smap, proj, tok, full = _shift_case(setup, 4, with_map, seed=5)
    t = torch.from_numpy
    monkeypatch.setattr(ttr, "shared_keys", shared)
    with torch.no_grad():
        q_ref, k_ref = ttr(t(full), t(pe), t(tok))
        q, k = ttr(t(img), t(pe), t(tok), **_shift_args(shift, smap, proj))
    torch.testing.assert_close(q, q_ref, rtol=0, atol=ATOL)
    torch.testing.assert_close(k, k_ref, rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="divisible"):
        ttr(t(np.concatenate([img, img[:2]])), t(pe), t(tok),
            image_shift=t(shift))


@pytest.mark.parametrize("with_map", [False, True], ids=["rank1", "rank16"])
def test_shared_keys_match_jax_blockdiag(setup, with_map):
    jtr, params, ttr, img, pe, _ = setup
    shift, smap, proj, tok, _ = _shift_case(setup, 4, with_map, seed=9)
    with _jax_modes(blockdiag=True):
        q_ref, k_ref = jtr.apply(
            params, jnp.asarray(img), jnp.asarray(pe), jnp.asarray(tok),
            **_shift_args(shift, smap, proj, jnp.asarray))
    t = torch.from_numpy
    with torch.no_grad():
        q, k = twoway_shared(
            t(img).reshape(B, -1, D), t(tok), t(pe).reshape(-1, D),
            ft.twoway_params(ttr), 2, HEADS, t(shift),
            None if smap is None else t(smap).reshape(len(tok), -1, 16),
            None if proj is None else t(proj))
    np.testing.assert_allclose(q.numpy(), np.asarray(q_ref), atol=ATOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(k_ref), atol=ATOL)


@pytest.mark.parametrize("with_map", [False, True], ids=["rank1", "rank16"])
def test_shared_keys_gradients_match_expanded(setup, with_map, monkeypatch):
    _, _, ttr, img, pe, _ = setup
    shift, smap, proj, tok, full = _shift_case(setup, 2, with_map, seed=7)
    t = torch.from_numpy
    grads = []
    for shared in (False, True):
        monkeypatch.setattr(ttr, "shared_keys", shared)
        ttr.zero_grad()
        base = t(img).requires_grad_()
        kwargs = {k: v.requires_grad_()
                  for k, v in _shift_args(shift, smap, proj).items()}
        _loss(*ttr(base, t(pe), t(tok), **kwargs)).backward()
        grads.append(dict({n: p.grad.clone()
                           for n, p in ttr.named_parameters()},
                          base=base.grad, **{k: v.grad
                                             for k, v in kwargs.items()}))
    for name, want in grads[0].items():
        diff = (grads[1][name] - want).abs().max().item()
        scale = want.abs().max().item()
        assert diff < max(1e-3 * scale, 1e-5), (name, diff, scale)


# (h) the whole decode model at toy size against the JAX model

TOY = dict(image_embed_dim=48, embed_dim=32, image_size=96, spatial_convs=3,
           class_attention=False, example_attention=False,
           example_class_attention=True,
           class_encoder={"name": "RandomMatrixEncoder", "bank_size": 10})


def _episode(include_masks):
    return random_batch(batch_size=2, num_examples=2, num_classes=3,
                        image_size=96, embed_dim=48, seed=3,
                        include_masks=include_masks)


@pytest.fixture(scope="module")
def decode_models():
    jm = jbl.build_lam_no_vit(**TOY)
    batch = jax.tree.map(jnp.asarray, _episode(True))
    params = jax.jit(jm.init)(jax.random.key(0), batch)
    return jm, params


@pytest.mark.parametrize("shared_keys", [False, True],
                         ids=["expanded", "shared"])
@pytest.mark.parametrize("include_masks", [True, False],
                         ids=["masks", "no_masks"])
def test_lam_no_vit_matches_jax(decode_models, include_masks, shared_keys):
    jm, params = decode_models
    batch = _episode(include_masks)
    ref = jax.jit(jm.apply)(params, jax.tree.map(jnp.asarray, batch))
    la = LabelAnything.from_jax_params(
        dict(TOY, name="lam_no_vit", shared_keys=shared_keys), params, "cpu")
    assert la.model.prompt_encoder.transformer.shared_keys is shared_keys
    out = la(batch)
    logits = out[ResultDict.LOGITS].numpy()
    want = np.asarray(ref[ResultDict.LOGITS])
    assert logits.shape == (2, 3, 96, 96)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(logits), finite)
    np.testing.assert_allclose(logits[finite], want[finite], **TOL)
    np.testing.assert_allclose(
        out[ResultDict.EXAMPLES_CLASS_EMBS].numpy(),
        np.asarray(ref[ResultDict.EXAMPLES_CLASS_EMBS]), **TOL)
    # the split entry points give the whole forward's logits
    support = {k: v[:, 1:] if k in (BatchKeys.EMBEDDINGS, BatchKeys.DIMS)
               else v for k, v in batch.items()}
    embs = la.generate_class_embeddings(support)
    np.testing.assert_allclose(la.predict(batch, embs).numpy()[finite],
                               logits[finite], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("include_masks", [True, False],
                         ids=["masks", "no_masks"])
@pytest.mark.parametrize("option", ["structured_fusion", "mask_factor"])
def test_fusion_forms_agree(option, include_masks):
    """The prompt encoder's opt-outs give the structured paths' logits."""
    batch = _episode(include_masks)
    config = dict(TOY, name="lam_no_vit")
    ref = LabelAnything(config, "cpu", seed=3).predict(batch).numpy()
    out = LabelAnything(dict(config, **{option: False}), "cpu",
                        seed=3).predict(batch).numpy()
    finite = np.isfinite(ref)
    np.testing.assert_allclose(out[finite], ref[finite], rtol=1e-4, atol=1e-4)


def test_mae_yaml_model_block_builds():
    """The model block of parameters/trainval/coco20i/mae.yaml, verbatim,
    builds the decode model at full width."""
    import yaml

    with open("parameters/trainval/coco20i/mae.yaml") as fh:
        block = yaml.safe_load(fh)["parameters"]["model"]
    config = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict)
                  else v[0]) for k, v in block.items()}
    assert config["name"] == "lam_no_vit"
    with torch.device("meta"):
        model = build_from_config(config)
    assert model.image_encoder is None and model.neck is not None
    tr = model.prompt_encoder.transformer
    assert tr.compute_dtype == torch.bfloat16
    assert ft.fused_twoway_ok(CUDA, tr.compute_dtype, 6, tr.embedding_dim,
                              tr.num_heads, tr.mlp_dim,
                              tr.attention_downsample_rate)
    assert len(ft.twoway_params(model.mask_decoder.transformer)) == 82
    assert len(model.mask_decoder.spatial_convs) == 7
    assert model.prompt_encoder.class_encoder.bank_size == 100


def test_packed_params_follow_the_weights():
    """The packed buffer is kept while the weights stand and rebuilt when
    one is written in place, reloaded or moved."""
    tr = TwoWayTransformer(2, D, HEADS, MLP)
    first = ft.packed_params(ft.twoway_params(tr), torch.bfloat16)
    assert ft.packed_params(ft.twoway_params(tr), torch.bfloat16) is first
    assert ft.packed_params(ft.twoway_params(tr), torch.float32) is not first
    with torch.no_grad():
        tr.layers[1].mlp.lin2.bias.add_(1.0)
    second = ft.packed_params(ft.twoway_params(tr), torch.bfloat16)
    assert second is not first and not torch.equal(second, first)
    assert torch.equal(second, ft.pack_params(ft.twoway_params(tr),
                                              torch.bfloat16))
    tr.load_state_dict({k: v + 1 for k, v in tr.state_dict().items()})
    third = ft.packed_params(ft.twoway_params(tr), torch.bfloat16)
    assert torch.equal(third, ft.pack_params(ft.twoway_params(tr),
                                             torch.bfloat16))
    assert not torch.equal(third, second)
