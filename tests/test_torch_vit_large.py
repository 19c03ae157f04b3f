"""The port's ViT-L / ViT-H path against the JAX package's, on the CPU.

ViT-H's heads are 80 wide, so every attention block runs the packed rel-pos
function (``flash_attention_relpos_packed``). On the CPU the port takes its
plain twin; it is held against the JAX Pallas kernel in interpret mode (256-
row blocks, as the JAX package's own tests run it) and against the JAX plain
reference ``_packed_xla_ref``. The encoder, the serving slice and one train
step are held against the JAX modules at a toy ViT-H shape: 112 px (a 7 x 7
grid), embed 160 with 2 heads of 80, 2 blocks, block 0 windowed and block
1 global, window 3 (windows pad 7 -> 9). Inputs come from seeded numpy
arrays fed to both sides; the weights are seeded fills of the JAX init's
tree (``jax.eval_shape``), the relative-position tables nonzero.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from labelanything_tpu.data.synthetic import random_batch
from labelanything_tpu.models import build_encoder as jbe
from labelanything_tpu.models import build_lam as jbl
from labelanything_tpu.models import image_encoder as jie
from labelanything_tpu.ops import flash_attention as jfa
from labelanything_tpu.parallel import train_step as jts
from labelanything_tpu.train import losses as jl
from labelanything_tpu.train import optim as jo
from labelanything_tpu.typing import ResultDict
from labelanything_tpu_torch import api
from labelanything_tpu_torch.data.synthetic import random_full_batch
from labelanything_tpu_torch.models import build_encoder as tbe
from labelanything_tpu_torch.models import build_lam as tbl
from labelanything_tpu_torch.models import image_encoder as tie
from labelanything_tpu_torch.models.registry import model_registry
from labelanything_tpu_torch.ops import flash_attention as tfa
from labelanything_tpu_torch.parallel.train_step import (init_train_state,
                                                         make_train_step)
from labelanything_tpu_torch.train import losses as tl
from labelanything_tpu_torch.train.substitutor import Substitutor
from labelanything_tpu_torch.utils.weights import (init_weights,
                                                   state_dict_from_jax)
from tests.test_torch_baselines import jax_init
from tests.test_torch_image_encoder import nonzero_rel_pos
from tests.test_torch_lam import _assert_logits_close, _support, _t
from tests.test_torch_ops import _pallas_interpret
from tests.test_torch_train import _assert_adamw_close
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-3, atol=5e-4)   # tests/golden.py:165
TOY_VIT_H = dict(img_size=112, patch_size=16, embed_dim=160, depth=2,
                 num_heads=2, window_size=3, global_attn_indexes=(1,),
                 out_chans=32)
TOY_LAM_H = dict(use_vit_sam_neck=False, image_embed_dim=160, embed_dim=64,
                 image_size=112, spatial_convs=3, class_attention=False,
                 example_attention=True, example_class_attention=False,
                 class_encoder={"name": "RandomMatrixEncoder", "bank_size": 10})
LR = 5e-5


def _packed_inputs(b, grid_hw, heads, dh, seed):
    kh, kw = grid_hw
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, 3 * heads, kh * kw, dh)).astype(np.float32)
    r = rng.standard_normal((b, heads, kh * kw, kh + kw)).astype(np.float32)
    return qkv, r


PACKED_CASES = [
    # (batch, grid_hw, heads, dh): global grids, then windows
    (1, (16, 48), 2, 80),
    (1, (48, 16), 1, 64),
    (2, (48, 16), 3, 16),
    (4, (14, 14), 2, 80),
    (3, (14, 14), 3, 64),
    (4, (7, 7), 1, 80),
    (2, (7, 7), 2, 16),
]


@pytest.mark.parametrize("b,grid_hw,heads,dh", PACKED_CASES)
def test_packed_plain_twin_matches_jax(b, grid_hw, heads, dh):
    """rtol = atol = 2e-5, the JAX package's own tolerance for this kernel
    against its plain reference (fp32, sums in another order)."""
    qkv, r = _packed_inputs(b, grid_hw, heads, dh, seed=7)
    scale = dh ** -0.5
    ours = tfa.flash_attention_relpos_packed(
        torch.from_numpy(qkv), torch.from_numpy(r), scale, grid_hw, heads)
    assert tuple(ours.shape) == (b, heads, grid_hw[0] * grid_hw[1], dh)
    kernel = _pallas_interpret(jfa.flash_attention_relpos_packed,
                               jnp.asarray(qkv), jnp.asarray(r), scale,
                               grid_hw, heads)
    ref = np.asarray(jfa._packed_xla_ref(jnp.asarray(qkv), jnp.asarray(r),
                                         scale, grid_hw, heads))
    np.testing.assert_allclose(ours.numpy(), kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,grid_hw,heads,dh", [(2, (4, 4), 2, 8),
                                                (1, (7, 7), 2, 80),
                                                (1, (6, 20), 1, 80)])
def test_packed_plain_backward_matches_jax(b, grid_hw, heads, dh):
    """The port's backward of the packed function (the plain formulas on
    any device) against ``jax.vjp`` of ``_packed_xla_ref``, which is the JAX
    package's backward for this layout; rtol = atol = 2e-5 as its test."""
    qkv, r = _packed_inputs(b, grid_hw, heads, dh, seed=8)
    ct = np.random.default_rng(9).standard_normal(
        (b, heads, qkv.shape[2], dh)).astype(np.float32)
    scale = dh ** -0.5
    ref = jax.vjp(lambda a, c: jfa._packed_xla_ref(a, c, scale, grid_hw,
                                                   heads),
                  jnp.asarray(qkv), jnp.asarray(r))[1](jnp.asarray(ct))
    tq = torch.tensor(qkv, requires_grad=True)
    tr = torch.tensor(r, requires_grad=True)
    out = tfa.flash_attention_relpos_packed(tq, tr, scale, grid_hw, heads)
    ours = torch.autograd.grad(out, (tq, tr), torch.from_numpy(ct))
    twin = tfa.relpos_packed_bwd_plain(tq.detach(), tr.detach(), out.detach(),
                                       torch.from_numpy(ct), scale, grid_hw,
                                       heads)
    for mine, same, x in zip(ours, twin, ref):
        assert torch.equal(mine, same)
        assert np.abs(np.asarray(x)).max() > 1e-2
        np.testing.assert_allclose(mine.numpy(), np.asarray(x), rtol=2e-5,
                                   atol=2e-5)


def test_packed_autograd_function():
    """``gradcheck`` in fp64 on a tiny case, and in fp32 the same gradients
    as autograd through the plain forward (1e-5: explicit formulas against
    PyTorch's), with a strided cotangent."""
    grid_hw, heads, dh = (2, 3), 2, 8
    rng = np.random.default_rng(3)
    qkv = rng.standard_normal((1, 3 * heads, 6, dh))
    r = rng.standard_normal((1, heads, 6, 5))
    args = (0.3, grid_hw, heads)
    assert torch.autograd.gradcheck(
        lambda a, c: tfa.RelposPackedAttention.apply(a, c, *args),
        (torch.tensor(qkv, requires_grad=True),
         torch.tensor(r, requires_grad=True)))
    ct = torch.tensor(rng.standard_normal((1, heads, 6, dh)),
                      dtype=torch.float32)
    wide = torch.stack([ct, ct], dim=-1)[..., 0]
    grads = []
    for fn in (tfa.flash_attention_relpos_packed, tfa.relpos_packed_plain):
        q32 = torch.tensor(qkv, dtype=torch.float32, requires_grad=True)
        r32 = torch.tensor(r, dtype=torch.float32, requires_grad=True)
        grads.append(torch.autograd.grad(fn(q32, r32, *args), (q32, r32),
                                         wide))
    for mine, auto in zip(*grads):
        torch.testing.assert_close(mine, auto, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("grid_hw,dh", [((14, 14), 80), ((48, 16), 16)])
def test_unpacked_relpos_matches_jax(grid_hw, dh):
    """``flash_attention_relpos`` (q, k, v apart, unscaled rel_h / rel_w)
    against the JAX one in interpret mode and its plain reference, forward
    (2e-5) and gradients (1e-4: five outputs through one more layer of
    layout code)."""
    kh, kw = grid_hw
    bh, n = 3, kh * kw
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((bh, n, dh)).astype(np.float32)
               for _ in range(3))
    rel_h = rng.standard_normal((bh, n, kh)).astype(np.float32)
    rel_w = rng.standard_normal((bh, n, kw)).astype(np.float32)
    ct = rng.standard_normal((bh, n, dh)).astype(np.float32)
    scale = dh ** -0.5
    arrays = (q, k, v, rel_h, rel_w)
    kernel = _pallas_interpret(jfa.flash_attention_relpos,
                               *map(jnp.asarray, arrays), scale, grid_hw)
    ref, vjp = jax.vjp(
        lambda *a: jfa._relpos_xla_ref(*a, scale, grid_hw),
        *map(jnp.asarray, arrays))
    ts = [torch.tensor(x, requires_grad=True) for x in arrays]
    ours = tfa.flash_attention_relpos(*ts, scale, grid_hw)
    assert tuple(ours.shape) == (bh, n, dh)
    np.testing.assert_allclose(ours.detach().numpy(), kernel, rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)
    grads = torch.autograd.grad(ours, ts, torch.from_numpy(ct))
    for mine, x in zip(grads, vjp(jnp.asarray(ct))):
        np.testing.assert_allclose(mine.numpy(), np.asarray(x), rtol=1e-4,
                                   atol=1e-4)
    with pytest.raises(ValueError, match="share one shape"):
        tfa.flash_attention_relpos(ts[0], ts[1][:, :-1], ts[2], ts[3], ts[4],
                                   scale, grid_hw)


def test_packed_strided_view_equals_contiguous():
    """The encoder hands the packed function a token-major view of the qkv
    projection; it gives the bits of the contiguous slot-major tensor."""
    b, heads, dh, grid_hw = 2, 2, 80, (7, 7)
    n = 49
    rng = np.random.default_rng(11)
    proj = torch.from_numpy(rng.standard_normal(
        (b, n, 3 * heads * dh)).astype(np.float32))
    r_tok = torch.from_numpy(rng.standard_normal(
        (b, n, heads, 14)).astype(np.float32))
    view = proj.view(b, n, 3 * heads, dh).permute(0, 2, 1, 3)
    r_view = r_tok.permute(0, 2, 1, 3)
    assert tfa._token_major(view) and not view.is_contiguous()
    assert not tfa._token_major(view.contiguous())
    args = (dh ** -0.5, grid_hw, heads)
    strided = tfa.flash_attention_relpos_packed(view, r_view, *args)
    dense = tfa.flash_attention_relpos_packed(view.contiguous(),
                                              r_view.contiguous(), *args)
    assert torch.equal(strided, dense)


def test_packed_cuda_route_never_falls_back():
    """Off the CPU the packed wrapper launches its kernel or raises; a head
    width the kernels were not compiled for raises too."""
    qkv, r = _packed_inputs(1, (4, 4), 2, 80, seed=0)
    qkv, r = torch.from_numpy(qkv).to("meta"), torch.from_numpy(r).to("meta")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tfa.flash_attention_relpos_packed(qkv, r, 0.1, (4, 4), 2)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tfa.flash_attention_relpos(qkv[:, 0], qkv[:, 1], qkv[:, 2],
                                   r[:, 0, :, :4], r[:, 0, :, 4:], 0.1,
                                   (4, 4))
    assert tfa.PACKED_HEAD_DIMS == (64, 80)
    assert {"relpos_packed_global", "relpos_packed_window"} <= set(
        tfa.LAUNCHES)


@pytest.mark.parametrize("grid_hw,kernel", [
    ((14, 14), "relpos_packed_window"),
    ((7, 7), "relpos_packed_window"),
    ((16, 16), "relpos_packed_window"),
    ((3, 3), "relpos_packed_window"),
    ((4, 20), "relpos_packed_global"),    # N <= 256, a row past 16 slots
    ((17, 17), "relpos_packed_global"),
    ((64, 64), "relpos_packed_global"),
])
def test_packed_route_by_grid(grid_hw, kernel):
    """The packed route takes the windowed kernel exactly for the grids
    ``window_grid_ok`` admits with N <= 256, the global kernel otherwise."""
    n = grid_hw[0] * grid_hw[1]
    assert tfa.packed_route(n, grid_hw) == kernel
    assert (kernel == "relpos_packed_window") == (
        n <= 256 and tfa.window_grid_ok(grid_hw))


def test_packed_wrapper_rejects_bad_shapes():
    qkv, r = _packed_inputs(1, (4, 4), 2, 16, seed=0)
    qkv, r = torch.from_numpy(qkv), torch.from_numpy(r)
    fn = tfa.flash_attention_relpos_packed
    with pytest.raises(ValueError, match="slots"):
        fn(qkv[:, :5], r, 0.25, (4, 4), 2)
    with pytest.raises(ValueError, match="kh \\* kw"):
        fn(qkv, r, 0.25, (4, 5), 2)
    with pytest.raises(ValueError, match="r must be"):
        fn(qkv, r[..., :7], 0.25, (4, 4), 2)
    with pytest.raises(ValueError, match="4-D"):
        fn(qkv[0], r[0], 0.25, (4, 4), 2)
    with pytest.raises(TypeError):
        fn(qkv.double(), r.double(), 0.25, (4, 4), 2)
    with pytest.raises(TypeError):
        fn(qkv, r.bfloat16(), 0.25, (4, 4), 2)


def test_plain_attention_covers_the_packed_function():
    assert not tfa._plain_requested
    qkv, r = _packed_inputs(1, (3, 3), 1, 16, seed=1)
    with tfa.plain_attention():
        inside = tfa.flash_attention_relpos_packed(
            torch.from_numpy(qkv), torch.from_numpy(r), 0.25, (3, 3), 1)
    ref = tfa.relpos_packed_plain(torch.from_numpy(qkv), torch.from_numpy(r),
                                  0.25, (3, 3), 1)
    assert torch.equal(inside, ref) and not tfa._plain_requested


# ---- the encoder ------------------------------------------------------------

def _jax_vit_h(project_last_hidden=True, dtype=jnp.float32, remat=False,
               **overrides):
    return jie.ImageEncoderViT(
        use_rel_pos=True, project_last_hidden=project_last_hidden,
        dtype=dtype, remat=remat, **dict(TOY_VIT_H, **overrides))


def _port_vit_h(project_last_hidden=True, image_size=None,
                dtype=torch.float32, remat=False, **overrides):
    return tie.ImageEncoderViT(
        project_last_hidden=project_last_hidden, dtype=dtype, remat=remat,
        **dict(TOY_VIT_H, **overrides))


def test_vit_attention_matches_jax_at_head_width_80():
    """One attention module, global and windowed token counts."""
    for grid in (7, 3):
        x = np.random.default_rng(grid).standard_normal(
            (2, grid, grid, 160)).astype(np.float32)
        jm = jie.ViTAttention(dim=160, num_heads=2, use_rel_pos=True,
                              input_size=(grid, grid))
        params = nonzero_rel_pos(jm.init(jax.random.key(0), jnp.asarray(x)))
        ref = np.asarray(jm.apply(params, jnp.asarray(x)))
        tm = tie.ViTAttention(160, 2, True, (grid, grid), windowed=grid == 3)
        tm.load_state_dict(state_dict_from_jax(params), strict=True)
        with torch.no_grad():
            ours = tm(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(ours, ref, **TOL)


@pytest.mark.parametrize("neck", [False, True])
@pytest.mark.parametrize("window", [3, 7])
def test_image_encoder_matches_jax_at_head_width_80(neck, window):
    x = np.random.default_rng(2).standard_normal((2, 112, 112, 3)).astype(
        np.float32)
    jm = _jax_vit_h(neck, window_size=window)
    params = nonzero_rel_pos(jax_init(jm, jnp.asarray(x)))
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    tm = _port_vit_h(neck, window_size=window)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        ours = tm(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == ((2, 7, 7, 32) if neck
                                       else (2, 7, 7, 160))
    np.testing.assert_allclose(ours, ref, **TOL)


@pytest.mark.parametrize("name,embed,depth,heads,global_at", [
    ("vit_l", 1024, 24, 16, (5, 11, 17, 23)),
    ("vit_h", 1280, 32, 16, (7, 15, 23, 31)),
])
def test_vit_large_layouts_match_jax(name, embed, depth, heads, global_at):
    """ViT-L / ViT-H at 1024 px: built on the meta device and traced
    abstractly on the JAX side (no memory, no compute); every parameter's
    name and shape through ``state_dict_from_jax``."""
    with torch.device("meta"):
        vit = tbe.ENCODERS[name]()
    assert tbe.vit_configs == jbe.vit_configs
    tree = jax.eval_shape(jbe.ENCODERS[name]().init, jax.random.key(0),
                          jax.ShapeDtypeStruct((1, 1024, 1024, 3),
                                               jnp.float32))["params"]
    ours = {k: tuple(v.shape) for k, v in vit.state_dict().items()}
    # names and shapes through the weight map, on one block of each kind
    # and everything outside the blocks (the only arrays made real here)
    templates = {False: "blocks_0", True: f"blocks_{global_at[0]}"}
    kept = {k: v for k, v in tree.items()
            if not k.startswith("blocks_") or k in templates.values()}
    ref = state_dict_from_jax(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), kept))
    for key, value in ref.items():
        assert ours[key] == tuple(value.shape), key
    # every other block has the shapes of its kind's template, on both sides
    shapes_of = lambda t: jax.tree.map(lambda s: s.shape, t)
    for i in range(depth):
        template = templates[i in global_at]
        assert shapes_of(tree[f"blocks_{i}"]) == shapes_of(tree[template])
        prefix = template.replace("_", ".") + "."
        for key, shape in ours.items():
            if key.startswith(prefix):
                assert ours[f"blocks.{i}." + key[len(prefix):]] == shape, key
    assert len(ours) == len(ref) + (depth - 2) * sum(
        k.startswith("blocks.0.") for k in ours)
    assert sum(int(np.prod(s)) for s in ours.values()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(tree))
    dh = embed // heads
    assert vit.pos_embed.shape == (1, 64, 64, embed)
    assert len(vit.blocks) == depth
    assert tuple(i for i, b in enumerate(vit.blocks)
                 if b.window_size == 0) == global_at
    assert vit.blocks[global_at[0]].attn.rel_pos_h.shape == (127, dh)
    assert vit.blocks[0].attn.rel_pos_w.shape == (27, dh)
    assert vit.blocks[0].attn.num_heads == heads
    assert (dh == tfa.KERNEL_HEAD_DIM) == (name == "vit_l")
    assert dh in tfa.PACKED_HEAD_DIMS


def test_registry_covers_the_large_encoders(monkeypatch):
    # the JAX registry's names but item 7's of ROADMAP A13, and, as there,
    # the encoders
    assert {"lam", "lam_no_vit", "lam_b", "lam_l", "lam_h", "lam_mae_b",
            "lam_dino_b8", "lam_b_imagenet_i21k", "multilevel_lam",
            "similarity", "panet", "ppnet", "denet", "bam", "hdmnet", "dcama",
            "fptrans"} | set(tbe.ENCODERS) == set(model_registry)
    assert sorted(tbe.ENCODERS) == [
        "mit_b0", "nvidia/segformer-b0-finetuned-ade-512-512", "resnet50",
        "swin_b", "vit_b", "vit_b_imagenet_i21k", "vit_b_mae", "vit_dino_b8",
        "vit_h", "vit_l"]
    for name, factory in (("lam_l", "build_vit_l"), ("lam_h", "build_vit_h")):
        seen = {}

        def toy(project_last_hidden, image_size, dtype, remat=False,
                _seen=seen):
            _seen.update(remat=remat, image_size=image_size)
            return _port_vit_h(project_last_hidden, dtype=dtype, remat=remat)

        monkeypatch.setattr(tbl, factory, toy)
        with torch.device("meta"):
            model = api.build_from_config(dict(TOY_LAM_H, name=name,
                                               remat_encoder="full"))
        assert seen == dict(remat="full", image_size=112)
        assert model.image_encoder.remat and model.neck is not None
    with pytest.raises(ValueError, match="unknown model"):
        api.build_from_config(dict(TOY_LAM_H, name="lam_x"))


def test_seeded_init_fills_wide_rel_pos_tables():
    """``init_weights`` on a ViT-H-shaped encoder: the (2 * 14 - 1, 80) and
    (2 * 7 - 1, 80) tables get nonzero values, and the same seed gives the
    same weights."""
    a, b = (_port_vit_h(window_size=14, img_size=112) for _ in range(2))
    init_weights(a, 3)
    init_weights(b, 3)
    for key, value in a.state_dict().items():
        assert torch.equal(value, b.state_dict()[key]), key
    assert a.blocks[0].attn.rel_pos_h.shape == (27, 80)
    assert a.blocks[1].attn.rel_pos_w.shape == (13, 80)
    for block in a.blocks:
        assert block.attn.rel_pos_h.abs().min() > 0
        assert block.attn.rel_pos_w.abs().min() > 0


# ---- the slice as a whole ----------------------------------------------------

def _episode_h():
    return random_batch(batch_size=2, num_examples=2, num_classes=3,
                        image_size=112, with_images=True, seed=3)


@pytest.fixture(scope="module")
def lam_h():
    jm = jbl._build_lam(build_vit=_jax_vit_h, **TOY_LAM_H)
    batch = jax.tree.map(jnp.asarray, _episode_h())
    params = nonzero_rel_pos(jax_init(jm, batch))
    tm = tbl._build_lam(build_vit=_port_vit_h, **TOY_LAM_H).eval()
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, tm


def test_lam_h_forward_matches_jax(lam_h):
    jm, params, tm = lam_h
    batch = _episode_h()
    ref = jax.jit(jm.apply)(params, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        ours = tm(_t(batch))
    assert ours[ResultDict.LOGITS].shape == (2, 3, 112, 112)
    _assert_logits_close(ours[ResultDict.LOGITS].numpy(),
                         ref[ResultDict.LOGITS])
    np.testing.assert_allclose(
        ours[ResultDict.EXAMPLES_CLASS_EMBS].numpy(),
        np.asarray(ref[ResultDict.EXAMPLES_CLASS_EMBS]), **TOL)


def test_lam_h_serving_split_matches_jax(lam_h, monkeypatch):
    jm, params, tm = lam_h
    batch = _episode_h()
    support = _support(batch)
    ref_embs = jax.jit(functools.partial(
        jm.apply, method="generate_class_embeddings"))(
            params, jax.tree.map(jnp.asarray, support))
    ref = jax.jit(functools.partial(jm.apply, method="predict"))(
        params, jax.tree.map(jnp.asarray, batch), ref_embs)
    # through the public API, the toy encoder standing in for ViT-H
    monkeypatch.setattr(tbl, "build_vit_h", _port_vit_h)
    la = api.LabelAnything.from_jax_params(dict(TOY_LAM_H, name="lam_h"),
                                           params, "cpu")
    embs = la.generate_class_embeddings(support)
    np.testing.assert_allclose(embs[ResultDict.CLASS_EMBS].numpy(),
                               np.asarray(ref_embs[ResultDict.CLASS_EMBS]),
                               **TOL)
    _assert_logits_close(la.predict(batch, embs).numpy(), ref)


def _train_episode():
    full = random_full_batch(batch_size=2, num_examples=2, num_classes=2,
                             image_size=112, with_images=True, seed=5)
    sub = Substitutor(num_points=1, substitute=False)
    sub.reset({k: torch.as_tensor(np.asarray(v)) for k, v in full.items()})
    return next(sub)


def test_lam_h_train_step_matches_jax(monkeypatch):
    """One fp32 train step of the toy ``lam_h`` (encoder trainable, focal
    loss, AdamW): loss to 1e-5 relative, every gradient within 1e-3 of its
    tensor's largest element plus 1e-8, parameters after the update as
    ``test_torch_train.py`` holds them for the ViT-B shape. The backward of
    the packed attention is the plain one on both sides."""
    batch, gt = _train_episode()
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jgt = jnp.asarray(gt.numpy())
    model = jbl._build_lam(build_vit=_jax_vit_h, **TOY_LAM_H)
    loss = jl.LabelAnythingLoss(components={"focal": {"weight": 1.0}},
                                class_weighting=True)
    params = {"model": nonzero_rel_pos(jax_init(model, jbatch)), "loss": {}}
    params0 = jax.tree.map(np.asarray, params)
    tx = jo.build_optimizer(params, name="AdamW", learning_rate=LR)
    step = jts.make_train_step(model, loss, tx)
    state = jts.init_train_state(jax.tree.map(jnp.asarray, params0), tx)
    # two accumulation passes scaled by 0.5: 0.5 g + 0.5 g is g exactly
    state, aux = step(state, jbatch, jgt, jax.random.key(7), 0.5,
                      apply_update=False)
    ref_grads = state_dict_from_jax(jax.tree.map(np.asarray,
                                                 state.accum)["model"])
    state, _ = step(state, jbatch, jgt, jax.random.key(7), 0.5,
                    apply_update=True)
    ref_after = state_dict_from_jax(jax.tree.map(np.asarray,
                                                 state.params)["model"])
    bank = ref_grads["prompt_encoder.class_encoder.pos_embedding"].numpy()[0, 0]
    rows = tuple(int(i) for i in np.nonzero(np.abs(bank).sum(axis=-1))[0])
    assert len(rows) == 2 and rows[0] == 0, rows

    # the port builds lam_h from a config, the toy encoder in ViT-H's place
    monkeypatch.setattr(tbl, "build_vit_h", _port_vit_h)
    t_loss = tl.LabelAnythingLoss({"focal": {"weight": 1.0}},
                                  class_weighting=True)
    t_state = init_train_state(dict(TOY_LAM_H, name="lam_h"), t_loss, "cpu",
                               seed=None, name="AdamW", learning_rate=LR)
    before = state_dict_from_jax(params0["model"])
    t_state.model.load_state_dict(before, strict=True)
    t_state.model.prompt_encoder.class_encoder.rows = rows
    t_step = make_train_step()
    t_state, t_aux = t_step(t_state, batch, gt, None, 0.5,
                            apply_update=False)
    np.testing.assert_allclose(float(t_aux["loss"]), float(aux["loss"]),
                               rtol=1e-5)
    grads = {}
    for key, param in t_state.model.named_parameters():
        ref = ref_grads[key].numpy()
        got = np.zeros_like(ref) if param.grad is None else param.grad.numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-3 * np.abs(ref).max() + 1e-8,
                                   err_msg=key)
        grads[key] = 2.0 * torch.as_tensor(ref)
    for block in range(TOY_VIT_H["depth"]):      # fed by dr alone
        for name in ("rel_pos_h", "rel_pos_w"):
            key = f"image_encoder.blocks.{block}.attn.{name}"
            assert np.abs(ref_grads[key].numpy()).max() > 0, key
    t_state, _ = t_step(t_state, batch, gt, None, 0.5, apply_update=True)
    assert t_state.step == 1
    _assert_adamw_close(t_state, before, ref_after, grads)
