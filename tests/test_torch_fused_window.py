"""The two opt-in kernels of the SAM encoder's serving path against the JAX
package, on the CPU: the fused windowed block (``ops/fused_window.py``,
K8) and the int8 score branch of the global rel-pos kernel (K1).

* K8's plain twin against the JAX ``_fused_window_xla_ref``; a toy encoder
  with ``fused_window=True`` against the JAX encoder's unfused path, at a
  weight scale where the JAX Pallas body's softmax shift underflows
  (ROADMAP C7), so the port is held to the function; the same toy against
  the JAX fused path in interpret mode where that shift is sound; the
  gradients against ``jax.grad`` through the JAX fused function (its
  custom_vjp recomputes the XLA reference).
* The int8 twin against the JAX ``_lanes_fwd_impl`` in interpret mode with
  ``LA_TPU_INT8_SCORES`` set (both quantize alike), the flag's rule, and the
  gradient against ``jax.grad`` through ``flash_attention_relpos_lanes``.
* Route rules, the builders' arguments, and the parameter tree.

Inputs come from numpy seeds; both options default to off.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from labelanything_tpu.models import image_encoder as jie
from labelanything_tpu.ops import flash_attention as jfa
from labelanything_tpu.ops import fused_window as jfw
from labelanything_tpu_torch.api import build_from_config
from labelanything_tpu_torch.models import image_encoder as tie
from labelanything_tpu_torch.models.build_encoder import (build_vit_b,
                                                          build_vit_h)
from labelanything_tpu_torch.ops import flash_attention as fa
from labelanything_tpu_torch.ops import fused_window as fw
from labelanything_tpu_torch.utils.weights import (init_weights,
                                                   state_dict_from_jax)
from tests.test_torch_baselines import jax_init
from tests.test_torch_image_encoder import TOY_VIT, nonzero_rel_pos
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-3, atol=5e-4)   # tests/golden.py:165


def _close(ours, ref, rel=1e-5):
    """Within ``rel`` of the reference's largest magnitude, element-wise
    relative ``rel`` besides."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=rel,
                               atol=rel * np.abs(ref).max())


def _fused_inputs(b, hp, wp, heads, dh, ws, seed=0):
    """x, qkv, r (times log2(e)), w (C_in, C_out: flax's layout), bias."""
    rng = np.random.default_rng(seed)
    c = heads * dh
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f(b, hp, wp, c), f(b, hp, wp, 3 * c),
            0.5 * f(b, heads, hp, wp, 2 * ws), f(c, c) / np.float32(c ** 0.5),
            0.1 * f(c))


FUSED_SHAPES = [
    # (b, hp, wp, heads, dh, ws): grid 8 padded to 9 by windows of 3; heads
    # 80 wide; a rectangular map of 4 x 4 windows
    (2, 9, 9, 2, 64, 3),
    (1, 6, 9, 2, 80, 3),
    (1, 16, 16, 1, 64, 4),
]


@pytest.mark.parametrize("b,hp,wp,heads,dh,ws", FUSED_SHAPES)
def test_fused_window_plain_matches_jax_ref(b, hp, wp, heads, dh, ws):
    x, qkv, r, w, bias = _fused_inputs(b, hp, wp, heads, dh, ws)
    scale = dh ** -0.5
    ref = jfw._fused_window_xla_ref(*map(jnp.asarray, (x, qkv, r, w, bias)),
                                    scale, heads, ws)
    t = torch.from_numpy
    ours = fw.fused_window_plain(t(x), t(qkv), t(r), t(w.T.copy()), t(bias),
                                 scale, heads, ws)
    _close(ours.numpy(), ref)
    # the function the model calls takes the twin on the CPU
    again = fw.fused_window_attention(t(x), t(qkv), t(r), t(w.T.copy()),
                                      t(bias), scale, heads, ws)
    assert torch.equal(again, ours)


def test_fused_window_gradients_match_jax(monkeypatch):
    """The twin's backward (the Function recomputes the twin under autograd)
    against ``jax.grad`` through the JAX fused function in interpret mode."""
    b, hp, wp, heads, dh, ws = FUSED_SHAPES[0]
    x, qkv, r, w, bias = _fused_inputs(b, hp, wp, heads, dh, ws, seed=1)
    ct = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    scale = dh ** -0.5
    monkeypatch.setattr(jfw, "_INTERPRET", True)

    def loss(*args):
        return jnp.sum(jfw.fused_window_attention(*args, scale, heads, ws)
                       * ct)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (x, qkv, r, w, bias)))
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x, qkv, r, w.T.copy(), bias)]
    out = fw.fused_window_attention(*leaves, scale, heads, ws)
    ours = torch.autograd.grad(out, leaves, torch.from_numpy(ct))
    for name, got, want in zip(("x", "qkv", "r", "w", "bias"), ours, ref):
        want = np.asarray(want)
        if name == "w":
            want = want.T
        _close(got.numpy(), want, rel=1e-4)


def _noisy(params, seed=3, std=0.1):
    """JAX params with N(0, std) noise on every leaf: at this scale the
    JAX Pallas body's Cauchy-Schwarz shift on [q | r] . [k | E] exceeds the
    scores by enough to underflow every exponential of a window."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + jnp.asarray(rng.normal(0.0, std, a.shape)
                                  .astype(np.float32)), params)


ENCODERS = [
    dict(TOY_VIT),                                   # grid 8, window 3: padded
    dict(TOY_VIT, embed_dim=160, out_chans=32),      # heads 80 wide
]


def _jax_encoder(config, x, noisy):
    jm = jie.ImageEncoderViT(use_rel_pos=True, project_last_hidden=True,
                             **config)
    params = nonzero_rel_pos(jax_init(jm, jnp.asarray(x)))
    if noisy:
        params = _noisy(params)
    return jm, params


def _torch_encoder(config, params, **options):
    tm = tie.ImageEncoderViT(project_last_hidden=True, **config, **options)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return tm


@pytest.mark.parametrize("config", ENCODERS, ids=["dh64_padded", "dh80"])
def test_fused_encoder_matches_jax_unfused(config, monkeypatch):
    """The port's fused route (on the CPU: the twin) against the JAX
    encoder with its fused kernel off, weights carried across by
    ``state_dict_from_jax``, at a weight scale where the JAX Pallas body
    underflows: its fused path (interpret mode) leaves the tolerance."""
    assert jfw._ENABLE is False
    x = np.random.default_rng(4).standard_normal((2, 128, 128, 3)).astype(
        np.float32)
    jm, params = _jax_encoder(config, x, noisy=True)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    with monkeypatch.context() as m:
        m.setattr(jfw, "_ENABLE", True)
        m.setattr(jfw, "_INTERPRET", True)
        pallas = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    assert (np.abs(pallas - ref) > TOL["atol"] + TOL["rtol"] * np.abs(ref)
            ).any()
    tm = _torch_encoder(config, params, fused_window=True)
    assert all(blk.fused == (blk.window_size > 0) for blk in tm.blocks)
    before = dict(fa.LAUNCHES)
    with torch.no_grad():
        ours = tm(torch.from_numpy(x)).numpy()
        unfused = _torch_encoder(config, params)(torch.from_numpy(x)).numpy()
    assert dict(fa.LAUNCHES) == before
    np.testing.assert_allclose(ours, ref, **TOL)
    np.testing.assert_allclose(ours, unfused, **TOL)


def test_fused_encoder_matches_jax_fused_where_its_shift_is_sound(
        monkeypatch):
    """At the init's scale the JAX Pallas body's shift is sound: its fused
    path (interpret mode) and the port's agree."""
    monkeypatch.setattr(jfw, "_ENABLE", True)
    monkeypatch.setattr(jfw, "_INTERPRET", True)
    config = ENCODERS[0]
    x = np.random.default_rng(5).standard_normal((1, 128, 128, 3)).astype(
        np.float32)
    jm, params = _jax_encoder(config, x, noisy=False)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    tm = _torch_encoder(config, params, fused_window=True)
    with torch.no_grad():
        ours = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, **TOL)


def test_options_change_no_parameter():
    """Both options keep the parameter tree: the same names and shapes, so
    ``state_dict_from_jax`` and ``init_weights`` serve them unchanged."""
    base = tie.ImageEncoderViT(**TOY_VIT)
    for options in (dict(fused_window=True), dict(int8_scores=True)):
        other = tie.ImageEncoderViT(**TOY_VIT, **options)
        assert {k: v.shape for k, v in other.state_dict().items()} == \
            {k: v.shape for k, v in base.state_dict().items()}
        init_weights(base, 0)
        init_weights(other, 0)
        for (k, a), (_, c) in zip(base.state_dict().items(),
                                  other.state_dict().items()):
            assert torch.equal(a, c), k


def test_builders_thread_the_options():
    """Builder arguments, off by default; ``build_from_config`` passes a
    config's keys on to ``build_lam_vit_*`` and the encoder."""
    with torch.device("meta"):
        default = build_vit_b(project_last_hidden=False)
        fused = build_vit_h(fused_window=True, int8_scores=True)
        lam = build_from_config(dict(
            name="lam_b", image_embed_dim=768, embed_dim=512,
            image_size=1024, use_vit_sam_neck=False, fused_window=True,
            int8_scores=True,
            class_encoder={"name": "RandomMatrixEncoder", "bank_size": 100}))
    assert not any(blk.fused or blk.attn.int8_scores
                   for blk in default.blocks)
    for vit in (fused, lam.image_encoder):
        assert [blk.fused for blk in vit.blocks] == \
            [blk.window_size > 0 for blk in vit.blocks]
        assert all(blk.attn.int8_scores for blk in vit.blocks)
    assert sum(blk.fused for blk in fused.blocks) == 28
    assert sum(blk.fused for blk in lam.image_encoder.blocks) == 8


CUDA = torch.device("cuda")
RULE_CASES = [
    (dict(), True),                                   # ViT-B
    (dict(heads=16), True),                           # ViT-L
    (dict(heads=16, head_dim=80), True),              # ViT-H
    (dict(dtype=torch.float32), True),
    (dict(heads=1, ws=16), True),                     # the 256-token maximum
    (dict(device=torch.device("cpu")), False),
    (dict(dtype=torch.float16), False),
    (dict(head_dim=32, heads=24), False),
    (dict(heads=2, head_dim=80), False),              # width 160
    (dict(heads=20, head_dim=80), False),             # width 1600
    (dict(ws=17), False),
]


@pytest.mark.parametrize("change,expected", RULE_CASES)
def test_fused_window_ok_rule(change, expected):
    case = dict(device=CUDA, dtype=torch.bfloat16, heads=12, head_dim=64,
                ws=14)
    case.update(change)
    assert fw.fused_window_ok(**case) is expected


def test_fused_cuda_route_never_falls_back():
    """Off the CPU the function launches its kernel or raises; an encoder
    block on the card routes by the rule alone."""
    b, hp, wp, heads, dh, ws = FUSED_SHAPES[0]
    c = heads * dh
    args = [torch.zeros(s, device="meta") for s in
            ((b, hp, wp, c), (b, hp, wp, 3 * c), (b, heads, hp, wp, 2 * ws),
             (c, c), (c,))]
    before = fa.LAUNCHES["fused_window"]
    with pytest.raises(ValueError, match="not compiled for"):
        fw.fused_window_attention(*args, dh ** -0.5, heads, ws)
    with pytest.raises(ValueError, match="not padded"):
        fw.fused_window_attention(args[0][:, :8], *args[1:], dh ** -0.5,
                                  heads, ws)
    with pytest.raises(ValueError, match="must be"):
        fw.fused_window_attention(*args[:3], args[3][:, :1], args[4],
                                  dh ** -0.5, heads, ws)
    assert fa.LAUNCHES["fused_window"] == before


# the int8 score branch of K1: tests/test_ops.py's shape (1, 1024, 384),
# 2 heads of 64 on a 32 x 32 grid, where the JAX rule takes the flag
INT8 = dict(b=1, grid=(32, 32), heads=2)


def _lanes_inputs(b, grid, heads, seed=13):
    kh, kw = grid
    n, c = kh * kw, heads * 64
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, n, 3 * c)).astype(np.float32)
    r = (0.25 * rng.standard_normal((b, n, heads * (kh + kw)))).astype(
        np.float32)
    return qkv, r


def test_int8_twin_matches_jax_interpret(monkeypatch):
    qkv, r = _lanes_inputs(INT8["b"], INT8["grid"], INT8["heads"])
    scale = 64 ** -0.5
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    monkeypatch.setenv("LA_TPU_INT8_SCORES", "1")
    ref = np.asarray(jfa._lanes_fwd_impl(jnp.asarray(qkv), jnp.asarray(r),
                                         scale, INT8["grid"], INT8["heads"]))
    t = torch.from_numpy
    ours = fa.relpos_attention_int8_plain(t(qkv), t(r), scale, INT8["grid"],
                                          INT8["heads"])
    _close(ours.numpy(), ref)
    # the wrapper on a CPU tensor takes the int8 twin where the rule holds
    routed = fa.flash_attention_relpos_lanes(t(qkv), t(r), scale,
                                             INT8["grid"], INT8["heads"],
                                             int8_scores=True)
    assert torch.equal(routed, ours)
    full = fa.relpos_attention_plain(t(qkv), t(r), scale, INT8["grid"],
                                     INT8["heads"])
    assert 0 < (ours - full).abs().max() <= 0.05 * full.abs().max()


@pytest.mark.parametrize("grid,expected", [
    ((64, 64), True),      # ViT-B / ViT-L global blocks at 1024 px
    ((32, 32), True),
    ((48, 48), False),     # 256-key blocks do not hold whole rows of 48
    ((32, 6), False),      # rows narrower than 8
    ((16, 12), True),      # one block of all 192 keys
])
def test_int8_scores_rule(grid, expected):
    """The port's copy of the JAX rule gives the JAX rule's answer."""
    kh, kw = grid
    n = kh * kw
    assert fa.int8_scores_ok(grid, n) is expected
    assert jfa.vpu_bias_ok(kh, kw, n, jfa._pick_blocks_long(n)[1]) is expected


@pytest.mark.parametrize("grid", [(48, 48), (32, 6)])
def test_int8_flag_has_no_effect_where_the_rule_fails(grid):
    qkv, r = _lanes_inputs(1, grid, 2, seed=5)
    t = torch.from_numpy
    args = (64 ** -0.5, grid, 2)
    flagged = fa.flash_attention_relpos_lanes(t(qkv), t(r), *args,
                                              int8_scores=True)
    assert torch.equal(flagged, fa.relpos_attention_plain(t(qkv), t(r),
                                                          *args))


def test_int8_gradient_matches_jax(monkeypatch):
    """The int8 forward's gradient: the full-precision softmax recomputed,
    D = rowsum(dO . O) from the int8 output, as the JAX ``_lanes_bwd``
    hands the int8 ``out`` to its fused backward (interpret mode)."""
    qkv, r = _lanes_inputs(INT8["b"], INT8["grid"], INT8["heads"], seed=7)
    ct = np.random.default_rng(8).standard_normal(
        (INT8["b"], qkv.shape[1], qkv.shape[2] // 3)).astype(np.float32)
    scale = 64 ** -0.5
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    monkeypatch.setenv("LA_TPU_INT8_SCORES", "1")

    def loss(a, c):
        return jnp.sum(jfa.flash_attention_relpos_lanes(
            a, c, scale, INT8["grid"], INT8["heads"]) * ct)

    ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(qkv), jnp.asarray(r))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (qkv, r)]
    out = fa.flash_attention_relpos_lanes(*leaves, scale, INT8["grid"],
                                          INT8["heads"], int8_scores=True)
    ours = torch.autograd.grad(out, leaves, torch.from_numpy(ct))
    for got, want in zip(ours, ref):
        _close(got.numpy(), want, rel=1e-4)
    # the gradient is not the full-precision forward's: D comes from the
    # int8 output
    full = torch.autograd.grad(
        fa.flash_attention_relpos_lanes(*leaves, scale, INT8["grid"],
                                        INT8["heads"]),
        leaves, torch.from_numpy(ct))
    assert not torch.allclose(full[0], ours[0], rtol=1e-4, atol=1e-5)
