"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips without one.
The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from labelanything_tpu_torch.ops import flash_attention as fa
from labelanything_tpu_torch.ops import time_kernels as tk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels are compiled by nvcc at "
                    "first use)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, grid_hw, heads, dtype, device, seed=0):
    kh, kw = grid_hw
    n, c = kh * kw, heads * 64
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * c), np.float32))
    r = torch.from_numpy(
        (0.5 * rng.standard_normal((b, n, heads * (kh + kw)))).astype(np.float32))
    return qkv.to(device, dtype), r.to(device, dtype)


def _bf16_ok(kernel_bf16, plain_bf16, plain_fp32):
    """|kernel - plain| <= 4 * |plain_bf16 - plain_fp32| + 1e-6 (worst case
    over all elements, the rule of benchmarks.bench_gradcheck)."""
    diff = (kernel_bf16.float() - plain_bf16.float()).abs().max().item()
    floor = (plain_bf16.float() - plain_fp32).abs().max().item()
    return diff <= 4 * floor + 1e-6, diff, floor


CASES = [
    # (wrapper, batch, grid_hw, heads)
    ("global", 1, (64, 64), 12),
    ("global", 2, (48, 16), 2),
    ("global", 2, (16, 48), 2),
    ("global", 1, (7, 9), 2),      # ragged query and key tiles
    ("global", 2, (8, 64), 2),     # 64-wide key-grid rows: the wgmma backward
    ("global", 1, (7, 64), 2),     # 64-wide rows the wgmma backward refuses:
                                   # the general mma.sync path
    ("window", 25, (14, 14), 12),
    ("window", 4, (3, 3), 2),
    ("window", 3, (16, 16), 2),    # the 256-token maximum
]


@pytest.mark.parametrize("kind,b,grid_hw,heads", CASES)
def test_kernel_matches_plain(cuda, kind, b, grid_hw, heads):
    fn = (fa.flash_attention_relpos_lanes if kind == "global"
          else fa.flash_attention_relpos_lanes_batched)
    counter = "relpos_global" if kind == "global" else "relpos_window"
    scale = 64 ** -0.5
    qkv, r = _inputs(b, grid_hw, heads, torch.float32, cuda)
    before = fa.LAUNCHES[counter]
    out = fn(qkv, r, scale, grid_hw, heads)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[counter] == before + 1
    ref = fa.relpos_attention_plain(qkv, r, scale, grid_hw, heads)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)

    qb, rb = qkv.bfloat16(), r.bfloat16()
    out_b = fn(qb, rb, scale, grid_hw, heads)
    ok, diff, floor = _bf16_ok(
        out_b, fa.relpos_attention_plain(qb, rb, scale, grid_hw, heads),
        fa.relpos_attention_plain(qb.float(), rb.float(), scale, grid_hw,
                                  heads))
    assert out_b.dtype == torch.bfloat16 and ok, (diff, floor)


# K2 (the windowed kernel) at the serving path's windows (14 x 14) for
# ViT-B's 12 and ViT-L's 16 heads, at a request's 25 windows and an
# embedding batch's 200, and at the smaller and the largest windows
WINDOW_CASES = [
    # (batch, grid_hw, heads)
    (25, (14, 14), 12), (200, (14, 14), 12), (25, (14, 14), 16),
    (200, (14, 14), 16), (9, (7, 7), 12), (4, (7, 7), 16),
    (3, (16, 16), 12), (2, (16, 16), 16),
]


def _lse_plain(qkv, r, scale, grid_hw, heads):
    """The twin's log-sum-exp of every row, (B, heads, N) fp32, in the log2
    domain the kernels keep: log2 sum_j 2^(q.k_j scale log2e + r terms)."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    kh, _ = grid_hw

    def split(x):
        return x.reshape(b, n, heads, -1).transpose(1, 2).double()

    q, k = split(qkv[..., :c]), split(qkv[..., c:2 * c])
    rb = split(r)
    s = torch.matmul(q, k.transpose(-1, -2)) * (scale * fa.LOG2E)
    s += (rb[..., :kh, None] + rb[..., None, kh:]).reshape(s.shape)
    return (torch.logsumexp(s * np.log(2.0), dim=-1) / np.log(2.0)).float()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,grid_hw,heads", WINDOW_CASES)
def test_window_kernel_shapes_lse_and_gradient(cuda, b, grid_hw, heads,
                                               dtype):
    """K2 against its twin (fp32 within 1e-4, bf16 by the 4x rule); the
    log-sum-exp it writes for the backward against the twin's on the same
    (bf16-rounded) inputs, in float64, within 1e-4; K4's gradient, fed by
    that log-sum-exp, against the plain backward by the same rules."""
    args = (64 ** -0.5, grid_hw, heads)
    qkv, r = _inputs(b, grid_hw, heads, dtype, cuda, seed=4)
    before = dict(fa.LAUNCHES)
    out, lse = fa._launch("relpos_window", qkv, r, *args, want_lse=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["relpos_window"] == before["relpos_window"] + 1
    assert lse.shape == (b, heads, grid_hw[0] * grid_hw[1])
    assert lse.dtype == torch.float32
    torch.testing.assert_close(lse, _lse_plain(qkv, r, *args),
                               rtol=1e-4, atol=1e-4)
    plain = fa.relpos_attention_plain(qkv, r, *args)
    if dtype == torch.float32:
        torch.testing.assert_close(out, plain, rtol=1e-4, atol=1e-4)
    else:
        ok, diff, floor = _bf16_ok(out, plain, fa.relpos_attention_plain(
            qkv.float(), r.float(), *args))
        assert out.dtype == dtype and ok, (diff, floor)
    ct = torch.from_numpy(np.random.default_rng(5).standard_normal(
        tuple(out.shape), np.float32)).to(cuda, dtype)
    qg, rg = qkv.clone().requires_grad_(), r.clone().requires_grad_()
    grads = torch.autograd.grad(
        fa.flash_attention_relpos_lanes_batched(qg, rg, *args), (qg, rg), ct)
    assert fa.LAUNCHES["relpos_window_bwd"] == before["relpos_window_bwd"] + 1
    with torch.no_grad():
        ref = fa.relpos_attention_bwd_plain(qkv, r, out, ct, *args)
        ref32 = fa.relpos_attention_bwd_plain(
            qkv.float(), r.float(), out.float(), ct.float(), *args)
    for got, x, x32 in zip(grads, ref, ref32):
        if dtype == torch.float32:
            torch.testing.assert_close(got, x, rtol=1e-4, atol=1e-4)
        else:
            ok, diff, floor = _bf16_ok(got, x, x32)
            assert ok, (diff, floor)


def test_window_kernel_rejects_grids_past_16(cuda):
    """Windows past 16 x 16 raise on the card; the twin takes them on the
    CPU only."""
    qkv, r = _inputs(1, (4, 20), 2, torch.bfloat16, cuda)
    before = fa.LAUNCHES["relpos_window"]
    with pytest.raises(ValueError, match="16 x 16"):
        fa.flash_attention_relpos_lanes_batched(qkv, r, 0.125, (4, 20), 2)
    assert fa.LAUNCHES["relpos_window"] == before


def test_kernel_rejects_bad_input(cuda):
    qkv, r = _inputs(1, (8, 8), 2, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_relpos_lanes(torch.cat([qkv, qkv], -1)[..., :384],
                                        r, 0.125, (8, 8), 2)
    with pytest.raises(TypeError):
        fa.flash_attention_relpos_lanes(qkv.half(), r.half(), 0.125, (8, 8), 2)


@pytest.mark.parametrize("kind,b,grid_hw,heads", CASES + [
    ("window", 150, (14, 14), 12),   # the training step's windows
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_matches_plain(cuda, kind, b, grid_hw, heads, dtype):
    """K3 / K4 against the plain backward on the same inputs, saved output
    and cotangent: fp32 to rtol = atol = 1e-4 (sums in another order), bf16
    by the 4 x rounding-floor rule, per output (dqkv and dr). The
    cotangent is handed over strided."""
    fn = (fa.flash_attention_relpos_lanes if kind == "global"
          else fa.flash_attention_relpos_lanes_batched)
    counter = ("relpos_global" if kind == "global" else "relpos_window") \
        + "_bwd"
    args = (64 ** -0.5, grid_hw, heads)
    qkv, r = _inputs(b, grid_hw, heads, dtype, cuda, seed=1)
    ct = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (b, qkv.shape[1], heads * 64), np.float32)).to(cuda, dtype)
    qkv.requires_grad_()
    r.requires_grad_()
    out = fn(qkv, r, *args)
    before = fa.LAUNCHES[counter]
    strided = torch.stack([ct, ct], dim=-1)[..., 0]
    grads = torch.autograd.grad(out, (qkv, r), strided)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[counter] == before + 1
    with torch.no_grad():
        plain = fa.relpos_attention_bwd_plain(qkv, r, out, ct, *args)
        plain32 = fa.relpos_attention_bwd_plain(
            qkv.float(), r.float(), out.float(), ct.float(), *args)
    for got, ref, ref32 in zip(grads, plain, plain32):
        assert got.dtype == dtype and got.shape == ref.shape
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
        else:
            ok, diff, floor = _bf16_ok(got, ref, ref32)
            assert ok, (diff, floor)


@pytest.mark.parametrize("kind,b,grid_hw,heads", [
    ("global", 2, (32, 32), 4),
    ("global", 2, (16, 64), 3),    # 64-wide key-grid rows: the wgmma backward
    ("window", 25, (14, 14), 12),  # the query and key cuts on the slots
    ("window", 4, (7, 7), 2),      # key-grid rows of 8 slots
    ("window", 3, (16, 16), 2),
])
def test_backward_kernel_is_deterministic(cuda, kind, b, grid_hw, heads):
    """No atomics: two runs give bit-identical gradients."""
    fn = (fa.flash_attention_relpos_lanes if kind == "global"
          else fa.flash_attention_relpos_lanes_batched)
    qkv, r = _inputs(b, grid_hw, heads, torch.bfloat16, cuda)
    qkv.requires_grad_()
    r.requires_grad_()
    out = fn(qkv, r, 0.125, grid_hw, heads)
    ct = torch.ones_like(out)
    first = torch.autograd.grad(out, (qkv, r), ct, retain_graph=True)
    second = torch.autograd.grad(out, (qkv, r), ct)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


def test_no_lse_without_grad_and_plain_by_name(cuda):
    qkv, r = _inputs(1, (8, 8), 2, torch.float32, cuda)
    fa.reset_launches()
    with fa.plain_attention():
        plain = fa.flash_attention_relpos_lanes(qkv, r, 0.125, (8, 8), 2)
    assert not any(fa.LAUNCHES.values())
    out = fa.flash_attention_relpos_lanes(qkv, r, 0.125, (8, 8), 2)
    assert fa.LAUNCHES["relpos_global"] == 1 and out.grad_fn is None
    torch.testing.assert_close(out, plain, rtol=1e-4, atol=1e-4)


# ---- the packed kernels (head widths 64 and 80) -----------------------------

def _packed_inputs(b, grid_hw, heads, dh, dtype, device, token_major, seed=0):
    """Packed qkv and r, either contiguous slot-major or as token-major
    views of a projection, as the encoder hands them over."""
    kh, kw = grid_hw
    n = kh * kw
    rng = np.random.default_rng(seed)
    if token_major:
        qkv = torch.from_numpy(rng.standard_normal(
            (b, n, 3 * heads, dh), np.float32)).permute(0, 2, 1, 3)
        r = torch.from_numpy((0.5 * rng.standard_normal(
            (b, n, heads, kh + kw))).astype(np.float32)).permute(0, 2, 1, 3)
    else:
        qkv = torch.from_numpy(rng.standard_normal(
            (b, 3 * heads, n, dh), np.float32))
        r = torch.from_numpy((0.5 * rng.standard_normal(
            (b, heads, n, kh + kw))).astype(np.float32))
    return qkv.to(device, dtype), r.to(device, dtype)


PACKED_CASES = [
    # (batch, grid_hw, heads, dh)
    (1, (64, 64), 16, 80),     # ViT-H global block, division-free bias
    (2, (48, 48), 4, 80),      # general bias path
    (2, (16, 48), 2, 64),
    (1, (17, 19), 3, 80),      # ragged query and key tiles
    (25, (14, 14), 16, 80),    # ViT-H windowed block
    (4, (3, 3), 2, 80),
    (3, (16, 16), 2, 64),      # the windowed kernel's 256-token maximum
    (2, (7, 9), 1, 64),
    (4, (7, 7), 2, 80),        # windowed, key-grid rows of 8 slots
    (3, (16, 16), 2, 80),      # windowed, the 16 x 16 maximum at dh 80
    (2, (4, 20), 2, 80),       # N <= 256 on a grid the windowed kernel
                               # refuses: the global kernel
    (8, (64, 64), 16, 80),     # ViT-H's embedding batch of 8 images
    (1, (2, 64), 2, 80),       # the smallest grid the wgmma kernel takes
    (1, (7, 64), 2, 80),       # 64-wide rows it refuses (kh odd): mma.sync
]


@pytest.mark.parametrize("token_major", [True, False])
@pytest.mark.parametrize("b,grid_hw,heads,dh", PACKED_CASES)
def test_packed_kernel_matches_plain(cuda, b, grid_hw, heads, dh,
                                     token_major):
    counter = fa.packed_route(grid_hw[0] * grid_hw[1], grid_hw)
    args = (dh ** -0.5, grid_hw, heads)
    qkv, r = _packed_inputs(b, grid_hw, heads, dh, torch.float32, cuda,
                            token_major)
    assert fa._token_major(qkv) == token_major
    before = fa.LAUNCHES[counter]
    out = fa.flash_attention_relpos_packed(qkv, r, *args)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[counter] == before + 1
    # the output lies as the input does (with one head both orders coincide)
    assert fa._token_major(out) == (token_major and heads > 1)
    ref = fa.relpos_packed_plain(qkv, r, *args)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)

    qb, rb = qkv.bfloat16(), r.bfloat16()
    out_b = fa.flash_attention_relpos_packed(qb, rb, *args)
    ok, diff, floor = _bf16_ok(
        out_b, fa.relpos_packed_plain(qb, rb, *args),
        fa.relpos_packed_plain(qb.float(), rb.float(), *args))
    assert out_b.dtype == torch.bfloat16 and ok, (diff, floor)
    # the other layout of the same values gives the same bits
    other = fa.flash_attention_relpos_packed(qb.contiguous(), rb.contiguous(),
                                             *args)
    assert torch.equal(other, out_b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grid_hw,dh", [((64, 64), 80), ((2, 64), 80),
                                        ((7, 64), 80), ((48, 48), 80),
                                        ((16, 64), 64)])
def test_packed_global_runs_the_kernel_of_its_rule(cuda, grid_hw, dh, dtype):
    """The packed global route launches the kernel that
    ``packed_global_kernel`` names, and no other."""
    qkv, r = _packed_inputs(1, grid_hw, 2, dh, dtype, cuda, True)
    names = tk.kernel_names(lambda: fa.flash_attention_relpos_packed(
        qkv, r, dh ** -0.5, grid_hw, 2), calls=3)
    want = fa.packed_global_kernel(dtype, dh, grid_hw)
    assert len(names) == 1 and want in next(iter(names)), (want, names)


@pytest.mark.parametrize("b,grid_hw,heads", [(150, (14, 14), 12),
                                             (4, (7, 7), 2)])
def test_window_backward_runs_the_kernels_of_its_rule(cuda, b, grid_hw,
                                                      heads):
    """The windowed backward launches the three kernels that
    ``window_bwd_kernels`` names, in both dtypes."""
    for dtype in (torch.bfloat16, torch.float32):
        qkv, r = _inputs(b, grid_hw, heads, dtype, cuda)
        args = (0.125, grid_hw, heads)
        out, lse = fa._launch("relpos_window", qkv, r, *args, want_lse=True)
        ct = torch.ones_like(out)
        names = tk.kernel_names(lambda: fa._launch_bwd(
            "relpos_window", qkv, r, out, ct, lse, *args), calls=3)
        want = fa.window_bwd_kernels(dtype, grid_hw)
        assert len(names) == 3 and all(
            any(w in name for name in names) for w in want), (want, names)


def test_packed_kernel_gradient_and_unpacked_entry(cuda):
    """Kernel forward, plain backward: the gradients of autograd through
    the plain twin (fp32, rtol = atol = 1e-4); ``flash_attention_relpos``
    launches the same kernel with one head."""
    b, grid_hw, heads, dh = 2, (14, 14), 2, 80
    args = (dh ** -0.5, grid_hw, heads)
    qkv, r = _packed_inputs(b, grid_hw, heads, dh, torch.float32, cuda, True)
    ct = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (b, heads, 196, dh), np.float32)).to(cuda)
    grads = []
    for fn in (fa.flash_attention_relpos_packed, fa.relpos_packed_plain):
        a, c = qkv.detach().requires_grad_(), r.detach().requires_grad_()
        grads.append(torch.autograd.grad(fn(a, c, *args), (a, c), ct))
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)

    q, k, v = (qkv[:, i].contiguous() for i in (0, heads, 2 * heads))
    rel = r[:, 0] / fa.LOG2E
    before = fa.LAUNCHES["relpos_packed_window"]
    out = fa.flash_attention_relpos(q, k, v, rel[..., :14], rel[..., 14:],
                                    args[0], grid_hw)
    assert fa.LAUNCHES["relpos_packed_window"] == before + 1
    ref = fa.relpos_packed_plain(qkv, r, *args)[:, 0]
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_packed_kernel_rejects_bad_input(cuda):
    """A head width the kernels were not compiled for, an unaligned view
    or a strided last axis raises on the card; nothing reaches the twin."""
    fa.reset_launches()
    qkv, r = _packed_inputs(1, (8, 8), 2, 32, torch.float32, cuda, False)
    with pytest.raises(ValueError, match="head width"):
        fa.flash_attention_relpos_packed(qkv, r, 0.2, (8, 8), 2)
    qkv, r = _packed_inputs(1, (8, 8), 2, 80, torch.bfloat16, cuda, False)
    wide = torch.cat([qkv, qkv], -1)
    with pytest.raises(ValueError, match="last axis"):
        fa.flash_attention_relpos_packed(wide[..., ::2], r, 0.1, (8, 8), 2)
    shifted = torch.cat([qkv, qkv], -1)[..., 4:84]
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_relpos_packed(shifted, r, 0.1, (8, 8), 2)
    with pytest.raises(TypeError):
        fa.flash_attention_relpos_packed(qkv.half(), r.half(), 0.1, (8, 8), 2)
    # the wrapper's 16-byte check guards the wgmma route too (the TMA's rule)
    qkv, r = _packed_inputs(1, (2, 64), 2, 80, torch.bfloat16, cuda, False)
    shifted = torch.cat([qkv, qkv], -1)[..., 4:84]
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_relpos_packed(shifted, r, 0.1, (2, 64), 2)
    assert not any(fa.LAUNCHES.values())


@pytest.mark.parametrize("heads,dh", [(12, 64), (16, 80)])
def test_microbench_variants_match_plain(cuda, heads, dh):
    """The score-dtype microbench's variants of the mma.sync packed global
    kernel within 4 x the bf16 floor of the plain twin (``errors`` raises
    otherwise), each through its own kernel."""
    from labelanything_tpu_torch.ops import microbench_softmax_dtype as mb

    fa.reset_launches()
    errs = mb.errors(heads, dh)
    assert sorted(errs) == ["a", "e", "f"]
    for mode, kernel in mb.VARIANTS.items():
        assert fa.LAUNCHES[kernel] == 1, (mode, fa.LAUNCHES)
    qkv, r = mb.inputs(1, heads, dh)
    # e is the mma.sync kernel that a and f vary, also where the route
    # would take the wgmma kernel
    names = tk.kernel_names(lambda: mb.run_variant(
        qkv, r, dh ** -0.5, mb.GRID, heads, "e"), calls=3)
    assert len(names) == 1 and "packed_global_tc_kernel" in next(
        iter(names)), names
    with pytest.raises(RuntimeError, match="failed to launch"):
        # the variants take only key grids whose rows are 64 wide
        mb.run_variant(qkv[:, :, :48 * 48], r[:, :, :48 * 48, :96],
                       dh ** -0.5, (48, 48), heads, "f")


# ---- the fused TwoWayTransformer ------------------------------------------

def _twoway_case(g, s, n, dtype, device, mlp=2048, seed=0):
    from labelanything_tpu_torch.models.transformer import TwoWayTransformer
    from labelanything_tpu_torch.utils.weights import init_weights

    tr = TwoWayTransformer(2, 256, 8, mlp).to(device)
    init_weights(tr, seed)
    rng = np.random.default_rng(seed)
    keys, queries, pe = (
        torch.from_numpy(rng.standard_normal(shape, np.float32)).to(device,
                                                                    dtype)
        for shape in ((g, s, 256), (g, n, 256), (s, 256)))
    return tr, keys, queries, pe


TWOWAY_CASES = [
    # (instances, image tokens, tokens, MLP width)
    (96, 900, 6, 2048),    # the prompt encoder's call on the decode path
    (16, 900, 6, 2048),    # the mask decoder's
    (5, 900, 3, 2048),     # tokens not a multiple of 8, an odd instance count
    (3, 37, 8, 2048),      # a ragged last row tile, all 8 token rows
    (2, 40, 1, 64),        # one token, a narrow MLP, idle warps' states
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,s,n,mlp", TWOWAY_CASES)
def test_fused_twoway_matches_plain(cuda, g, s, n, mlp, dtype):
    """K7 against ``twoway_plain`` on the same inputs, both outputs: fp32 to
    rtol = atol = 1e-4 (sums in another order), bf16 by the 4 x
    rounding-floor rule."""
    from labelanything_tpu_torch.ops import fused_twoway as ft

    tr, keys, queries, pe = _twoway_case(g, s, n, dtype, cuda, mlp)
    params = ft.twoway_params(tr)
    before = fa.LAUNCHES["fused_twoway"]
    with torch.no_grad():
        got = ft.fused_twoway_transformer(keys, queries, pe, params, 2, 8)
        torch.cuda.synchronize()
        assert fa.LAUNCHES["fused_twoway"] == before + 1
        ref = ft.twoway_plain(keys, queries, pe, params, 2, 8)
        ref32 = ft.twoway_plain(keys.float(), queries.float(), pe.float(),
                                params, 2, 8)
    for out, plain, plain32 in zip(got, ref, ref32):
        assert out.dtype == dtype and out.shape == plain.shape
        if dtype == torch.float32:
            torch.testing.assert_close(out, plain, rtol=1e-4, atol=1e-4)
        else:
            ok, diff, floor = _bf16_ok(out, plain, plain32)
            assert ok, (diff, floor)
    assert fa.LAUNCHES["fused_twoway"] == before + 1


def test_fused_twoway_gradient_and_plain_by_name(cuda):
    """Kernel forward, recomputed plain backward: the gradients of autograd
    through the twin; inside ``plain_attention()`` no kernel is launched."""
    from labelanything_tpu_torch.ops import fused_twoway as ft

    tr, keys, queries, pe = _twoway_case(3, 100, 6, torch.float32, cuda)
    params = ft.twoway_params(tr)
    grads = []
    for fn in (ft.fused_twoway_transformer, ft.twoway_plain):
        a, b = keys.clone().requires_grad_(), queries.clone().requires_grad_()
        tr.zero_grad()
        before = fa.LAUNCHES["fused_twoway"]
        q, k = fn(a, b, pe, params, 2, 8)
        ((q ** 2).sum() + (k ** 2).sum()).backward()
        assert fa.LAUNCHES["fused_twoway"] - before \
            == int(fn is ft.fused_twoway_transformer)
        grads.append([a.grad, b.grad] + [p.grad.clone() for p in params])
    # the two backwards are the same code and differ only through the
    # forward's outputs (the kernel's sums run in another order): a tensor's
    # error is held to 1e-3 of its largest gradient. The key projections'
    # biases have a gradient of zero in exact arithmetic: a tensor under 1e-6
    # of the largest gradient of all holds rounding only and must stay there
    floor = 1e-6 * max(ref.abs().max().item() for ref in grads[1])
    for got, ref in zip(*grads):
        scale = ref.abs().max().item()
        if scale < floor:
            assert got.abs().max().item() < floor
        else:
            assert (got - ref).abs().max().item() <= 1e-3 * scale
    before = fa.LAUNCHES["fused_twoway"]
    with fa.plain_attention(), torch.no_grad():
        ft.fused_twoway_transformer(keys, queries, pe, params, 2, 8)
    assert fa.LAUNCHES["fused_twoway"] == before


def test_fused_twoway_rejects_bad_input(cuda):
    """Strided operands, a width or token count the kernel is not compiled
    for, or fp16 raise on the card; nothing reaches the twin."""
    from labelanything_tpu_torch.models.transformer import TwoWayTransformer
    from labelanything_tpu_torch.ops import fused_twoway as ft

    tr, keys, queries, pe = _twoway_case(2, 64, 6, torch.bfloat16, cuda)
    params = ft.twoway_params(tr)
    before = fa.LAUNCHES["fused_twoway"]
    wide = torch.cat([keys, keys], dim=-1)
    with pytest.raises(ValueError, match="contiguous"):
        ft.fused_twoway_transformer(wide[..., :256], queries, pe, params, 2, 8)
    with pytest.raises(ValueError, match="not compiled"):
        ft.fused_twoway_transformer(keys, torch.cat([queries, queries], 1),
                                    pe, params, 2, 8)
    with pytest.raises(ValueError, match="not compiled"):
        ft.fused_twoway_transformer(keys.half(), queries.half(), pe.half(),
                                    params, 2, 8)
    small = TwoWayTransformer(2, 128, 8, 2048).to(cuda)
    with pytest.raises(ValueError, match="not compiled"):
        ft.fused_twoway_transformer(
            keys[..., :128].contiguous(), queries[..., :128].contiguous(),
            pe[..., :128].contiguous(), ft.twoway_params(small), 2, 8)
    assert fa.LAUNCHES["fused_twoway"] == before


def _flash_inputs(b, heads, nq, nk, dh, dtype, device, token_major, seed=0):
    """q (b, heads, nq, dh) and k, v (b, heads, nk, dh): as the attention's
    head split views them (token-major projections) or contiguous."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (nq, nk, nk):
        x = torch.from_numpy(rng.standard_normal((b, n, heads, dh),
                                                 np.float32)).to(device, dtype)
        x = x.transpose(1, 2)
        out.append(x if token_major else x.contiguous())
    return out


FLASH_CASES = [
    # (b, heads, nq, nk, dh)
    (6, 8, 4096, 8192, 32),     # the affinity decoder's call
    (1, 2, 1152, 1152, 32),     # ragged last tiles, as the JAX tail case
    (1, 2, 1152, 1000, 32),     # ragged keys: a masked last key tile
    (2, 2, 1024, 2048, 64),
    (1, 2, 1152, 1024, 128),
    (1, 2, 1024, 1152, 256),
    (2, 3, 70, 100, 64),        # both lengths under one tile
]


@pytest.mark.parametrize("token_major", [True, False])
@pytest.mark.parametrize("b,heads,nq,nk,dh", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, b, heads, nq, nk, dh, token_major):
    """fp32 within 1e-4; bf16 by the 4x rule; the output lies as q does and
    the other layout of the same values gives the same bits."""
    q, k, v = _flash_inputs(b, heads, nq, nk, dh, torch.float32, cuda,
                            token_major)
    scale = dh ** -0.5
    key = fa.flash_route(dh, torch.float32)[0]
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[key] == before[key] + 1
    assert fa._token_major(out) == (token_major and heads > 1)
    torch.testing.assert_close(out, fa.flash_attention_plain(q, k, v, scale),
                               rtol=1e-4, atol=1e-4)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    out_b = fa.flash_attention(qb, kb, vb, scale)
    # one launch a call, under the key of its head width's route only
    assert fa.LAUNCHES[key] == before[key] + 2
    assert sum(fa.LAUNCHES.values()) == sum(before.values()) + 2
    ok, diff, floor = _bf16_ok(
        out_b, fa.flash_attention_plain(qb, kb, vb, scale),
        fa.flash_attention_plain(qb.float(), kb.float(), vb.float(), scale))
    assert out_b.dtype == torch.bfloat16 and ok, (diff, floor)
    other = fa.flash_attention(qb.contiguous(), kb.contiguous(),
                               vb.contiguous(), scale)
    assert torch.equal(other, out_b)


def test_flash_kernel_gradient_and_plain_by_name(cuda):
    """Kernel forward, plain backward: autograd through the twin's
    gradients (fp32, rtol = atol = 1e-4); inside ``plain_attention()`` no
    launch."""
    q, k, v = _flash_inputs(2, 2, 1152, 1024, 32, torch.float32, cuda, True)
    ct = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 2, 1152, 32), np.float32)).to(cuda)
    grads = []
    for fn in (fa.flash_attention, fa.flash_attention_plain):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*leaves, 0.2), leaves, ct))
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    before = fa.LAUNCHES["flash"]
    with fa.plain_attention():
        fa.flash_attention(q, k, v, 0.2)
    assert fa.LAUNCHES["flash"] == before


@pytest.mark.parametrize("dh", fa.FLASH_HEAD_DIMS)
def test_flash_route_by_head_width_on_the_card(cuda, dh):
    """Heads 32 and 64 wide take the Hopper kernel (counted under
    ``flash``), 128 and 256 the mma.sync kernel (``flash_mma``): each bf16
    call adds one to its route's counter and nothing to the other's."""
    q, k, v = _flash_inputs(1, 2, 1024, 1024, dh, torch.bfloat16, cuda, True)
    key = fa.flash_route(dh, torch.bfloat16)[0]
    other = ({"flash", "flash_mma"} - {key}).pop()
    assert key == ("flash" if dh in (32, 64) else "flash_mma")
    before = dict(fa.LAUNCHES)
    fa.flash_attention(q, k, v, dh ** -0.5)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[key] == before[key] + 1
    assert fa.LAUNCHES[other] == before[other]


def test_flash_kernel_rejects_bad_input(cuda):
    """A head width the kernel is not compiled for, a strided last axis, an
    unaligned view or fp16 raise on the card; nothing reaches the twin."""
    before = fa.LAUNCHES["flash"]
    q, k, v = _flash_inputs(1, 2, 128, 128, 48, torch.float32, cuda, False)
    with pytest.raises(ValueError, match="head width"):
        fa.flash_attention(q, k, v, 0.2)
    q, k, v = _flash_inputs(1, 2, 128, 128, 64, torch.bfloat16, cuda, False)
    wide = torch.cat([q, q], -1)
    with pytest.raises(ValueError, match="last axis"):
        fa.flash_attention(wide[..., ::2], k, v, 0.1)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(wide[..., 4:68], k, v, 0.1)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half(), 0.1)
    assert fa.LAUNCHES["flash"] == before


# ---- the fused windowed block (K8) ----------------------------------------

def _fused_window_inputs(b, hp, wp, heads, dh, ws, dtype, device, seed=0):
    """x, qkv, r (a view of a (B, Hp, Wp, heads, 2 ws) tensor, as the
    encoder builds it), w_proj (C_out, C_in), b_proj."""
    rng = np.random.default_rng(seed)
    c = heads * dh
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    r = (0.5 * f(b, hp, wp, heads, 2 * ws)).permute(0, 3, 1, 2, 4)
    return [t.to(device, dtype) for t in (
        f(b, hp, wp, c), f(b, hp, wp, 3 * c), r, f(c, c) / c ** 0.5,
        0.1 * f(c))]


FUSED_WINDOW_CASES = [
    # (b, hp, wp, heads, dh, ws)
    (1, 70, 70, 12, 64, 14),    # ViT-B serving: 25 windows, 64 padded to 70
    (1, 70, 70, 16, 80, 14),    # ViT-H
    (2, 9, 12, 4, 64, 3),       # small padded windows, several images
    (1, 32, 16, 4, 80, 16),     # the 256-token maximum
]


@pytest.mark.parametrize("b,hp,wp,heads,dh,ws", FUSED_WINDOW_CASES)
def test_fused_window_matches_plain(cuda, b, hp, wp, heads, dh, ws):
    """K8 against ``fused_window_plain``: fp32 within 1e-4, bf16 by the 4x
    rule; r as a strided view and contiguous give the same bits."""
    from labelanything_tpu_torch.ops import fused_window as fw

    args = (dh ** -0.5, heads, ws)
    inputs = _fused_window_inputs(b, hp, wp, heads, dh, ws, torch.float32,
                                  cuda)
    before = fa.LAUNCHES["fused_window"]
    out = fw.fused_window_attention(*inputs, *args)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["fused_window"] == before + 1
    torch.testing.assert_close(out, fw.fused_window_plain(*inputs, *args),
                               rtol=1e-4, atol=1e-4)
    low = [t.bfloat16() for t in inputs]
    out_b = fw.fused_window_attention(*low, *args)
    ok, diff, floor = _bf16_ok(
        out_b, fw.fused_window_plain(*low, *args),
        fw.fused_window_plain(*[t.float() for t in low], *args))
    assert out_b.dtype == torch.bfloat16 and ok, (diff, floor)
    low[2] = low[2].contiguous()
    assert torch.equal(fw.fused_window_attention(*low, *args), out_b)


def test_fused_window_gradient_and_plain_by_name(cuda):
    """Kernel forward, the twin recomputed for the backward: autograd
    through the twin's gradients (fp32); inside ``plain_attention()`` no
    launch."""
    from labelanything_tpu_torch.ops import fused_window as fw

    b, hp, wp, heads, dh, ws = FUSED_WINDOW_CASES[2]
    args = (dh ** -0.5, heads, ws)
    inputs = _fused_window_inputs(b, hp, wp, heads, dh, ws, torch.float32,
                                  cuda, seed=1)
    ct = torch.randn(inputs[0].shape, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(2))
    grads = []
    for fn in (fw.fused_window_attention, fw.fused_window_plain):
        leaves = [t.detach().requires_grad_() for t in inputs]
        grads.append(torch.autograd.grad(fn(*leaves, *args), leaves, ct))
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    before = fa.LAUNCHES["fused_window"]
    with fa.plain_attention():
        fw.fused_window_attention(*inputs, *args)
    assert fa.LAUNCHES["fused_window"] == before


def test_fused_window_rejects_bad_input(cuda):
    """A head width or model width the kernel is not compiled for, or a
    non-contiguous operand, raise on the card; nothing reaches the twin."""
    from labelanything_tpu_torch.ops import fused_window as fw

    before = fa.LAUNCHES["fused_window"]
    inputs = _fused_window_inputs(1, 6, 6, 2, 48, 3, torch.float32, cuda)
    with pytest.raises(ValueError, match="not compiled for"):
        fw.fused_window_attention(*inputs, 48 ** -0.5, 2, 3)
    inputs = _fused_window_inputs(1, 6, 6, 2, 64, 3, torch.float32, cuda)
    wide = torch.cat([inputs[1], inputs[1]], -1)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        fw.fused_window_attention(inputs[0], wide, *inputs[2:], 0.125, 2, 3)
    assert fa.LAUNCHES["fused_window"] == before


# ---- the int8 score branch of the global kernel (K1) -----------------------

INT8_CASES = [
    # (b, grid_hw, heads): ViT-B's global block; the JAX test's shape
    (1, (64, 64), 12),
    (2, (32, 32), 2),
]


@pytest.mark.parametrize("b,grid_hw,heads", INT8_CASES)
def test_int8_kernel_matches_plain(cuda, b, grid_hw, heads):
    """The int8 kernel against ``relpos_attention_int8_plain``: fp32 within
    1e-4, bf16 by the 4x rule with the int8 twin on bf16 and on fp32-cast
    inputs as the plain pair."""
    args = (64 ** -0.5, grid_hw, heads)
    qkv, r = _inputs(b, grid_hw, heads, torch.float32, cuda, seed=3)
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention_relpos_lanes(qkv, r, *args, int8_scores=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["relpos_global_int8"] == \
        before["relpos_global_int8"] + 1
    assert fa.LAUNCHES["relpos_global"] == before["relpos_global"]
    torch.testing.assert_close(
        out, fa.relpos_attention_int8_plain(qkv, r, *args), rtol=1e-4,
        atol=1e-4)
    qb, rb = qkv.bfloat16(), r.bfloat16()
    out_b = fa.flash_attention_relpos_lanes(qb, rb, *args, int8_scores=True)
    ok, diff, floor = _bf16_ok(
        out_b, fa.relpos_attention_int8_plain(qb, rb, *args),
        fa.relpos_attention_int8_plain(qb.float(), rb.float(), *args))
    assert out_b.dtype == torch.bfloat16 and ok, (diff, floor)


def test_int8_gradient_takes_full_precision_lse(cuda):
    """With a gradient wanted the int8 forward also runs the bf16 / fp32
    kernel for its log-sum-exp; the backward kernel then matches the plain
    backward handed the int8 output."""
    args = (64 ** -0.5, (32, 32), 2)
    qkv, r = _inputs(1, (32, 32), 2, torch.float32, cuda, seed=4)
    ct = torch.randn(1, 1024, 128, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(5))
    qkv.requires_grad_()
    r.requires_grad_()
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention_relpos_lanes(qkv, r, *args, int8_scores=True)
    grads = torch.autograd.grad(out, (qkv, r), ct)
    torch.cuda.synchronize()
    for name in ("relpos_global_int8", "relpos_global", "relpos_global_bwd"):
        assert fa.LAUNCHES[name] == before[name] + 1, name
    with torch.no_grad():
        plain = fa.relpos_attention_bwd_plain(qkv, r, out, ct, *args)
    for got, ref in zip(grads, plain):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
