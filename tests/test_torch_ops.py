"""The PyTorch port's ops against the JAX package's, on the CPU.

The rel-pos attention wrappers take their plain PyTorch twins for CPU
tensors; those twins are held against the JAX Pallas kernels in interpret
mode and against the JAX plain reference ``_lanes_xla_ref``. Inputs come
from seeded numpy arrays fed to both sides.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from labelanything_tpu.data.synthetic import random_batch as j_random_batch
from labelanything_tpu.data.synthetic import random_full_batch as j_full_batch
from labelanything_tpu.ops import flash_attention as jfa
from labelanything_tpu.ops.attention import dot_product_attention as j_attention
from labelanything_tpu.ops.image_norm import normalize_images as j_normalize
from labelanything_tpu.ops.resize import resize_bilinear as j_resize
from labelanything_tpu_torch.data.synthetic import (random_batch,
                                                    random_full_batch)
from labelanything_tpu_torch.ops import _build
from labelanything_tpu_torch.ops import flash_attention as tfa
from labelanything_tpu_torch.ops.attention import dot_product_attention
from labelanything_tpu_torch.ops.image_norm import maybe_normalize_images
from labelanything_tpu_torch.ops.resize import resize_bilinear
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _relpos_inputs(b, grid_hw, heads, seed):
    kh, kw = grid_hw
    n, c = kh * kw, heads * 64
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, n, 3 * c)).astype(np.float32)
    r = rng.standard_normal((b, n, heads * (kh + kw))).astype(np.float32)
    return qkv, r


def _pallas_interpret(fn, *args):
    """Run a JAX Pallas kernel in interpret mode with 256-row blocks, as
    the JAX package's own kernel tests do."""
    old = jfa._INTERPRET, jfa._BLOCK_Q, jfa._BLOCK_K
    jfa._INTERPRET, jfa._BLOCK_Q, jfa._BLOCK_K = True, 256, 256
    try:
        return jax.tree.map(np.asarray, fn(*args))
    finally:
        jfa._INTERPRET, jfa._BLOCK_Q, jfa._BLOCK_K = old


@pytest.mark.parametrize("kind,b,grid_hw,heads", [
    ("global", 2, (48, 16), 2),
    ("global", 2, (16, 48), 2),
    ("window", 4, (14, 14), 2),
])
def test_relpos_plain_twin_matches_jax(kind, b, grid_hw, heads):
    jfn, tfn = {
        "global": (jfa.flash_attention_relpos_lanes,
                   tfa.flash_attention_relpos_lanes),
        "window": (jfa.flash_attention_relpos_lanes_batched,
                   tfa.flash_attention_relpos_lanes_batched),
    }[kind]
    qkv, r = _relpos_inputs(b, grid_hw, heads, seed=9)
    scale = 64 ** -0.5
    ours = tfn(torch.from_numpy(qkv), torch.from_numpy(r), scale, grid_hw,
               heads).numpy()
    kernel = _pallas_interpret(jfn, jnp.asarray(qkv), jnp.asarray(r), scale,
                               grid_hw, heads)
    ref = np.asarray(jfa._lanes_xla_ref(jnp.asarray(qkv), jnp.asarray(r),
                                        scale, grid_hw, heads))
    np.testing.assert_allclose(ours, kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ours, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kind,b,grid_hw,heads", [
    ("global", 2, (48, 16), 2),
    ("global", 2, (16, 48), 2),
    ("window", 4, (14, 14), 2),
])
def test_relpos_plain_backward_matches_jax(kind, b, grid_hw, heads):
    """The plain backward twin (what the K3 / K4 kernels are held against
    on the card) against the JAX fused Pallas backward in interpret mode
    and against ``jax.vjp`` of ``_lanes_xla_ref``; rtol = atol = 2e-4, as
    the JAX package's own tests of those kernels. The wrappers' autograd
    on CPU tensors goes through the same twin."""
    jfn, tfn = {
        "global": (jfa.flash_attention_relpos_lanes,
                   tfa.flash_attention_relpos_lanes),
        "window": (jfa.flash_attention_relpos_lanes_batched,
                   tfa.flash_attention_relpos_lanes_batched),
    }[kind]
    qkv, r = _relpos_inputs(b, grid_hw, heads, seed=11)
    ct = np.random.default_rng(12).standard_normal(
        (b, qkv.shape[1], heads * 64)).astype(np.float32)
    scale = 64 ** -0.5

    def j_vjp(fn):
        def run(a, rr, g):
            return jax.vjp(lambda x, y: fn(x, y, scale, grid_hw, heads),
                           a, rr)[1](g)
        return run

    fused = _pallas_interpret(j_vjp(jfn), *map(jnp.asarray, (qkv, r, ct)))
    ref = j_vjp(jfa._lanes_xla_ref)(*map(jnp.asarray, (qkv, r, ct)))

    tq = torch.tensor(qkv, requires_grad=True)
    tr = torch.tensor(r, requires_grad=True)
    out = tfn(tq, tr, scale, grid_hw, heads)
    ours = torch.autograd.grad(out, (tq, tr), torch.from_numpy(ct))
    plain = tfa.relpos_attention_bwd_plain(
        tq.detach(), tr.detach(), out.detach(), torch.from_numpy(ct), scale,
        grid_hw, heads)
    for mine, twin, f, x in zip(ours, plain, fused, ref):
        assert torch.equal(mine, twin)
        assert np.abs(np.asarray(x)).max() > 1e-2    # r and its gradient count
        np.testing.assert_allclose(mine.numpy(), np.asarray(f), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(mine.numpy(), np.asarray(x), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("kernel,grid_hw", [("relpos_global", (3, 4)),
                                            ("relpos_window", (2, 3))])
def test_relpos_autograd_function(kernel, grid_hw):
    """``RelposAttention`` on the CPU route: ``gradcheck`` in fp64, and in
    fp32 the same gradients as autograd of the plain forward (1e-5: one
    takes the explicit formulas, the other PyTorch's)."""
    kh, kw = grid_hw
    heads, b = 2, 1
    rng = np.random.default_rng(3)
    qkv = rng.standard_normal((b, kh * kw, 3 * heads * 64))
    r = rng.standard_normal((b, kh * kw, heads * (kh + kw)))
    args = (0.125, grid_hw, heads)
    q64 = torch.tensor(qkv, requires_grad=True)
    r64 = torch.tensor(r, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, c: tfa.RelposAttention.apply(a, c, *args, kernel),
        (q64, r64))

    ct = torch.tensor(rng.standard_normal((b, kh * kw, heads * 64)),
                      dtype=torch.float32)
    grads = []
    for fn in (lambda a, c: tfa.RelposAttention.apply(a, c, *args, kernel),
               lambda a, c: tfa.relpos_attention_plain(a, c, *args)):
        q32 = torch.tensor(qkv, dtype=torch.float32, requires_grad=True)
        r32 = torch.tensor(r, dtype=torch.float32, requires_grad=True)
        # a strided cotangent, as a projection's backward may hand over
        out = fn(q32, r32)
        wide = torch.stack([ct, ct], dim=-1)[..., 0]
        assert not wide.is_contiguous()
        grads.append(torch.autograd.grad(out, (q32, r32), wide))
    for mine, auto in zip(*grads):
        torch.testing.assert_close(mine, auto, rtol=1e-5, atol=1e-5)


def test_relpos_cuda_route_never_falls_back():
    """Off the CPU the wrappers launch their kernels or raise: a tensor on
    another device type is refused, not sent to the plain twin."""
    qkv, r = _relpos_inputs(1, (4, 4), 2, seed=0)
    qkv, r = torch.from_numpy(qkv).to("meta"), torch.from_numpy(r).to("meta")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tfa.flash_attention_relpos_lanes(qkv, r, 0.125, (4, 4), 2)
    assert not tfa._plain_requested
    with tfa.plain_attention():
        assert tfa._plain_requested
    assert not tfa._plain_requested
    # the int8 score branch too, where its rule holds (an 8 x 8 grid)
    qkv, r = _relpos_inputs(1, (8, 8), 2, seed=0)
    qkv, r = torch.from_numpy(qkv).to("meta"), torch.from_numpy(r).to("meta")
    assert tfa.int8_scores_ok((8, 8), 64)
    with pytest.raises(ValueError, match="int8 kernel needs CUDA tensors"):
        tfa.flash_attention_relpos_lanes(qkv, r, 0.125, (8, 8), 2,
                                         int8_scores=True)
    assert sorted(tfa.LAUNCHES) == [
        "flash", "flash_mma", "fused_twoway", "fused_window", "relpos_global",
        "relpos_global_bwd", "relpos_global_int8", "relpos_packed_bf16exp",
        "relpos_packed_global", "relpos_packed_onehot",
        "relpos_packed_window", "relpos_window", "relpos_window_bwd"]


@pytest.mark.parametrize("fn", [tfa.flash_attention_relpos_lanes,
                                tfa.flash_attention_relpos_lanes_batched])
def test_relpos_wrappers_reject_bad_shapes(fn):
    qkv, r = _relpos_inputs(1, (4, 4), 2, seed=0)
    qkv, r = torch.from_numpy(qkv), torch.from_numpy(r)
    with pytest.raises(ValueError, match="head width"):
        fn(qkv[..., :3 * 2 * 32], r, 0.125, (4, 4), 2)   # dh = 32
    with pytest.raises(ValueError, match="kh \\* kw"):
        fn(qkv, r, 0.125, (4, 5), 2)
    with pytest.raises(TypeError):
        fn(qkv.double(), r.double(), 0.125, (4, 4), 2)


@pytest.mark.parametrize("dh,dtype,expected", [
    (32, torch.bfloat16, ("flash", "la_flash_wgmma")),   # the affinity call
    (64, torch.bfloat16, ("flash", "la_flash_wgmma")),
    (128, torch.bfloat16, ("flash_mma", "la_flash_attention")),
    (256, torch.bfloat16, ("flash_mma", "la_flash_attention")),
    (32, torch.float32, ("flash", "la_flash_attention")),
    (256, torch.float32, ("flash_mma", "la_flash_attention")),
])
def test_flash_kernel_route_by_head_width(dh, dtype, expected):
    """The flash kernel is chosen by head width and dtype before the
    launch, each route under its own launch counter."""
    assert tfa.flash_route(dh, dtype) == expected
    assert expected[0] in tfa.LAUNCHES
    assert (dh in tfa.WGMMA_HEAD_DIMS) == (expected[0] == "flash")


@pytest.mark.parametrize("grid_hw,expected", [
    ((14, 14), True),      # SAM's windows
    ((7, 7), True), ((3, 3), True), ((16, 16), True), ((1, 1), True),
    ((16, 9), True), ((14, 16), True), ((2, 12), True),
    ((17, 9), False),      # 17 rows of 16 slots: 272 > 256
    ((8, 17), False),      # a key-grid row wider than 16
    ((32, 8), False), ((1, 200), False),
])
def test_window_kernel_grid_rule(grid_hw, expected):
    """The windowed kernel lays keys out by key-grid rows of 8 or 16 slots,
    at most 256 of them: every window up to 16 x 16, ViT windows of 14 x 14
    among them."""
    assert tfa.window_grid_ok(grid_hw) is expected
    kh, kw = grid_hw
    if expected:
        width = 8 if kw <= 8 else 16
        assert kh * width <= 256


@pytest.mark.parametrize("dtype,dh,grid_hw,expected", [
    # ViT-H's global blocks at 1024 px, and the smallest grid taken
    (torch.bfloat16, 80, (64, 64), "packed_global_wgmma_kernel"),
    (torch.bfloat16, 80, (2, 64), "packed_global_wgmma_kernel"),
    (torch.bfloat16, 80, (8, 64), "packed_global_wgmma_kernel"),
    # rows 64 wide that the wgmma kernel refuses: kh odd (a ragged 128-row
    # block and key tile) or past 64
    (torch.bfloat16, 80, (7, 64), "packed_global_tc_kernel"),
    (torch.bfloat16, 80, (66, 64), "packed_global_tc_kernel"),
    # other rows (768 px: 48 x 48), another head width, fp32
    (torch.bfloat16, 80, (48, 48), "packed_global_tc_kernel"),
    (torch.bfloat16, 80, (64, 32), "packed_global_tc_kernel"),
    (torch.bfloat16, 64, (64, 64), "packed_global_tc_kernel"),
    (torch.float32, 80, (64, 64), "packed_kernel"),
])
def test_packed_global_kernel_rule(dtype, dh, grid_hw, expected):
    """The packed global route's kernel by dtype, head width and key grid:
    TMA and wgmma where a key tile is two whole key-grid rows and the
    128-row blocks are full, the mma.sync kernel for other bf16 calls."""
    assert tfa.packed_global_kernel(dtype, dh, grid_hw) == expected
    kh, kw = grid_hw
    if expected == "packed_global_wgmma_kernel":
        assert kw == 64 and kh * kw % 128 == 0
        assert dh in tfa.WGMMA_PACKED_HEAD_DIMS
    assert tfa.packed_route(kh * kw, grid_hw) == "relpos_packed_global"


@pytest.mark.parametrize("dtype,grid_hw,expected", [
    # ViT-B's and ViT-L's global blocks at 1024 px, and the smallest grid
    (torch.bfloat16, (64, 64), "packed_global_wgmma_kernel"),
    (torch.bfloat16, (2, 64), "packed_global_wgmma_kernel"),
    (torch.bfloat16, (16, 64), "packed_global_wgmma_kernel"),
    # rows 64 wide that the wgmma kernel refuses: kh odd or past 64
    (torch.bfloat16, (7, 64), "relpos_global_tc_kernel"),
    (torch.bfloat16, (66, 64), "relpos_global_tc_kernel"),
    # other rows (768 px: 48 x 48, the general bias path), fp32
    (torch.bfloat16, (48, 48), "relpos_global_tc_kernel"),
    (torch.bfloat16, (64, 32), "relpos_global_tc_kernel"),
    (torch.float32, (64, 64), "relpos_global_kernel"),
    (torch.float32, (7, 9), "relpos_global_kernel"),
])
def test_global_kernel_rule(dtype, grid_hw, expected):
    """The lanes global route's kernel by dtype and key grid: K5 global's
    TMA and wgmma template at head width 64 on exactly the grids the packed
    rule gives it at 80, the mma.sync kernel for other bf16 grids, the
    CUDA-core kernel in fp32."""
    assert tfa.global_kernel(dtype, grid_hw) == expected
    if dtype == torch.bfloat16:
        assert (expected == "packed_global_wgmma_kernel") == (
            tfa.packed_global_kernel(dtype, 80, grid_hw)
            == "packed_global_wgmma_kernel")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,grid_hw,heads", [(2, (8, 8), 3), (1, (4, 64), 2),
                                             (1, (64, 64), 1)])
def test_lanes_operands_as_packed_views(b, grid_hw, heads, dtype):
    """The layout the wgmma K1 reads: the token-major qkv (B, N, 3 heads 64)
    and r (B, N, heads (kh + kw)) viewed without a copy as the packed (B, 3
    heads, N, 64) and (B, heads, N, kh + kw), with the strides that
    la_relpos_global_wgmma hands the kernel, give through the packed twin
    what the lanes twin gives on the token-major tensors; the packed output
    laid out token-major is the lanes output."""
    kh, kw = grid_hw
    n, c, rr = kh * kw, heads * 64, kh + kw
    qkv_np, r_np = _relpos_inputs(b, grid_hw, heads, seed=7)
    qkv = torch.from_numpy(qkv_np).to(dtype)
    r = torch.from_numpy(0.5 * r_np).to(dtype)
    pq = qkv.view(b, n, 3 * heads, 64).permute(0, 2, 1, 3)
    pr = r.view(b, n, heads, rr).permute(0, 2, 1, 3)
    assert pq.data_ptr() == qkv.data_ptr() and pr.data_ptr() == r.data_ptr()
    assert pq.stride() == (3 * c * n, 64, 3 * c, 1)
    assert pr.stride() == (rr * heads * n, rr, rr * heads, 1)
    out = torch.empty(b, n, c, dtype=dtype)
    out_view = out.view(b, n, heads, 64).permute(0, 2, 1, 3)
    assert out_view.stride() == (c * n, 64, c, 1)
    scale = 64 ** -0.5
    out_view.copy_(tfa.relpos_packed_plain(pq, pr, scale, grid_hw, heads))
    torch.testing.assert_close(
        out, tfa.relpos_attention_plain(qkv, r, scale, grid_hw, heads),
        rtol=1e-6 if dtype == torch.float32 else 1e-12, atol=0)


def test_relpos_lse_plain_rebuilds_the_softmax():
    """The twin's log-sum-exp, in the log2 domain the global kernels write
    for the backward: 2^(scores - lse) are the twin's probabilities (rows
    summing to one, the output as the twin's), in fp64."""
    b, grid_hw, heads = 2, (6, 10), 3
    kh, kw = grid_hw
    n, c = kh * kw, heads * 64
    qkv_np, r_np = _relpos_inputs(b, grid_hw, heads, seed=9)
    qkv, r = torch.from_numpy(qkv_np).double(), torch.from_numpy(r_np).double()
    scale = 64 ** -0.5
    lse = tfa.relpos_lse_plain(qkv, r, scale, grid_hw, heads)
    assert lse.shape == (b, heads, n) and lse.dtype == torch.float32
    split = lambda x: x.reshape(b, n, heads, -1).transpose(1, 2)
    q, k, v, rb = (split(x) for x in (qkv[..., :c], qkv[..., c:2 * c],
                                      qkv[..., 2 * c:], r))
    s = torch.matmul(q, k.transpose(-1, -2)) * (scale * tfa.LOG2E)
    s += (rb[..., :kh, None] + rb[..., None, kh:]).reshape(s.shape)
    p = torch.exp2(s - lse.double()[..., None])
    torch.testing.assert_close(p.sum(-1), torch.ones_like(p[..., 0]),
                               rtol=0, atol=1e-6)
    out = torch.matmul(p, v).transpose(1, 2).reshape(b, n, c)
    torch.testing.assert_close(
        out, tfa.relpos_attention_plain(qkv, r, scale, grid_hw, heads),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype,grid_hw,expected", [
    (torch.bfloat16, (14, 14), "window"),    # SAM's windows, the step's
    (torch.bfloat16, (7, 7), "window"),      # key-grid rows of 8 slots
    (torch.bfloat16, (16, 16), "window"),    # the 256-token maximum
    (torch.bfloat16, (3, 3), "window"),
    (torch.float32, (14, 14), "f32"),
    (torch.float32, (16, 9), "f32"),
    (torch.bfloat16, (17, 9), None),         # past 16 x 16: raises
    (torch.float32, (8, 17), None),
])
def test_window_bwd_kernels_rule(dtype, grid_hw, expected):
    """The windowed backward's kernels by dtype: the delta pre-pass, then
    the query and key cuts on the slot layout in bf16 or the CUDA-core cuts
    in fp32; a window the forward refuses raises here too."""
    if expected is None:
        assert not tfa.window_grid_ok(grid_hw)
        with pytest.raises(ValueError, match="16 x 16"):
            tfa.window_bwd_kernels(dtype, grid_hw)
        return
    kernels = tfa.window_bwd_kernels(dtype, grid_hw)
    assert kernels[0] == "delta_kernel" and len(kernels) == 3
    assert kernels[1:] == (("window_dq_kernel", "window_dkv_kernel")
                           if expected == "window" else
                           ("bwd_dq_f32_kernel", "bwd_dkv_f32_kernel"))


def test_window_grid_outside_the_kernel_takes_the_twin_on_cpu():
    """A key grid the windowed kernel does not take still runs on the CPU
    (the plain twin), with the twin's result."""
    qkv, r = _relpos_inputs(2, (2, 20), 2, seed=3)
    qkv, r = torch.from_numpy(qkv), torch.from_numpy(r)
    assert not tfa.window_grid_ok((2, 20))
    out = tfa.flash_attention_relpos_lanes_batched(qkv, r, 0.125, (2, 20), 2)
    ref = tfa.relpos_attention_plain(qkv, r, 0.125, (2, 20), 2)
    assert torch.equal(out, ref)


def test_build_without_nvcc_raises_clear_error(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_cuda_home", lambda: None)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        _build.load()


def test_port_imports_no_jax():
    """The port, its slice modules and ``chip_smoke.py`` load neither JAX,
    flax, PIL, safetensors, PyYAML, click nor the JAX package itself, so
    the port runs where none of them is installed."""
    modules = ["labelanything_tpu_torch", "labelanything_tpu_torch.api",
               "labelanything_tpu_torch.data.synthetic",
               "labelanything_tpu_torch.models.registry",
               "labelanything_tpu_torch.ops.flash_attention",
               "labelanything_tpu_torch.ops.attention",
               "labelanything_tpu_torch.models.affinity_decoder",
               "labelanything_tpu_torch.models.transformer",
               "labelanything_tpu_torch.ops.fused_twoway",
               "labelanything_tpu_torch.ops.fused_window",
               "labelanything_tpu_torch.models.image_encoder",
               "labelanything_tpu_torch.ops.twoway_shared",
               "labelanything_tpu_torch.ops._build",
               "labelanything_tpu_torch.ops.time_kernels",
               "labelanything_tpu_torch.ops.time_paths",
               "labelanything_tpu_torch.ops.microbench_softmax_dtype",
               "labelanything_tpu_torch.models.build_encoder",
               "labelanything_tpu_torch.utils.weights",
               "labelanything_tpu_torch.train.losses",
               "labelanything_tpu_torch.train.optim",
               "labelanything_tpu_torch.train.metrics",
               "labelanything_tpu_torch.train.substitutor",
               "labelanything_tpu_torch.parallel.train_step",
               "labelanything_tpu_torch.utils.safetensors",
               "labelanything_tpu_torch.data.transforms",
               "labelanything_tpu_torch.data.embeddings",
               "labelanything_tpu_torch.preprocess",
               "labelanything_tpu_torch.inference",
               "labelanything_tpu_torch.train.checkpoint",
               # the training entry point and its episode engine
               "labelanything_tpu_torch.cli",
               "labelanything_tpu_torch.experiment",
               "labelanything_tpu_torch.experiment.run",
               "labelanything_tpu_torch.experiment.experiment",
               "labelanything_tpu_torch.utils.config",
               "labelanything_tpu_torch.utils.yaml_subset",
               "labelanything_tpu_torch.utils.logging",
               "labelanything_tpu_torch.data.rng",
               "labelanything_tpu_torch.data.schema",
               "labelanything_tpu_torch.data.rle",
               "labelanything_tpu_torch.data.examples",
               "labelanything_tpu_torch.data.coco",
               "labelanything_tpu_torch.data.coco20i",
               "labelanything_tpu_torch.data.dataset",
               "labelanything_tpu_torch.data.loader",
               "labelanything_tpu_torch.data.synthetic_coco",
               # the evaluation protocols and the PASCAL-5i engine
               "labelanything_tpu_torch.experiment.evaluate",
               "labelanything_tpu_torch.data.png",
               "labelanything_tpu_torch.data.pascal",
               "labelanything_tpu_torch.data.synthetic_voc",
               "labelanything_tpu_torch.data.test",
               # the images path: decoders, the cross-domain sets
               "labelanything_tpu_torch.data.jpeg",
               "labelanything_tpu_torch.data.tiff",
               "labelanything_tpu_torch.data.image_io",
               "labelanything_tpu_torch.data.crossdomain",
               "labelanything_tpu_torch.data.synthetic_crossdomain",
               # the ResNet / VGG baselines
               "labelanything_tpu_torch.models.ppnet",
               "labelanything_tpu_torch.models.denet",
               "labelanything_tpu_torch.models.bam",
               "labelanything_tpu_torch.models.hdmnet",
               "labelanything_tpu_torch.models.panet",
               # chip_smoke.py's golden replays
               "tests.torch_golden_replay"]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in modules)
            + "import numpy as np\n"
            + "from labelanything_tpu_torch.utils.weights import "
            + "state_dict_from_jax\n"
            + "sd = state_dict_from_jax({'params': {'neck': {'conv1': "
            + "{'kernel': np.zeros((1, 1, 2, 3), np.float32)}}}})\n"
            + "assert tuple(sd['neck.0.weight'].shape) == (3, 2, 1, 1), sd\n"
            + "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            + "       ('jax', 'flax', 'optax', 'PIL', 'safetensors',\n"
            + "        'yaml', 'click', 'labelanything_tpu')]\n"
            + "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    sources = [os.path.join(root, name) for root, _, files in os.walk(
        os.path.join(REPO, "labelanything_tpu_torch")) for name in files
        if name.endswith(".py")] + [os.path.join(REPO, "chip_smoke.py")]
    for path in sources:
        with open(path) as fh:
            text = fh.read()
        for line in text.splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in (
                    "jax", "flax", "optax", "PIL", "safetensors", "yaml",
                    "click", "labelanything_tpu"), (path, line)


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(batch_size=1, num_examples=5, num_classes=2, with_images=True,
         image_size=64, seed=1),
    dict(num_examples=2, num_classes=3, include_points=False, seed=4),
    dict(include_boxes=False, include_masks=False, gt_size=32, seed=5),
])
def test_random_batch_matches_jax_package(kwargs):
    """The port's episode generator gives the JAX package's episode."""
    ours = random_batch(**kwargs)
    ref = j_random_batch(**kwargs)
    assert sorted(ours) == sorted(ref)
    for key, value in ref.items():
        assert ours[key].dtype == value.dtype, key
        np.testing.assert_array_equal(ours[key], value, err_msg=key)
    ours, ref = random_full_batch(**kwargs), j_full_batch(**kwargs)
    assert sorted(ours) == sorted(ref)
    for key, value in ref.items():
        assert ours[key].dtype == value.dtype, key
        np.testing.assert_array_equal(ours[key], value, err_msg=key)


@pytest.mark.parametrize("in_hw,out_hw", [((13, 17), (29, 31)),
                                          ((64, 64), (16, 16)),
                                          ((30, 30), (120, 120))])
def test_resize_bilinear_matches_jax(in_hw, out_hw):
    x = np.random.default_rng(0).standard_normal((2, 3) + in_hw).astype(
        np.float32)
    ours = resize_bilinear(torch.from_numpy(x), out_hw).numpy()
    np.testing.assert_allclose(ours, np.asarray(j_resize(jnp.asarray(x),
                                                         out_hw)),
                               rtol=1e-5, atol=1e-5)
    xc = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    ours = resize_bilinear(torch.from_numpy(xc), out_hw,
                           spatial_axes=(1, 2)).numpy()
    ref = np.asarray(j_resize(jnp.asarray(xc), out_hw, spatial_axes=(1, 2)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("custom", [True, False])
def test_image_normalization_matches_jax(custom):
    rng = np.random.default_rng(21)
    images = rng.integers(0, 256, (2, 3, 64, 64, 3), dtype=np.uint8)
    dims = rng.integers(20, 200, (2, 3, 2)).astype(np.int32)
    ours = maybe_normalize_images(torch.from_numpy(images),
                                  torch.from_numpy(dims), 64, custom).numpy()
    ref = np.asarray(j_normalize(jnp.asarray(images), jnp.asarray(dims), 64,
                                 custom_preprocess=custom))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)
    floats = images.astype(np.float32)
    passed = maybe_normalize_images(torch.from_numpy(floats),
                                    torch.from_numpy(dims), 64, custom)
    np.testing.assert_array_equal(passed.numpy(), floats)


def test_attention_matches_jax():
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 4, n, 16)).astype(np.float32)
               for n in (9, 11, 11))
    ours = dot_product_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    ref = np.asarray(j_attention(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
