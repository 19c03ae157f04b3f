"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips without one.
The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from labelanything_tpu_torch.ops import flash_attention as fa

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


def test_kernel_rejects_bad_input(cuda):
    qkv, r = _inputs(1, (8, 8), 2, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_relpos_lanes(torch.cat([qkv, qkv], -1)[..., :384],
                                        r, 0.125, (8, 8), 2)
    with pytest.raises(TypeError):
        fa.flash_attention_relpos_lanes(qkv.half(), r.half(), 0.125, (8, 8), 2)


@pytest.mark.parametrize("kind,b,grid_hw,heads", CASES)
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


def test_backward_kernel_is_deterministic(cuda):
    """No atomics: two runs give bit-identical gradients."""
    qkv, r = _inputs(2, (32, 32), 4, torch.bfloat16, cuda)
    qkv.requires_grad_()
    r.requires_grad_()
    out = fa.flash_attention_relpos_lanes(qkv, r, 0.125, (32, 32), 4)
    ct = torch.ones_like(out)
    first = torch.autograd.grad(out, (qkv, r), ct, retain_graph=True)
    second = torch.autograd.grad(out, (qkv, r), ct)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_no_lse_without_grad_and_plain_by_name(cuda):
    qkv, r = _inputs(1, (8, 8), 2, torch.float32, cuda)
    fa.reset_launches()
    with fa.plain_attention():
        plain = fa.flash_attention_relpos_lanes(qkv, r, 0.125, (8, 8), 2)
    assert not any(fa.LAUNCHES.values())
    out = fa.flash_attention_relpos_lanes(qkv, r, 0.125, (8, 8), 2)
    assert fa.LAUNCHES["relpos_global"] == 1 and out.grad_fn is None
    torch.testing.assert_close(out, plain, rtol=1e-4, atol=1e-4)
