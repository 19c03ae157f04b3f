"""Decomposed relative-position attention for the SAM ViT encoder.

Counterpart of ``labelanything_tpu/ops/flash_attention.py``. Four kernels
written in CUDA C++ for Hopper replace the TPU's Pallas kernels:

* :func:`flash_attention_relpos_lanes` - global blocks (N = 64 x 64 at
  1024 px): forward ``csrc/relpos_global.cu`` (one block per (image, head,
  64-row query tile), online softmax), backward
  ``csrc/relpos_global_bwd.cu``;
* :func:`flash_attention_relpos_lanes_batched` - windowed blocks
  (N = 14 x 14): forward ``csrc/relpos_window.cu`` (one block per (window,
  head), K/V resident in shared memory), backward
  ``csrc/relpos_window_bwd.cu``.

Both keep the JAX signature ``(qkv, r, scale, grid_hw, heads)``:

* ``qkv`` (B, N, 3C): the qkv projection, channels laid out (3, heads, dh);
* ``r`` (B, N, heads * (kh + kw)): the factored bias, per head
  ``[rel_h (kh) | rel_w (kw)]``, already multiplied by log2(e);

return (B, N, C) token-major, and are differentiable in ``qkv`` and ``r``
(a ``torch.autograd.Function``, as ``jax.custom_vjp`` there). When a
gradient is wanted the forward kernel also writes every row's log-sum-exp,
(B, heads, N) fp32 in the log2 domain, which the backward kernel reads
instead of rebuilding the softmax denominator.

A CPU tensor goes to the plain PyTorch twins, :func:`relpos_attention_plain`
(the JAX ``_lanes_xla_ref``) and :func:`relpos_attention_bwd_plain`; a CUDA
tensor launches the kernels or raises. :func:`plain_attention` is a context
manager for callers that want the plain twins on the card by name, to
compare against; the package itself never enters it.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Iterator, Optional, Tuple

import torch

LOG2E = 1.4426950408889634

# kernel launches since the last reset; each wrapper adds one per launch
LAUNCHES: Dict[str, int] = {"relpos_global": 0, "relpos_window": 0,
                            "relpos_global_bwd": 0, "relpos_window_bwd": 0}

KERNEL_HEAD_DIM = 64  # head width the kernels are written for
_WINDOW_MAX_N = 256
_MAX_RR = 256     # kh + kw bound of the kernels' shared-memory r rows


def relpos_attention_plain(qkv: torch.Tensor, r: torch.Tensor, scale: float,
                           grid_hw: Tuple[int, int], heads: int) -> torch.Tensor:
    """softmax(q.k * scale + rel_h[q, ky] + rel_w[q, kx]) . v per head, as
    plain tensor ops (scores and softmax in fp32, or fp64 for fp64 inputs;
    P cast to v's dtype)."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    dh = c // heads
    kh, kw = grid_hw
    rr = kh + kw
    ft = torch.float64 if qkv.dtype == torch.float64 else torch.float32

    def split(x, width):
        return x.reshape(b, n, heads, width).transpose(1, 2)

    q = split(qkv[..., :c], dh)
    k = split(qkv[..., c:2 * c], dh)
    v = split(qkv[..., 2 * c:], dh)
    rb = split(r, rr).to(ft) / LOG2E
    s = torch.matmul(q.to(ft), k.to(ft).transpose(-1, -2)) * scale
    bias = (rb[..., :kh, None] + rb[..., None, kh:]).reshape(s.shape)
    p = torch.softmax(s + bias, dim=-1).to(v.dtype)
    return torch.matmul(p, v).transpose(1, 2).reshape(b, n, c)


def relpos_attention_bwd_plain(qkv: torch.Tensor, r: torch.Tensor,
                               out: torch.Tensor, dout: torch.Tensor,
                               scale: float, grid_hw: Tuple[int, int],
                               heads: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dqkv, dr) of :func:`relpos_attention_plain` by the explicit
    formulas, fp32 inside (fp64 for fp64 inputs):

        P = softmax(s);  dP = dO V^T;  dS = P * (dP - rowsum(dO * O))
        dQ = scale dS K;  dK = scale dS^T Q;  dV = P^T dO
        dr_h[q, ky] = sum_kx dS / log2e;  dr_w[q, kx] = sum_ky dS / log2e

    P and dS enter the three products rounded to the inputs' dtype, as the
    forward's P does (a no-op in fp32)."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    dh = c // heads
    kh, kw = grid_hw
    rr = kh + kw
    dt = qkv.dtype
    ft = torch.float64 if dt == torch.float64 else torch.float32

    def split(x, width):
        return x.reshape(b, n, heads, width).transpose(1, 2).to(ft)

    def merge(x):
        return x.transpose(1, 2).reshape(b, n, -1)

    q = split(qkv[..., :c], dh)
    k = split(qkv[..., c:2 * c], dh)
    v = split(qkv[..., 2 * c:], dh)
    o, do = split(out, dh), split(dout, dh)
    rb = split(r, rr) / LOG2E
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    s += (rb[..., :kh, None] + rb[..., None, kh:]).reshape(b, heads, n, n)
    p = torch.softmax(s, dim=-1)
    del s
    ds = torch.matmul(do, v.transpose(-1, -2))
    ds -= (do * o).sum(dim=-1, keepdim=True)
    ds *= p
    ds5 = ds.reshape(b, heads, n, kh, kw)
    dr = torch.cat([ds5.sum(dim=-1), ds5.sum(dim=-2)], dim=-1) / LOG2E
    p = p.to(dt).to(ft)
    ds = ds.to(dt).to(ft)
    dv = torch.matmul(p.transpose(-1, -2), do)
    del p
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    dqkv = torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1).to(dt)
    return dqkv, merge(dr).to(r.dtype)


# True only inside plain_attention()
_plain_requested = False


@contextlib.contextmanager
def plain_attention() -> Iterator[None]:
    """Inside this block the two attention functions use their plain twins
    (forward and backward) on any device and launch no kernel. For callers
    that hold the kernels against the plain versions on the card."""
    global _plain_requested
    old, _plain_requested = _plain_requested, True
    try:
        yield
    finally:
        _plain_requested = old


def _check(qkv: torch.Tensor, r: torch.Tensor, grid_hw: Tuple[int, int],
           heads: int, max_n: int = 0) -> None:
    if qkv.dim() != 3 or r.dim() != 3:
        raise ValueError(f"qkv and r must be 3-D, got {tuple(qkv.shape)} "
                         f"and {tuple(r.shape)}")
    b, n, c3 = qkv.shape
    kh, kw = grid_hw
    if c3 % (3 * heads):
        raise ValueError(f"qkv width {c3} is not 3 * heads * dh")
    dh = c3 // (3 * heads)
    if dh != KERNEL_HEAD_DIM:
        raise ValueError(f"head width must be {KERNEL_HEAD_DIM}, got {dh}")
    if n != kh * kw:
        raise ValueError(f"token count {n} != kh * kw = {kh} * {kw}")
    if kh + kw > _MAX_RR:
        raise ValueError(f"kh + kw = {kh + kw} exceeds {_MAX_RR}")
    if max_n and n > max_n:
        raise ValueError(f"windowed kernel takes at most {max_n} tokens, "
                         f"got {n}")
    if tuple(r.shape) != (b, n, heads * (kh + kw)):
        raise ValueError(f"r must be {(b, n, heads * (kh + kw))}, got "
                         f"{tuple(r.shape)}")
    if qkv.dtype not in (torch.float32, torch.bfloat16) or r.dtype != qkv.dtype:
        raise TypeError(f"qkv and r must share dtype fp32 or bf16, got "
                        f"{qkv.dtype} and {r.dtype}")
    if qkv.device != r.device:
        raise ValueError(f"qkv on {qkv.device}, r on {r.device}")


def _check_launch(kernel: str, **tensors: torch.Tensor) -> None:
    for name, x in tensors.items():
        if x.device.type != "cuda":
            raise ValueError(f"the {kernel} kernel needs CUDA tensors, got "
                             f"{name} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _launch(kernel: str, qkv: torch.Tensor, r: torch.Tensor, scale: float,
            grid_hw: Tuple[int, int], heads: int, want_lse: bool
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Forward kernel ``la_<kernel>``: (out, lse or None)."""
    _check_launch(kernel, qkv=qkv, r=r)
    from . import _build

    lib = _build.load()
    b, n, c3 = qkv.shape
    kh, kw = grid_hw
    out = torch.empty((b, n, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((b, heads, n), dtype=torch.float32, device=qkv.device)
           if want_lse else None)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, "la_" + kernel)(
            qkv.data_ptr(), r.data_ptr(), out.data_ptr(),
            lse.data_ptr() if want_lse else None, b, n, heads, kh, kw,
            ctypes.c_float(scale), int(qkv.dtype == torch.bfloat16), stream)
    _build.check(lib, err, "la_" + kernel)
    LAUNCHES[kernel] += 1
    return out, lse


def _launch_bwd(kernel: str, qkv: torch.Tensor, r: torch.Tensor,
                out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                scale: float, grid_hw: Tuple[int, int], heads: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward kernel ``la_<kernel>_bwd``: (dqkv, dr)."""
    name = kernel + "_bwd"
    _check_launch(name, qkv=qkv, r=r, out=out, dout=dout, lse=lse)
    if dout.dtype != qkv.dtype or dout.shape != out.shape:
        raise TypeError(f"dout must be {tuple(out.shape)} {qkv.dtype}, got "
                        f"{tuple(dout.shape)} {dout.dtype}")
    from . import _build

    lib = _build.load()
    b, n, _ = qkv.shape
    kh, kw = grid_hw
    dqkv, dr = torch.empty_like(qkv), torch.empty_like(r)
    delta = torch.empty_like(lse)   # rowsum(dout * out), the kernels' scratch
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, "la_" + name)(
            qkv.data_ptr(), r.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(), dr.data_ptr(),
            b, n, heads, kh, kw, ctypes.c_float(scale),
            int(qkv.dtype == torch.bfloat16), stream)
    _build.check(lib, err, "la_" + name)
    LAUNCHES[name] += 1
    return dqkv, dr


class RelposAttention(torch.autograd.Function):
    """``(qkv, r) -> out`` with the kernels' backward. ``kernel`` names the
    pair of kernels, ``relpos_global`` or ``relpos_window``. CPU tensors
    (and any tensor inside :func:`plain_attention`) take the plain twins."""

    @staticmethod
    def forward(ctx, qkv, r, scale, grid_hw, heads, kernel):
        ctx.args = (scale, tuple(grid_hw), heads)
        ctx.kernel = kernel
        ctx.plain = _plain_requested or qkv.device.type == "cpu"
        lse = None
        if ctx.plain:
            out = relpos_attention_plain(qkv, r, *ctx.args)
        else:
            out, lse = _launch(kernel, qkv, r, *ctx.args,
                               want_lse=any(ctx.needs_input_grad[:2]))
        ctx.save_for_backward(qkv, r, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, r, out, lse = ctx.saved_tensors
        # proj's backward may hand over a strided view
        dout = dout.contiguous()
        if ctx.plain:
            dqkv, dr = relpos_attention_bwd_plain(qkv, r, out, dout, *ctx.args)
        else:
            dqkv, dr = _launch_bwd(ctx.kernel, qkv, r, out, dout, lse,
                                   *ctx.args)
        return dqkv, dr, None, None, None, None


def flash_attention_relpos_lanes(qkv: torch.Tensor, r: torch.Tensor,
                                 scale: float, grid_hw: Tuple[int, int],
                                 heads: int) -> torch.Tensor:
    """Global-block rel-pos attention (kernels ``la_relpos_global`` and
    ``la_relpos_global_bwd``)."""
    _check(qkv, r, grid_hw, heads)
    return RelposAttention.apply(qkv, r, scale, grid_hw, heads,
                                 "relpos_global")


def flash_attention_relpos_lanes_batched(qkv: torch.Tensor, r: torch.Tensor,
                                         scale: float,
                                         grid_hw: Tuple[int, int],
                                         heads: int) -> torch.Tensor:
    """Windowed-block rel-pos attention over G windows of N <= 256 tokens
    (kernels ``la_relpos_window`` and ``la_relpos_window_bwd``)."""
    _check(qkv, r, grid_hw, heads, max_n=_WINDOW_MAX_N)
    return RelposAttention.apply(qkv, r, scale, grid_hw, heads,
                                 "relpos_window")


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0
