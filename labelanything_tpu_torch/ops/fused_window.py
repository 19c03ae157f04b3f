"""The attention half of a windowed ViT block in one kernel (counterpart of
``labelanything_tpu/ops/fused_window.py``).

A windowed SAM block runs, after ``norm1``: pad to window multiples, the
window partition, the qkv projection, rel-pos attention in each window of
ws x ws tokens, the output projection, the unpartition, the crop and the
residual add. :func:`fused_window_attention` takes the padded map's qkv
projection and does the rest in one CUDA kernel (``csrc/fused_window.cu``):
it reads each window's q, k, v and bias rows straight from the spatial maps
by index (no partitioned copy exists), joins the heads of a query tile in
shared memory, applies the output projection and its bias in its own body,
adds the residual and writes the spatial map.

* :func:`fused_window_plain` is the same function in plain tensor code (the
  JAX ``_fused_window_xla_ref``): what the kernel is held against, what a
  CPU tensor takes, and what the backward differentiates.
* :func:`fused_window_ok` is the one rule that says which calls the kernel
  is compiled for; a caller routes by it, never by a failed build or launch.
  A call it refuses takes the unfused path, which computes the same
  function.
* :func:`fused_window_attention` is a ``torch.autograd.Function``: kernel
  forward on a CUDA tensor (or it raises), plain forward on a CPU tensor or
  inside :func:`.flash_attention.plain_attention`; the backward recomputes
  :func:`fused_window_plain` under autograd on any device, as the JAX
  ``_fw_bwd`` recomputes its XLA reference. Each launch adds one to
  ``flash_attention.LAUNCHES["fused_window"]``.

Layouts are the JAX function's, except the projection weight, which is
``nn.Linear``'s (C_out, C_in):

* ``x`` (B, Hp, Wp, C): the residual, padded to window multiples;
* ``qkv`` (B, Hp, Wp, 3C): the qkv projection of the padded normed map,
  channels laid out (3, heads, dh);
* ``r`` (B, heads, Hp, Wp, 2 ws): per head and position the factored bias
  ``[rel_h (ws) | rel_w (ws)]`` of the position's coordinates within its
  window, already multiplied by log2(e); it may be a strided view whose
  last axis is contiguous and whose rows follow the map's row-major order;
* ``w_proj`` (C, C) and ``b_proj`` (C,): the output projection.

The JAX Pallas body takes its softmax shift by Cauchy-Schwarz on the
concatenated operands ``[q | r] . [k | E]``, which can exceed the true
scores by far enough to underflow every exponential (ROADMAP C7); the port
is held to the function (the XLA reference and the unfused block), and its
kernel keeps an exact running max.
"""

from __future__ import annotations

import ctypes

import torch

from . import flash_attention as fa

# what csrc/fused_window.cu is compiled for
KERNEL_HEAD_DIMS = (64, 80)   # head widths
KERNEL_MAX_TOKENS = 256       # ws * ws, the keys of one window
KERNEL_MAX_WIDTH = 1280       # heads * head width
_MAX_GRID_Y = 65535


def fused_window_ok(device: torch.device, dtype: torch.dtype, heads: int,
                    head_dim: int, ws: int) -> bool:
    """Whether :func:`fused_window_attention` takes a call on the card: a
    pure function of device, dtype and shape. The kernel is compiled for
    heads 64 or 80 wide (ViT-B, ViT-L; ViT-H), a width that is a multiple
    of 64 up to ViT-H's 1280 (its shared-memory tile of a query block's
    joined heads), and windows of at most 256 tokens, in fp32 or bf16, on a
    CUDA device."""
    width = heads * head_dim
    return (device.type == "cuda"
            and dtype in (torch.float32, torch.bfloat16)
            and head_dim in KERNEL_HEAD_DIMS
            and width % 64 == 0 and 64 <= width <= KERNEL_MAX_WIDTH
            and 1 <= ws * ws <= KERNEL_MAX_TOKENS)


def _windows(a: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, Hp, Wp, ch) -> (B * nW, ws * ws, ch), windows in row-major order."""
    b, hp, wp, ch = a.shape
    a = a.reshape(b, hp // ws, ws, wp // ws, ws, ch)
    return a.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, ch)


def fused_window_plain(x: torch.Tensor, qkv: torch.Tensor, r: torch.Tensor,
                       w_proj: torch.Tensor, b_proj: torch.Tensor,
                       scale: float, heads: int, ws: int) -> torch.Tensor:
    """x + proj(window_attention(qkv)) as plain tensor ops (the JAX
    ``_fused_window_xla_ref``): scores and softmax in fp32 (fp64 for fp64
    inputs), P cast to v's dtype, the projection summed in fp32 with the
    bias and the residual, one rounding to x's dtype."""
    b, hp, wp, c = x.shape
    dh = c // heads
    nh, nw = hp // ws, wp // ws
    t = ws * ws
    qkv_w = _windows(qkv, ws).reshape(-1, t, 3, heads, dh)
    q, k, v = (qkv_w[:, :, i].transpose(1, 2) for i in range(3))
    r_w = (r.permute(0, 2, 3, 1, 4).reshape(b, hp, wp, heads * 2 * ws))
    r_w = _windows(r_w, ws).reshape(-1, t, heads, 2 * ws).transpose(1, 2)
    o = fa._attend(q, k, v, r_w, scale, (ws, ws))            # (BW, H, T, dh)
    o = o.transpose(1, 2).reshape(b, nh, nw, ws, ws, c)
    o = o.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
    ft = fa._float_type(x)
    y = torch.matmul(o.to(ft), w_proj.to(ft).t()) + b_proj.to(ft)
    return (y + x.to(ft)).to(x.dtype)


def _check(x: torch.Tensor, qkv: torch.Tensor, r: torch.Tensor,
           w_proj: torch.Tensor, b_proj: torch.Tensor, heads: int,
           ws: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, Hp, Wp, C), got {tuple(x.shape)}")
    b, hp, wp, c = x.shape
    if ws < 1 or hp % ws or wp % ws:
        raise ValueError(f"the map {hp} x {wp} is not padded to windows of "
                         f"{ws}")
    if heads < 1 or c % heads:
        raise ValueError(f"{heads} heads do not divide the width {c}")
    shapes = dict(qkv=(b, hp, wp, 3 * c), r=(b, heads, hp, wp, 2 * ws),
                  w_proj=(c, c), b_proj=(c,))
    for name, t in dict(qkv=qkv, r=r, w_proj=w_proj, b_proj=b_proj).items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")


def _launch(x: torch.Tensor, qkv: torch.Tensor, r: torch.Tensor,
            w_proj: torch.Tensor, b_proj: torch.Tensor, scale: float,
            heads: int, ws: int) -> torch.Tensor:
    """Kernel ``la_fused_window``: out (B, Hp, Wp, C), every position
    written, pad positions included."""
    b, hp, wp, c = x.shape
    dh = c // heads
    if not fused_window_ok(x.device, x.dtype, heads, dh, ws):
        raise ValueError(f"the fused_window kernel is not compiled for "
                         f"{x.dtype} on {x.device}, heads {dh} wide, "
                         f"window {ws}")
    for name, t in dict(x=x, qkv=qkv, w_proj=w_proj, b_proj=b_proj).items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if r.stride(4) != 1 or r.stride(2) != wp * r.stride(3):
        raise ValueError(f"r's rows must follow the map's row-major order "
                         f"with a contiguous last axis, got strides "
                         f"{r.stride()}")
    windows = b * (hp // ws) * (wp // ws)
    if windows > _MAX_GRID_Y:
        raise ValueError(f"at most {_MAX_GRID_Y} windows a call, got "
                         f"{windows}")
    # the kernel copies rows 16 bytes at a time
    for name, t in dict(x=x, qkv=qkv, w_proj=w_proj).items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    from . import _build

    lib = _build.load()
    out = torch.empty_like(x)
    strides = (ctypes.c_longlong * 3)(r.stride(0), r.stride(1), r.stride(3))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.la_fused_window(
            x.data_ptr(), qkv.data_ptr(), r.data_ptr(), w_proj.data_ptr(),
            b_proj.data_ptr(), out.data_ptr(), b, hp, wp, heads, dh, ws,
            ctypes.c_float(scale * fa.LOG2E), int(x.dtype == torch.bfloat16),
            strides, stream)
    _build.check(lib, err, "la_fused_window")
    fa.LAUNCHES["fused_window"] += 1
    return out


class FusedWindow(torch.autograd.Function):
    """``(x, qkv, r, w_proj, b_proj) -> out``: the kernel forward on a CUDA
    tensor, the plain forward on a CPU tensor or inside
    ``plain_attention()``; the backward recomputes :func:`fused_window_plain`
    under autograd on any device."""

    @staticmethod
    def forward(ctx, x, qkv, r, w_proj, b_proj, scale, heads, ws):
        ctx.args = (scale, heads, ws)
        ctx.save_for_backward(x, qkv, r, w_proj, b_proj)
        if fa._plain_requested or x.device.type == "cpu":
            return fused_window_plain(x, qkv, r, w_proj, b_proj, scale, heads,
                                      ws)
        return _launch(x, qkv, r, w_proj, b_proj, scale, heads, ws)

    @staticmethod
    def backward(ctx, dout):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = fused_window_plain(*inputs, *ctx.args)
        grads = torch.autograd.grad(out, inputs, dout)
        return (*grads, None, None, None)


def fused_window_attention(x: torch.Tensor, qkv: torch.Tensor,
                           r: torch.Tensor, w_proj: torch.Tensor,
                           b_proj: torch.Tensor, scale: float, heads: int,
                           ws: int) -> torch.Tensor:
    """x + proj(window rel-pos attention of qkv), (B, Hp, Wp, C), in x's
    dtype; operands as the module docstring lays them out, one dtype."""
    _check(x, qkv, r, w_proj, b_proj, heads, ws)
    return FusedWindow.apply(x, qkv, r, w_proj, b_proj, scale, heads, ws)


def window_bias(q: torch.Tensor, rel_pos_h: torch.Tensor,
                rel_pos_w: torch.Tensor, heads: int, ws: int
                ) -> torch.Tensor:
    """The factored bias ``r`` of :func:`fused_window_attention` from the
    padded map's queries ``q`` (B, Hp, Wp, C) and the window's rel-pos rows
    ``rel_pos_h``, ``rel_pos_w`` (ws, ws, dh) (``get_rel_pos(ws, ws, .)``):
    (B, heads, Hp, Wp, 2 ws), a view of a (B, Hp, Wp, heads, 2 ws) tensor,
    times log2(e)."""
    b, hp, wp, c = q.shape
    q7 = q.reshape(b, hp // ws, ws, wp // ws, ws, heads, c // heads)
    rel_h = torch.einsum("bAyBxnc,ykc->bAyBxnk", q7, rel_pos_h)
    rel_w = torch.einsum("bAyBxnc,xkc->bAyBxnk", q7, rel_pos_w)
    r = torch.cat([rel_h, rel_w], dim=-1) * fa.LOG2E
    return r.reshape(b, hp, wp, heads, 2 * ws).permute(0, 3, 1, 2, 4)

