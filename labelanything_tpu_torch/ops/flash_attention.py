"""Decomposed relative-position attention for the SAM ViT encoder.

Counterpart of ``labelanything_tpu/ops/flash_attention.py``. Two kernels
written in CUDA C++ for Hopper (``csrc/relpos_global.cu`` and
``csrc/relpos_window.cu``) replace the TPU's Pallas forward kernels:

* :func:`flash_attention_relpos_lanes` - global blocks (N = 64 x 64 at
  1024 px), one block per (image, head, 64-row query tile), online softmax;
* :func:`flash_attention_relpos_lanes_batched` - windowed blocks
  (N = 14 x 14), one block per (window, head), K/V resident in shared
  memory, exact softmax.

Both keep the JAX signature ``(qkv, r, scale, grid_hw, heads)``:

* ``qkv`` (B, N, 3C): the qkv projection, channels laid out (3, heads, dh);
* ``r`` (B, N, heads * (kh + kw)): the factored bias, per head
  ``[rel_h (kh) | rel_w (kw)]``, already multiplied by log2(e);

and return (B, N, C) token-major. A CPU tensor goes to
:func:`relpos_attention_plain`, the plain PyTorch twin of the JAX
``_lanes_xla_ref``; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

LOG2E = 1.4426950408889634

# kernel launches since the last reset; each wrapper adds one per launch
LAUNCHES: Dict[str, int] = {"relpos_global": 0, "relpos_window": 0}

KERNEL_HEAD_DIM = 64  # head width the kernels are written for
_WINDOW_MAX_N = 256
_MAX_RR = 256     # kh + kw bound of the kernels' shared-memory r rows


def relpos_attention_plain(qkv: torch.Tensor, r: torch.Tensor, scale: float,
                           grid_hw: Tuple[int, int], heads: int) -> torch.Tensor:
    """softmax(q.k * scale + rel_h[q, ky] + rel_w[q, kx]) . v per head, as
    plain tensor ops (scores and softmax in fp32, P cast to v's dtype)."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    dh = c // heads
    kh, kw = grid_hw
    rr = kh + kw

    def split(x, width):
        return x.reshape(b, n, heads, width).transpose(1, 2)

    q = split(qkv[..., :c], dh)
    k = split(qkv[..., c:2 * c], dh)
    v = split(qkv[..., 2 * c:], dh)
    rb = split(r, rr).float() / LOG2E
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    bias = (rb[..., :kh, None] + rb[..., None, kh:]).reshape(s.shape)
    p = torch.softmax(s + bias, dim=-1).to(v.dtype)
    return torch.matmul(p, v).transpose(1, 2).reshape(b, n, c)


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


def _launch(entry: str, counter: str, qkv: torch.Tensor, r: torch.Tensor,
            scale: float, grid_hw: Tuple[int, int], heads: int) -> torch.Tensor:
    if qkv.device.type != "cuda":
        raise ValueError(f"the {counter} kernel needs a CUDA tensor, got "
                         f"{qkv.device}")
    if not (qkv.is_contiguous() and r.is_contiguous()):
        raise ValueError("qkv and r must be contiguous")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned")
    from . import _build

    lib = _build.load()
    b, n, c3 = qkv.shape
    kh, kw = grid_hw
    out = torch.empty((b, n, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            qkv.data_ptr(), r.data_ptr(), out.data_ptr(), b, n, heads, kh, kw,
            ctypes.c_float(scale), int(qkv.dtype == torch.bfloat16), stream)
    _build.check(lib, err, entry)
    LAUNCHES[counter] += 1
    return out


def flash_attention_relpos_lanes(qkv: torch.Tensor, r: torch.Tensor,
                                 scale: float, grid_hw: Tuple[int, int],
                                 heads: int) -> torch.Tensor:
    """Global-block rel-pos attention (kernel ``la_relpos_global``)."""
    _check(qkv, r, grid_hw, heads)
    if qkv.device.type == "cpu":
        return relpos_attention_plain(qkv, r, scale, grid_hw, heads)
    return _launch("la_relpos_global", "relpos_global", qkv, r, scale,
                   grid_hw, heads)


def flash_attention_relpos_lanes_batched(qkv: torch.Tensor, r: torch.Tensor,
                                         scale: float,
                                         grid_hw: Tuple[int, int],
                                         heads: int) -> torch.Tensor:
    """Windowed-block rel-pos attention over G windows of N <= 256 tokens
    (kernel ``la_relpos_window``)."""
    _check(qkv, r, grid_hw, heads, max_n=_WINDOW_MAX_N)
    if qkv.device.type == "cpu":
        return relpos_attention_plain(qkv, r, scale, grid_hw, heads)
    return _launch("la_relpos_window", "relpos_window", qkv, r, scale,
                   grid_hw, heads)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0
