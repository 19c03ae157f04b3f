"""Attention kernels: the decomposed relative-position attention of the SAM
ViT encoder, and plain attention without a bias.

Counterpart of ``labelanything_tpu/ops/flash_attention.py``. Kernels written
in CUDA C++ for Hopper replace the TPU's Pallas kernels. For heads 64 wide
(ViT-B, ViT-L), on the token-major qkv projection:

* :func:`flash_attention_relpos_lanes` - global blocks (N = 64 x 64 at
  1024 px): forward ``csrc/relpos_global.cu`` (one block per (image, head,
  64-row query tile), online softmax), backward
  ``csrc/relpos_global_bwd.cu``. With ``int8_scores=True``, where the JAX
  package's rule sends its ``LA_TPU_INT8_SCORES`` flag
  (:func:`int8_scores_ok`), the forward takes the q . k scores in int8
  (``csrc/relpos_global_int8.cu``; plain twin
  :func:`relpos_attention_int8_plain`); its gradient is the full-precision
  one, with D = rowsum(dO . O) from the int8 output, as the JAX backward
  takes it;
* :func:`flash_attention_relpos_lanes_batched` - windowed blocks
  (N = 14 x 14, windows up to 16 x 16 on the card, :func:`window_grid_ok`):
  forward ``csrc/relpos_window.cu`` (keys laid out by key-grid rows in
  shared memory, a warp for each 16-row query tile, two blocks a (window,
  head) in bf16; fp32 in TF32 with the three-product split), backward
  ``csrc/relpos_window_bwd.cu`` (in bf16 a query cut and a key cut on the
  same slot layout, :func:`window_bwd_kernels`).

Both keep the JAX signature ``(qkv, r, scale, grid_hw, heads)``:

* ``qkv`` (B, N, 3C): the qkv projection, channels laid out (3, heads, dh);
* ``r`` (B, N, heads * (kh + kw)): the factored bias, per head
  ``[rel_h (kh) | rel_w (kw)]``, already multiplied by log2(e);

return (B, N, C) token-major, and are differentiable in ``qkv`` and ``r``
(a ``torch.autograd.Function``, as ``jax.custom_vjp`` there). When a
gradient is wanted the forward kernel also writes every row's log-sum-exp,
(B, heads, N) fp32 in the log2 domain, which the backward kernel reads
instead of rebuilding the softmax denominator.

For any other head width the kernels are compiled for (80: ViT-H), and for
callers that hold q, k and v apart:

* :func:`flash_attention_relpos_packed` - ``qkv`` (B, 3 heads, N, dh) with
  q, k, v of head h in slots h, heads + h, 2 heads + h, ``r`` (B, heads, N,
  kh + kw), returns (B, heads, N, dh); ``csrc/relpos_packed.cu``, the
  windowed kernel (the template of ``csrc/relpos_window.cuh`` that K2 also
  runs) for windows up to 16 x 16 (:func:`packed_route`) and the global
  one for any other grid, which in bf16 at heads 80 wide on key grids with
  rows 64 wide (ViT-H at 1024 px) runs on TMA and wgmma
  (``csrc/relpos_packed_sm90.cu``, :func:`packed_global_kernel`). The
  kernels take
  strides, so ``qkv`` may be the projection viewed token-major (no relayout
  copy), and the output then lies token-major too. Its backward is the
  plain one on any device, as in the JAX package;
* :func:`flash_attention_relpos` - q, k, v (BH, N, dh) apart with ``rel_h``
  and ``rel_w``: the one-head case of the packed function.

And without a bias, for any lengths:

* :func:`flash_attention` - softmax(q . k^T * scale) . v on q (B, H, Q, dh)
  and k, v (B, H, K, dh), dh 32, 64, 128 or 256, the kernel chosen by head
  width (:func:`flash_route`): in bf16, heads 32 or 64 wide take
  ``csrc/flash_wgmma.cu`` (TMA, wgmma, two consumer warpgroups in
  ping-pong; launch counter ``flash``) and 128 or 256 wide
  ``csrc/flash_attention.cu`` (mma.sync; ``flash_mma``), whose CUDA-core
  kernel takes fp32 at every width. The operands may be strided views with
  a contiguous last axis; the output lies token-major when q does. Its
  backward recomputes the plain twin under autograd on any device, as the
  JAX ``_bwd`` recomputes through XLA. ``ops/attention.py`` routes to it.

A CPU tensor goes to the plain PyTorch twins, :func:`relpos_attention_plain`
(the JAX ``_lanes_xla_ref``), :func:`relpos_packed_plain` (the JAX
``_packed_xla_ref``), :func:`flash_attention_plain` (the JAX ``_xla_ref``)
and their backwards; a CUDA tensor launches the kernels or raises.
:func:`plain_attention` is a context manager for callers that want the
plain twins on the card by name, to compare against; the package itself
never enters it.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Iterator, Optional, Tuple

import torch

LOG2E = 1.4426950408889634

# kernel launches since the last reset; each wrapper adds one per launch
LAUNCHES: Dict[str, int] = {"relpos_global": 0, "relpos_window": 0,
                            "relpos_global_bwd": 0, "relpos_window_bwd": 0,
                            "relpos_packed_global": 0,
                            "relpos_packed_window": 0,
                            # the microbench's variants of the packed kernel
                            "relpos_packed_onehot": 0,
                            "relpos_packed_bf16exp": 0,
                            # the whole two-way transformer (ops/fused_twoway)
                            "fused_twoway": 0,
                            # plain attention without a bias: heads 32 or
                            # 64 wide, then 128 or 256 wide
                            "flash": 0, "flash_mma": 0,
                            # the int8 score branch of the global kernel
                            "relpos_global_int8": 0,
                            # a windowed block's attention half
                            # (ops/fused_window)
                            "fused_window": 0}

# head width of the token-major (lanes) kernels; other widths go through
# flash_attention_relpos_packed
KERNEL_HEAD_DIM = 64
PACKED_HEAD_DIMS = (64, 80)  # head widths the packed kernels are compiled for
FLASH_HEAD_DIMS = (32, 64, 128, 256)  # and the plain flash kernels
# head widths of the Hopper flash kernel (wgmma, TMA); the others take the
# mma.sync kernel of flash_attention.cu
WGMMA_HEAD_DIMS = (32, 64)
# head widths of the packed global kernel on Hopper (TMA, wgmma:
# csrc/relpos_packed_sm90.cu); the others take the mma.sync kernel
WGMMA_PACKED_HEAD_DIMS = (80,)
_WINDOW_MAX_N = 256
_MAX_GRID_YZ = 65535  # CUDA's limit on a launch grid's y and z extents
_MAX_RR = 256     # kh + kw bound of the kernels' shared-memory r rows


def _float_type(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            r: torch.Tensor, scale: float, grid_hw: Tuple[int, int]
            ) -> torch.Tensor:
    """The plain forward on head-major operands: q, k, v (B, H, N, dh) and
    r (B, H, N, kh + kw), r times log2(e); (B, H, N, dh)."""
    kh, _ = grid_hw
    ft = _float_type(q)
    rb = r.to(ft) / LOG2E
    s = torch.matmul(q.to(ft), k.to(ft).transpose(-1, -2)) * scale
    bias = (rb[..., :kh, None] + rb[..., None, kh:]).reshape(s.shape)
    p = torch.softmax(s + bias, dim=-1).to(v.dtype)
    return torch.matmul(p, v)


def _attend_bwd(q, k, v, r, o, do, scale: float, grid_hw: Tuple[int, int],
                dt: torch.dtype):
    """(dq, dk, dv, dr) of :func:`_attend` by the explicit formulas, all
    operands head-major and already fp32 (fp64 for fp64 inputs):

        P = softmax(s);  dP = dO V^T;  dS = P * (dP - rowsum(dO * O))
        dQ = scale dS K;  dK = scale dS^T Q;  dV = P^T dO
        dr_h[q, ky] = sum_kx dS / log2e;  dr_w[q, kx] = sum_ky dS / log2e

    P and dS enter the three products rounded to ``dt``, the inputs' dtype,
    as the forward's P does (a no-op in fp32)."""
    kh, kw = grid_hw
    b, heads, n, _ = q.shape
    ft = q.dtype
    rb = r / LOG2E
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
    return dq, dk, dv, dr


def relpos_attention_plain(qkv: torch.Tensor, r: torch.Tensor, scale: float,
                           grid_hw: Tuple[int, int], heads: int) -> torch.Tensor:
    """softmax(q.k * scale + rel_h[q, ky] + rel_w[q, kx]) . v per head, as
    plain tensor ops (scores and softmax in fp32, or fp64 for fp64 inputs;
    P cast to v's dtype), on the token-major layout."""
    b, n, c3 = qkv.shape
    c = c3 // 3

    def split(x):
        return x.reshape(b, n, heads, -1).transpose(1, 2)

    out = _attend(split(qkv[..., :c]), split(qkv[..., c:2 * c]),
                  split(qkv[..., 2 * c:]), split(r), scale, grid_hw)
    return out.transpose(1, 2).reshape(b, n, c)


def vpu_bias_ok(kh: int, kw: int, n: int, block_k: int) -> bool:
    """The JAX package's precondition of its VPU bias loop, where the int8
    score branch lives (copied, ``flash_attention.py:236``)."""
    return kh * kw == n and block_k % kw == 0 and kw >= 8


def int8_scores_ok(grid_hw: Tuple[int, int], n: int) -> bool:
    """Whether the int8 score flag takes effect for a global block of n
    tokens on a (kh, kw) key grid, by the JAX package's rule: the global
    blocks of ViT-B and ViT-L at 1024 px (64 x 64) qualify, a 48 x 48 grid
    does not."""
    kh, kw = grid_hw
    # the key block of the JAX _pick_blocks_long; its query block plays no
    # part in the rule
    block_k = 256 if n % 256 == 0 else n
    return vpu_bias_ok(kh, kw, n, block_k)


def _quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 codes of each row of fp32 ``x`` (as fp32 integers)
    and the rows' scales max|x| / 127, as the JAX ``_bias_loop_vpu``
    quantizes: round half to even, the scale held above 1e-30. Both
    divisions are true divisions by tensors: on the card a Python-scalar
    divisor becomes a product with its rounded reciprocal, which moves a
    scale by an ulp and can flip a code."""
    m = x.abs().amax(dim=-1, keepdim=True)
    s = m / torch.full_like(m, 127.0)
    return torch.round(x / torch.clamp(s, min=1e-30)), s


def relpos_attention_int8_plain(qkv: torch.Tensor, r: torch.Tensor,
                                scale: float, grid_hw: Tuple[int, int],
                                heads: int) -> torch.Tensor:
    """:func:`relpos_attention_plain` with the q . k scores taken in int8
    (the JAX ``_bias_loop_vpu(int8_scores=True)``): q is fp32(q) * scale *
    log2(e) and k fp32(k), each quantized per row and head; the score is
    float(q8 . k8) * sq * sk, exact in fp32 (64 * 127^2 < 2^24), plus the
    bias in the log2 domain; softmax by exp2, P cast to v's dtype."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    kh, _ = grid_hw

    def split(x):
        return x.reshape(b, n, heads, -1).transpose(1, 2)

    q8, sq = _quantize_rows(split(qkv[..., :c]).float() * (scale * LOG2E))
    k8, sk = _quantize_rows(split(qkv[..., c:2 * c]).float())
    v = split(qkv[..., 2 * c:])
    rb = split(r).float()
    s = torch.matmul(q8, k8.transpose(-1, -2)) * (sq * sk.transpose(-1, -2))
    s += (rb[..., :kh, None] + rb[..., None, kh:]).reshape(s.shape)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    p /= p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype), v)
    return out.transpose(1, 2).reshape(b, n, c)


def relpos_attention_bwd_plain(qkv: torch.Tensor, r: torch.Tensor,
                               out: torch.Tensor, dout: torch.Tensor,
                               scale: float, grid_hw: Tuple[int, int],
                               heads: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dqkv, dr) of :func:`relpos_attention_plain` (see
    :func:`_attend_bwd`)."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    ft = _float_type(qkv)

    def split(x):
        return x.reshape(b, n, heads, -1).transpose(1, 2).to(ft)

    def merge(x):
        return x.transpose(1, 2).reshape(b, n, -1)

    dq, dk, dv, dr = _attend_bwd(
        split(qkv[..., :c]), split(qkv[..., c:2 * c]), split(qkv[..., 2 * c:]),
        split(r), split(out), split(dout), scale, grid_hw, qkv.dtype)
    dqkv = torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1).to(qkv.dtype)
    return dqkv, merge(dr).to(r.dtype)


def relpos_packed_plain(qkv: torch.Tensor, r: torch.Tensor, scale: float,
                        grid_hw: Tuple[int, int], heads: int) -> torch.Tensor:
    """The same function on the packed layout (the JAX ``_packed_xla_ref``):
    qkv (B, 3 heads, N, dh), r (B, heads, N, kh + kw); (B, heads, N, dh)."""
    return _attend(qkv[:, :heads], qkv[:, heads:2 * heads],
                   qkv[:, 2 * heads:], r, scale, grid_hw)


def relpos_packed_bwd_plain(qkv: torch.Tensor, r: torch.Tensor,
                            out: torch.Tensor, dout: torch.Tensor,
                            scale: float, grid_hw: Tuple[int, int],
                            heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dqkv, dr) of :func:`relpos_packed_plain` (see :func:`_attend_bwd`).
    It materialises (B, heads, N, N) arrays in fp32: 1 GiB each for one
    ViT-H image at 1024 px."""
    ft = _float_type(qkv)
    dq, dk, dv, dr = _attend_bwd(
        qkv[:, :heads].to(ft), qkv[:, heads:2 * heads].to(ft),
        qkv[:, 2 * heads:].to(ft), r.to(ft), out.to(ft), dout.to(ft), scale,
        grid_hw, qkv.dtype)
    return torch.cat([dq, dk, dv], dim=1).to(qkv.dtype), dr.to(r.dtype)


# True only inside plain_attention()
_plain_requested = False


@contextlib.contextmanager
def plain_attention() -> Iterator[None]:
    """Inside this block the attention functions use their plain twins
    (forward and backward) on any device and launch no kernel. For callers
    that hold the kernels against the plain versions on the card."""
    global _plain_requested
    old, _plain_requested = _plain_requested, True
    try:
        yield
    finally:
        _plain_requested = old


def _check_operands(qkv: torch.Tensor, r: torch.Tensor, n: int,
                    grid_hw: Tuple[int, int], r_shape: Tuple[int, ...]
                    ) -> None:
    """What both layouts ask of qkv and r."""
    kh, kw = grid_hw
    if n != kh * kw:
        raise ValueError(f"token count {n} != kh * kw = {kh} * {kw}")
    if kh + kw > _MAX_RR:
        raise ValueError(f"kh + kw = {kh + kw} exceeds {_MAX_RR}")
    if tuple(r.shape) != r_shape:
        raise ValueError(f"r must be {r_shape}, got {tuple(r.shape)}")
    if qkv.dtype not in (torch.float32, torch.bfloat16) or r.dtype != qkv.dtype:
        raise TypeError(f"qkv and r must share dtype fp32 or bf16, got "
                        f"{qkv.dtype} and {r.dtype}")
    if qkv.device != r.device:
        raise ValueError(f"qkv on {qkv.device}, r on {r.device}")


def _check(qkv: torch.Tensor, r: torch.Tensor, grid_hw: Tuple[int, int],
           heads: int, max_n: int = 0) -> None:
    if qkv.dim() != 3 or r.dim() != 3:
        raise ValueError(f"qkv and r must be 3-D, got {tuple(qkv.shape)} "
                         f"and {tuple(r.shape)}")
    b, n, c3 = qkv.shape
    if c3 % (3 * heads):
        raise ValueError(f"qkv width {c3} is not 3 * heads * dh")
    dh = c3 // (3 * heads)
    if dh != KERNEL_HEAD_DIM:
        raise ValueError(f"head width must be {KERNEL_HEAD_DIM}, got {dh}; "
                         f"flash_attention_relpos_packed takes other widths")
    if max_n and n > max_n:
        raise ValueError(f"windowed kernel takes at most {max_n} tokens, "
                         f"got {n}")
    _check_operands(qkv, r, n, grid_hw, (b, n, heads * sum(grid_hw)))


def window_grid_ok(grid_hw: Tuple[int, int]) -> bool:
    """Whether the windowed kernel takes a (kh, kw) key grid: it lays keys
    out by key-grid rows of 8 or 16 slots, for windows up to 16 x 16."""
    kh, kw = grid_hw
    return kh <= 16 and kw <= 16


def packed_route(n: int, grid_hw: Tuple[int, int]) -> str:
    """The packed kernel (its ``LAUNCHES`` key and C entry without ``la_``)
    for n tokens on a (kh, kw) key grid: the windowed kernel where it takes
    the grid (n <= 256 and :func:`window_grid_ok`), else the global one,
    which takes any n."""
    if n <= _WINDOW_MAX_N and window_grid_ok(grid_hw):
        return "relpos_packed_window"
    return "relpos_packed_global"


def packed_global_kernel(dtype: torch.dtype, dh: int,
                         grid_hw: Tuple[int, int]) -> str:
    """The CUDA kernel that the packed global route runs, by its name in a
    profiler trace: ``packed_global_wgmma_kernel`` (TMA and wgmma,
    ``la_relpos_packed_global_wgmma``) in bf16 at a head width of
    :data:`WGMMA_PACKED_HEAD_DIMS` on a key grid whose rows are 64 wide with
    kh even from 2 to 64 (ViT-H at 1024 px: 64 x 64), so that its key
    tiles are whole key-grid rows (two a tile) and its 128-row blocks are
    full;
    ``packed_global_tc_kernel`` (mma.sync, ``la_relpos_packed_global``) in
    bf16 otherwise; ``packed_kernel`` (CUDA cores) in fp32."""
    kh, kw = grid_hw
    if dtype != torch.bfloat16:
        return "packed_kernel"
    if (dh in WGMMA_PACKED_HEAD_DIMS and kw == 64 and kh % 2 == 0
            and 2 <= kh <= 64):
        return "packed_global_wgmma_kernel"
    return "packed_global_tc_kernel"


def window_bwd_kernels(dtype: torch.dtype, grid_hw: Tuple[int, int]
                       ) -> Tuple[str, str, str]:
    """The CUDA kernels of the windowed backward (``la_relpos_window_bwd``)
    by their names in a profiler trace: the delta pre-pass, the query cut
    (dQ, dr) and the key cut (dK, dV). bf16 takes the cuts on the forward's
    slot layout, ``window_dq_kernel`` and ``window_dkv_kernel``; fp32 the
    CUDA-core cuts of the global backward. A window past 16 x 16 raises, as
    the forward does (:func:`window_grid_ok`)."""
    if not window_grid_ok(grid_hw):
        raise ValueError(f"the windowed kernels take windows up to 16 x 16, "
                         f"got {tuple(grid_hw)}")
    if dtype == torch.bfloat16:
        return ("delta_kernel", "window_dq_kernel", "window_dkv_kernel")
    return ("delta_kernel", "bwd_dq_f32_kernel", "bwd_dkv_f32_kernel")


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
    if kernel == "relpos_window" and not window_grid_ok(grid_hw):
        raise ValueError(f"the windowed kernel takes windows up to 16 x 16, "
                         f"got {tuple(grid_hw)}")
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


def _launch_int8(qkv: torch.Tensor, r: torch.Tensor, scale: float,
                 grid_hw: Tuple[int, int], heads: int) -> torch.Tensor:
    """Kernel ``la_relpos_global_int8``: out (B, N, C). q's scale is
    rounded to fp32 here, as the plain twin rounds it, so both quantize q
    to the same codes."""
    _check_launch("relpos_global_int8", qkv=qkv, r=r)
    from . import _build

    lib = _build.load()
    b, n, c3 = qkv.shape
    kh, kw = grid_hw
    out = torch.empty((b, n, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.la_relpos_global_int8(
            qkv.data_ptr(), r.data_ptr(), out.data_ptr(), b, n, heads, kh, kw,
            ctypes.c_float(scale * LOG2E), int(qkv.dtype == torch.bfloat16),
            stream)
    _build.check(lib, err, "la_relpos_global_int8")
    LAUNCHES["relpos_global_int8"] += 1
    return out


def _launch_bwd(kernel: str, qkv: torch.Tensor, r: torch.Tensor,
                out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                scale: float, grid_hw: Tuple[int, int], heads: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward kernel ``la_<kernel>_bwd``: (dqkv, dr)."""
    name = kernel + "_bwd"
    _check_launch(name, qkv=qkv, r=r, out=out, dout=dout, lse=lse)
    if kernel == "relpos_window":
        window_bwd_kernels(qkv.dtype, grid_hw)
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
    pair of kernels, ``relpos_global`` or ``relpos_window``; ``int8`` takes
    the global forward with int8 scores, whose backward is the full-precision
    one: it reads the log-sum-exp of the full-precision forward kernel, run
    again for it when a gradient is wanted, and the int8 output for
    rowsum(dO . O). CPU tensors (and any tensor inside
    :func:`plain_attention`) take the plain twins."""

    @staticmethod
    def forward(ctx, qkv, r, scale, grid_hw, heads, kernel, int8=False):
        ctx.args = (scale, tuple(grid_hw), heads)
        ctx.kernel = kernel
        ctx.plain = _plain_requested or qkv.device.type == "cpu"
        want_lse = any(ctx.needs_input_grad[:2])
        lse = None
        if ctx.plain:
            plain = relpos_attention_int8_plain if int8 else \
                relpos_attention_plain
            out = plain(qkv, r, *ctx.args)
        elif int8:
            out = _launch_int8(qkv, r, *ctx.args)
            if want_lse:
                _, lse = _launch(kernel, qkv, r, *ctx.args, want_lse=True)
        else:
            out, lse = _launch(kernel, qkv, r, *ctx.args, want_lse=want_lse)
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
        return dqkv, dr, None, None, None, None, None


def flash_attention_relpos_lanes(qkv: torch.Tensor, r: torch.Tensor,
                                 scale: float, grid_hw: Tuple[int, int],
                                 heads: int, int8_scores: bool = False
                                 ) -> torch.Tensor:
    """Global-block rel-pos attention (kernels ``la_relpos_global`` and
    ``la_relpos_global_bwd``; with ``int8_scores``, where
    :func:`int8_scores_ok` admits the grid, ``la_relpos_global_int8``
    forward)."""
    _check(qkv, r, grid_hw, heads)
    int8 = int8_scores and int8_scores_ok(grid_hw, qkv.shape[1])
    return RelposAttention.apply(qkv, r, scale, grid_hw, heads,
                                 "relpos_global", int8)


def flash_attention_relpos_lanes_batched(qkv: torch.Tensor, r: torch.Tensor,
                                         scale: float,
                                         grid_hw: Tuple[int, int],
                                         heads: int) -> torch.Tensor:
    """Windowed-block rel-pos attention over G windows of N <= 256 tokens
    (kernels ``la_relpos_window`` and ``la_relpos_window_bwd``)."""
    _check(qkv, r, grid_hw, heads, max_n=_WINDOW_MAX_N)
    return RelposAttention.apply(qkv, r, scale, grid_hw, heads,
                                 "relpos_window")


def _check_packed(qkv: torch.Tensor, r: torch.Tensor,
                  grid_hw: Tuple[int, int], heads: int) -> None:
    if qkv.dim() != 4 or r.dim() != 4:
        raise ValueError(f"qkv and r must be 4-D, got {tuple(qkv.shape)} "
                         f"and {tuple(r.shape)}")
    b, slots, n, _ = qkv.shape
    if slots != 3 * heads:
        raise ValueError(f"qkv has {slots} slots, expected 3 * heads = "
                         f"{3 * heads}")
    _check_operands(qkv, r, n, grid_hw, (b, heads, n, sum(grid_hw)))


def _token_major(x: torch.Tensor) -> bool:
    """Whether a (B, slots, N, dh) tensor keeps a token's slots together,
    as the qkv projection does."""
    return x.stride(1) < x.stride(2)


def _launch_packed(kernel: str, qkv: torch.Tensor, r: torch.Tensor,
                   scale: float, grid_hw: Tuple[int, int], heads: int,
                   route: bool = True) -> torch.Tensor:
    """Packed kernel ``la_<kernel>`` on strided operands: out (B, heads, N,
    dh), laid out token-major when ``qkv`` is. With ``route``, the global
    kernel goes where :func:`packed_global_kernel` says; without it,
    ``la_relpos_packed_global`` (the mma.sync kernel) takes every grid."""
    b, _, n, dh = qkv.shape
    kh, kw = grid_hw
    for name, x in (("qkv", qkv), ("r", r)):
        if x.device.type != "cuda":
            raise ValueError(f"the {kernel} kernel needs CUDA tensors, got "
                             f"{name} on {x.device}")
        if x.stride(3) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous")
    if dh not in PACKED_HEAD_DIMS:
        raise ValueError(f"head width must be one of {PACKED_HEAD_DIMS}, got "
                         f"{dh}")
    if b > _MAX_GRID_YZ:
        raise ValueError(f"at most {_MAX_GRID_YZ} images or windows a call, "
                         f"got {b}")
    # the kernels copy q, k, v rows 16 bytes at a time
    per16 = 16 // qkv.element_size()
    if qkv.data_ptr() % 16 or any(s % per16 for s in qkv.stride()[:3]):
        raise ValueError(f"qkv rows must be 16-byte aligned, got strides "
                         f"{qkv.stride()}")
    from . import _build

    lib = _build.load()
    if _token_major(qkv):
        out = torch.empty((b, n, heads, dh), dtype=qkv.dtype,
                          device=qkv.device).permute(0, 2, 1, 3)
    else:
        out = torch.empty((b, heads, n, dh), dtype=qkv.dtype,
                          device=qkv.device)
    strides = (ctypes.c_longlong * 9)(*qkv.stride()[:3], *r.stride()[:3],
                                      *out.stride()[:3])
    entry = "la_" + kernel
    if (route and kernel == "relpos_packed_global" and packed_global_kernel(
            qkv.dtype, dh, grid_hw) == "packed_global_wgmma_kernel"):
        entry = "la_relpos_packed_global_wgmma"
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            qkv.data_ptr(), r.data_ptr(), out.data_ptr(), b, n, heads, kh, kw,
            dh, ctypes.c_float(scale), int(qkv.dtype == torch.bfloat16),
            strides, stream)
    _build.check(lib, err, entry)
    LAUNCHES[kernel] += 1
    return out


class RelposPackedAttention(torch.autograd.Function):
    """``(qkv, r) -> out`` on the packed layout: the kernel forward
    (:func:`packed_route`: ``la_relpos_packed_window`` for windows up to
    16 x 16, else ``la_relpos_packed_global``) and the plain backward
    (:func:`relpos_packed_bwd_plain`) on any device: the JAX package has no
    backward kernel for this layout either, its backward recomputes the
    plain formula. CPU tensors (and any tensor inside
    :func:`plain_attention`) take the plain forward."""

    @staticmethod
    def forward(ctx, qkv, r, scale, grid_hw, heads):
        ctx.args = (scale, tuple(grid_hw), heads)
        if _plain_requested or qkv.device.type == "cpu":
            out = relpos_packed_plain(qkv, r, *ctx.args)
        else:
            out = _launch_packed(packed_route(qkv.shape[2], grid_hw), qkv, r,
                                 *ctx.args)
        ctx.save_for_backward(qkv, r, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, r, out = ctx.saved_tensors
        dqkv, dr = relpos_packed_bwd_plain(qkv, r, out, dout, *ctx.args)
        return dqkv, dr, None, None, None


def flash_attention_relpos_packed(qkv: torch.Tensor, r: torch.Tensor,
                                  scale: float, grid_hw: Tuple[int, int],
                                  heads: int) -> torch.Tensor:
    """Rel-pos attention on the packed layout, any head width the kernels
    are compiled for (:data:`PACKED_HEAD_DIMS`): ``qkv`` (B, 3 heads, N, dh)
    with slot ``t * heads + h`` holding tensor t (q, k, v) of head h, ``r``
    (B, heads, N, kh + kw) times log2(e); returns (B, heads, N, dh). Both
    may be strided views with a contiguous last axis."""
    _check_packed(qkv, r, grid_hw, heads)
    return RelposPackedAttention.apply(qkv, r, scale, grid_hw, heads)


def flash_attention_relpos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           rel_h: torch.Tensor, rel_w: torch.Tensor,
                           scale: float, grid_hw: Tuple[int, int]
                           ) -> torch.Tensor:
    """The same attention on q, k, v (BH, N, dh) held apart, with the
    factored biases ``rel_h`` (BH, N, kh) and ``rel_w`` (BH, N, kw)
    unscaled: the one-head case of :func:`flash_attention_relpos_packed`."""
    if not q.shape == k.shape == v.shape:
        raise ValueError(f"q, k and v must share one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    qkv = torch.stack([q, k, v], dim=1)
    r = (torch.cat([rel_h, rel_w], dim=-1).to(_float_type(q))
         * LOG2E).to(q.dtype)
    return flash_attention_relpos_packed(qkv, r[:, None], scale, grid_hw,
                                         1)[:, 0]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """softmax(q . k^T * scale) . v on (B, H, N, dh) operands as plain tensor
    ops (the JAX ``_xla_ref``): scores and softmax in fp32 (fp64 for fp64
    inputs), the probabilities cast to v's dtype."""
    ft = _float_type(q)
    s = torch.matmul(q.to(ft), k.to(ft).transpose(-1, -2)) * scale
    return torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)


def flash_route(dh: int, dtype: torch.dtype) -> Tuple[str, str]:
    """(``LAUNCHES`` key, C entry) of the flash kernel for a head width and
    dtype, chosen before the launch: heads 32 or 64 wide count under
    ``flash``, in bf16 on the Hopper kernel (``la_flash_wgmma``); heads 128
    or 256 wide under ``flash_mma``, in bf16 on the mma.sync kernel; fp32
    takes the CUDA-core kernel (``la_flash_attention``) at every width."""
    key = "flash" if dh in WGMMA_HEAD_DIMS else "flash_mma"
    entry = ("la_flash_wgmma" if key == "flash" and dtype == torch.bfloat16
             else "la_flash_attention")
    return key, entry


def _launch_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """The flash kernel of :func:`flash_route` on strided operands: out (B,
    H, Q, dh), laid out token-major when ``q`` is."""
    b, heads, nq, dh = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(f"the flash kernel needs CUDA tensors, got "
                             f"{name} on {x.device}")
        if x.stride(3) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous")
        # the bf16 kernel copies rows 16 bytes at a time
        per16 = 16 // x.element_size()
        if x.dtype == torch.bfloat16 and (
                x.data_ptr() % 16 or any(st % per16 for st in x.stride()[:3])):
            raise ValueError(f"{name}'s rows must be 16-byte aligned, got "
                             f"strides {x.stride()}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the flash kernel takes fp32 or bf16, got {q.dtype}")
    if dh not in FLASH_HEAD_DIMS:
        raise ValueError(f"head width must be one of {FLASH_HEAD_DIMS}, got "
                         f"{dh}")
    if max(b, heads) > _MAX_GRID_YZ:
        raise ValueError(f"at most {_MAX_GRID_YZ} batches and heads a call, "
                         f"got {b} and {heads}")
    from . import _build

    lib = _build.load()
    if _token_major(q):
        out = torch.empty((b, nq, heads, dh), dtype=q.dtype,
                          device=q.device).permute(0, 2, 1, 3)
    else:
        out = torch.empty((b, heads, nq, dh), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    key, entry = flash_route(dh, q.dtype)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
            heads, nq, k.shape[2], dh, ctypes.c_float(scale)]
    if entry == "la_flash_attention":
        args.append(int(q.dtype == torch.bfloat16))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(*args, strides, stream)
    _build.check(lib, err, entry)
    LAUNCHES[key] += 1
    return out


class FlashAttention(torch.autograd.Function):
    """``(q, k, v) -> out``: the kernel forward and the plain backward,
    :func:`flash_attention_plain` recomputed under autograd, on any device
    (the JAX package has no backward kernel for it either). CPU tensors
    (and any tensor inside :func:`plain_attention`) take the plain forward."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v)
        if _plain_requested or q.device.type == "cpu":
            return flash_attention_plain(q, k, v, scale)
        return _launch_flash(q, k, v, scale)

    @staticmethod
    def backward(ctx, dout):
        with torch.enable_grad():
            q, k, v = (x.detach().requires_grad_() for x in ctx.saved_tensors)
            out = flash_attention_plain(q, k, v, ctx.scale)
        return (*torch.autograd.grad(out, (q, k, v), dout), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q . k^T * scale) . v with q (B, H, Q, dh) and k, v (B, H, K,
    dh) of one dtype; on the card dh is one of :data:`FLASH_HEAD_DIMS` and
    the dtype fp32 or bf16. Returns (B, H, Q, dh) in that dtype."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"q must be (B, H, Q, dh) and k, v (B, H, K, dh), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch, heads or head width")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k and v must share one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k and v lie on {q.device}, {k.device}, "
                         f"{v.device}")
    if min(q.shape[2], k.shape[2]) < 1:
        raise ValueError("q and k need at least one token each")
    return FlashAttention.apply(q, k, v, scale)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0
