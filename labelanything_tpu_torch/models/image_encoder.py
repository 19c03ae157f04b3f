"""SAM / ViTDet image encoder (counterpart of
``labelanything_tpu/models/image_encoder.py``; reference:
label_anything/models/image_encoder.py).

Channels-last throughout. The decomposed relative-position attention runs
through the CUDA kernels of :mod:`..ops.flash_attention`. Heads 64 wide
(ViT-B, ViT-L): the global blocks through ``flash_attention_relpos_lanes``,
the windowed blocks through ``flash_attention_relpos_lanes_batched``. Any
other head width (ViT-H: 80): both through ``flash_attention_relpos_packed``
on a token-major view of the qkv projection. Windows are zero-padded before
the qkv projection, so pad tokens carry qkv = bias and are attended, as in
the reference.

Two opt-in builder arguments, both off by default, take the JAX package's
opt-in kernels:

* ``fused_window``: every windowed block's attention half (pad, qkv, window
  attention, projection, residual) goes through
  :func:`..ops.fused_window.fused_window_attention`, one kernel a block on
  the card for the shapes ``fused_window_ok`` admits (heads 64 or 80 wide),
  its plain twin on the CPU; a shape it refuses takes the unfused path,
  which computes the same function. The parameters are the same modules'.
* ``int8_scores``: the global blocks of 64-wide heads take their q . k
  scores in int8 where the JAX rule sends the flag
  (``ops.flash_attention.int8_scores_ok``: 64 x 64 at 1024 px).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import flash_attention as fa
from ..ops import fused_window as fw
from .common import Conv2d, LayerNorm, LayerNorm2d, Linear, MLPBlock, gelu


def window_partition(x: torch.Tensor, window_size: int
                     ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) -> (B * nW, ws, ws, C) with bottom/right zero padding
    (reference: image_encoder.py:258-280)."""
    b, h, w, c = x.shape
    pad_h = (window_size - h % window_size) % window_size
    pad_w = (window_size - w % window_size) % window_size
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window_size, window_size, wp // window_size,
                  window_size, c)
    windows = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size,
                                                  window_size, c)
    return windows, (hp, wp)


def window_unpartition(windows: torch.Tensor, window_size: int,
                       pad_hw: Tuple[int, int], hw: Tuple[int, int]
                       ) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // window_size // window_size)
    x = windows.reshape(b, hp // window_size, wp // window_size, window_size,
                        window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """Relative-position rows for every (query, key) coordinate pair,
    linearly resized when the table length differs (reference:
    image_encoder.py:311-337)."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = F.interpolate(rel_pos.t()[None], size=max_rel_dist,
                                mode="linear", align_corners=False)[0].t()
    q_coords = torch.arange(q_size, device=rel_pos.device)[:, None] \
        * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=rel_pos.device)[None, :] \
        * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


class PatchEmbed(nn.Module):
    """Stride-``patch_size`` conv patch embedding (reference:
    image_encoder.py:379-409): (B, H, W, 3) -> (B, H/p, W/p, E)."""

    def __init__(self, embed_dim: int, patch_size: int = 16, in_chans: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, patch_size, stride=patch_size,
                           dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class ViTAttention(nn.Module):
    """Multi-head attention with decomposed rel-pos (reference:
    image_encoder.py:200-255). ``windowed`` selects the windowed kernel of
    the 64-wide heads; the packed function picks its own by token count.
    ``int8_scores`` asks a global block of 64-wide heads for int8 scores."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool,
                 input_size: Tuple[int, int], windowed: bool,
                 dtype: torch.dtype = torch.float32,
                 int8_scores: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.windowed = windowed
        self.int8_scores = int8_scores
        self.compute_dtype = dtype
        head_dim = dim // num_heads
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, dim = x.shape
        heads = self.num_heads
        head_dim = dim // heads
        qkv = self.qkv(x).reshape(b, h * w, 3 * dim)
        rh = get_rel_pos(h, h, self.rel_pos_h).to(self.compute_dtype)
        rw = get_rel_pos(w, w, self.rel_pos_w).to(self.compute_dtype)
        # factored bias (b, h, w, heads, h + w), log2(e) folded in
        q4 = qkv[..., :dim].reshape(b, h, w, heads, head_dim)
        rel_h = torch.einsum("byxnc,ykc->byxnk", q4, rh)
        rel_w = torch.einsum("byxnc,xkc->byxnk", q4, rw)
        r = torch.cat([rel_h, rel_w], dim=-1) * fa.LOG2E
        scale = head_dim ** -0.5
        if head_dim == fa.KERNEL_HEAD_DIM:
            r = r.reshape(b, h * w, heads * (h + w))
            if self.windowed:
                out = fa.flash_attention_relpos_lanes_batched(
                    qkv, r, scale, (h, w), heads)
            else:
                out = fa.flash_attention_relpos_lanes(
                    qkv, r, scale, (h, w), heads,
                    int8_scores=self.int8_scores)
        else:
            # the packed kernels take strides: they read the projection and
            # r as they lie and write the output token-major, so the views
            # below cost no copy on the card
            out = fa.flash_attention_relpos_packed(
                qkv.view(b, h * w, 3 * heads, head_dim).permute(0, 2, 1, 3),
                r.reshape(b, h * w, heads, h + w).permute(0, 2, 1, 3), scale,
                (h, w), heads).permute(0, 2, 1, 3)
        return self.proj(out.reshape(b, h, w, dim))

    def fused_window(self, xn: torch.Tensor, residual: torch.Tensor,
                     ws: int) -> torch.Tensor:
        """``residual`` + the windowed attention of the normed map ``xn``
        (B, H, W, C), projection included, in one call of
        :func:`..ops.fused_window.fused_window_attention` (the JAX
        ``ViTAttention._fused_window``): both padded to window multiples
        after ``norm1``, qkv of the padded map, the factored bias from the
        window's rel-pos rows; the pad cropped off the result."""
        b, h, w, dim = xn.shape
        heads = self.num_heads
        dt = self.compute_dtype
        pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
        if pad_h or pad_w:
            xn = F.pad(xn, (0, 0, 0, pad_w, 0, pad_h))
            residual = F.pad(residual, (0, 0, 0, pad_w, 0, pad_h))
        qkv = self.qkv(xn)                               # (B, Hp, Wp, 3C)
        r = fw.window_bias(qkv[..., :dim],
                           get_rel_pos(ws, ws, self.rel_pos_h).to(dt),
                           get_rel_pos(ws, ws, self.rel_pos_w).to(dt),
                           heads, ws)
        out = fw.fused_window_attention(
            residual.to(dt).contiguous(), qkv, r, self.proj.weight.to(dt),
            self.proj.bias.to(dt), (dim // heads) ** -0.5, heads, ws)
        return out[:, :h, :w]


class ViTBlock(nn.Module):
    """Windowed or global transformer block (reference:
    image_encoder.py:134-197). With ``fused_window`` a windowed block's
    attention half takes :meth:`ViTAttention.fused_window` on the CPU and
    wherever ``ops.fused_window.fused_window_ok`` admits the call on the
    card."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 qkv_bias: bool, window_size: int,
                 input_size: Tuple[int, int], dtype: torch.dtype = torch.float32,
                 fused_window: bool = False, int8_scores: bool = False):
        super().__init__()
        self.window_size = window_size
        self.fused = fused_window and window_size > 0
        self.norm1 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.attn = ViTAttention(
            dim, num_heads, qkv_bias,
            input_size if window_size == 0 else (window_size, window_size),
            windowed=window_size > 0, dtype=dtype, int8_scores=int8_scores)
        self.norm2 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio), act=gelu, dtype=dtype)

    def _takes_fused(self, x: torch.Tensor) -> bool:
        if not self.fused:
            return False
        if x.device.type != "cuda":
            return True
        dim = x.shape[-1]
        heads = self.attn.num_heads
        return fw.fused_window_ok(x.device, self.attn.compute_dtype, heads,
                                  dim // heads, self.window_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.norm1(x)
        if self._takes_fused(x):
            x = self.attn.fused_window(x, shortcut, self.window_size)
            return x + self.mlp(self.norm2(x))
        if self.window_size > 0:
            h, w = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, (h, w))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class ImageEncoderViT(nn.Module):
    """SAM image encoder (reference: image_encoder.py:19-131): (B, H, W, 3)
    -> (B, H/16, W/16, out_chans), or the pre-neck ``embed_dim`` state when
    ``project_last_hidden`` is False (no neck parameters then, as in the
    JAX parameter tree).

    ``remat``: False keeps every block's activations for the backward;
    True or "full" reruns each block's forward in the backward
    (``torch.utils.checkpoint``), which trades one extra forward for the
    activation memory. The JAX package's partial policies "attn" and "dots"
    are not ported.

    ``fused_window`` and ``int8_scores`` (both off by default) take the
    JAX package's two opt-in kernels, as the module docstring says; they
    change no parameter."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16,
                 in_chans: int = 3, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0,
                 out_chans: int = 256, qkv_bias: bool = True,
                 window_size: int = 0,
                 global_attn_indexes: Sequence[int] = (),
                 project_last_hidden: bool = True,
                 dtype: torch.dtype = torch.float32,
                 remat: Union[bool, str, None] = False,
                 fused_window: bool = False, int8_scores: bool = False):
        super().__init__()
        if remat in ("attn", "dots"):
            raise NotImplementedError(
                f"remat policy {remat!r} is not ported; use False or 'full'")
        if remat not in (False, None, True, "full"):
            raise ValueError(f"unknown remat policy: {remat!r}")
        self.remat = bool(remat)
        grid = img_size // patch_size
        self.patch_embed = PatchEmbed(embed_dim, patch_size, in_chans,
                                      dtype=dtype)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, embed_dim))
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio, qkv_bias,
                     0 if i in global_attn_indexes else window_size,
                     (grid, grid), dtype=dtype, fused_window=fused_window,
                     int8_scores=int8_scores)
            for i in range(depth))
        self.neck: Optional[nn.Sequential] = None
        if project_last_hidden:
            self.neck = nn.Sequential(
                Conv2d(embed_dim, out_chans, 1, bias=False, dtype=dtype),
                LayerNorm2d(out_chans, dtype=dtype),
                Conv2d(out_chans, out_chans, 3, padding=1, bias=False,
                       dtype=dtype),
                LayerNorm2d(out_chans, dtype=dtype))

    def forward(self, x: torch.Tensor, return_last_block_state: bool = False):
        """With ``return_last_block_state`` (and a neck) a dict of the
        neck's output, ``last_hidden_state``, and the last block's,
        ``last_block_state`` (B, H/16, W/16, embed_dim)."""
        x = self.patch_embed(x)
        x = x + self.pos_embed.to(x.dtype)
        for block in self.blocks:
            if self.remat and torch.is_grad_enabled() and x.requires_grad:
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        if self.neck is None:
            return x
        y = self.neck(x)
        if return_last_block_state:
            return {"last_hidden_state": y, "last_block_state": x}
        return y
