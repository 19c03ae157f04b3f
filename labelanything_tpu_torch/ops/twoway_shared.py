"""The two-way transformer on shared keys (counterpart of the shared-keys
part of ``labelanything_tpu/ops/twoway_blockdiag.py``).

The prompt encoder's fusion runs one instance per (example, class), and the
image operand of instance g is ``base[g // group] + u[g] (+ map[g] @ proj)``:
the example's features, shared by its ``group`` classes, plus a spatially
uniform shift (the class row and the no-mask or mask-bias embedding) and,
with mask prompts, a rank-Cm term (the mask trunk's Cm = 16 channels through
the final 1x1 convolution ``proj``). :func:`twoway_shared` computes what
``fused_twoway.twoway_plain`` computes on the expanded keys, but runs the
first block's image side once per base map, exactly:

* the image-side projections of the first block (token-to-image K and V,
  image-to-token Q) run over the base maps; the shift enters as ``u @ W``
  per instance;
* token-to-image scores: the key correction ``q . (u @ Wk)`` is constant
  over the softmax axis (the image tokens) and is dropped;
* token-to-image values: the softmax rows sum to 1, so ``u @ Wv`` is added
  to every output row as it is;
* image-to-token scores: the query correction varies along the softmax axis
  (the tokens) and is kept, one small product;
* with the map, its ``Cm`` channels go through ``proj`` folded into the
  projection weights, ``map @ (proj @ W)``, and the attention then runs per
  instance (the correction varies over the image).

The per-instance keys first exist at the first block's image-side residual;
later blocks run as ``twoway_plain`` does. This is plain tensor code, not a
kernel: its matrix products are those the JAX package leaves to XLA. The
TPU's lane layouts (block-diagonal head expansion, segment softmax) are not
ported.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import flash_attention as fa
from .fused_twoway import (_LAYER_N, _attention, _ln, twoway_block,
                           twoway_final, twoway_param_count, twoway_plain)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, T, I) -> (B, heads, T, dh)."""
    b, t, c = x.shape
    return x.reshape(b, t, heads, c // heads).transpose(1, 2)


def _softmax_to(scores: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return torch.softmax(scores, dim=-1).to(dtype)


def twoway_shared(base: torch.Tensor, queries: torch.Tensor,
                  key_pe: torch.Tensor, params: Sequence[torch.Tensor],
                  depth: int, heads: int, key_shift: torch.Tensor,
                  key_shift_map: Optional[torch.Tensor] = None,
                  key_shift_proj: Optional[torch.Tensor] = None,
                  act: Callable = F.relu
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """base (BM, S, D) shared image tokens, queries (G, N, D) with G a
    multiple of BM, key_pe (S, D), key_shift (G, D), key_shift_map (G, S,
    Cm) and key_shift_proj (Cm, D) optional, ``params`` as
    ``fused_twoway.twoway_params`` gives them. Returns (queries (G, N, D),
    keys (G, S, D)) as ``twoway_plain`` does on the expanded keys."""
    if len(params) != twoway_param_count(depth):
        raise ValueError(f"{len(params)} parameters, expected "
                         f"{twoway_param_count(depth)} for depth {depth}")
    bm, s, d = base.shape
    g, n, _ = queries.shape
    if g % bm:
        raise ValueError(f"the instance count ({g}) must be a multiple of "
                         f"the base-map count ({bm})")
    if (key_shift_map is None) != (key_shift_proj is None):
        raise ValueError("key_shift_map and key_shift_proj go together")
    group = g // bm
    dt, ft = base.dtype, fa._float_type(base)

    def expanded():
        keys = base.repeat_interleave(group, dim=0) + key_shift[:, None, :]
        if key_shift_map is not None:
            keys = keys + key_shift_map @ key_shift_proj
        return keys

    if depth == 0:
        return twoway_plain(expanded(), queries, key_pe, params, 0, heads, act)

    first = [p.to(dt) for p in params[:_LAYER_N]]
    self_p, n1 = first[:8], first[8:10]
    t2i, n2 = first[10:18], first[18:20]
    w1, b1, w2, b2 = first[20:24]
    n3 = first[24:26]
    i2t, n4 = first[26:34], first[34:36]
    wq, bq, wk, bk, wv, bv, wo, bo = t2i
    wq2, bq2, wk2, bk2, wv2, bv2, wo2, bo2 = i2t
    inner = wk.shape[0]
    scale = (inner // heads) ** -0.5
    q0 = queries

    # tokens: self-attention (no positional term, replaces the queries)
    queries = _ln(_attention(queries, queries, queries, self_p, heads), *n1)

    # image side of the block, once per base map: K and the image-to-token
    # Q read base + pe in one packed product, V reads base
    packed = F.linear(base + key_pe, torch.cat([wk, wq2]),
                      torch.cat([bk, bq2]))             # (BM, S, 2 I)
    kp, qp_img = packed[..., :inner], packed[..., inner:]
    vp = F.linear(base, wv, bv)
    shift_v = F.linear(key_shift, wv)                   # (G, I), no bias
    shift_q = F.linear(key_shift, wq2)
    qt = F.linear(queries + q0, wq, bq)                 # (G, N, I)

    if key_shift_map is None:
        # token-to-image: the C instances of a base map share its K and V;
        # their tokens line up along one axis
        qh = _heads(qt.reshape(bm, group * n, inner), heads)
        scores = torch.matmul(qh.to(ft), _heads(kp, heads).to(ft)
                              .transpose(-1, -2)) * scale
        out = torch.matmul(_softmax_to(scores, dt), _heads(vp, heads))
        out = out.transpose(1, 2).reshape(g, n, inner) + shift_v[:, None, :]
    else:
        # the map's channels through proj folded into the weights; the
        # attention then runs per instance
        wmap = torch.cat([wk, wq2, wv]) @ key_shift_proj.t()   # (3 I, Cm)
        corr = F.linear(key_shift_map, wmap)                   # (G, S, 3 I)
        kp = (kp.repeat_interleave(group, dim=0) + corr[..., :inner])
        qp_img = (qp_img.repeat_interleave(group, dim=0)
                  + shift_q[:, None, :] + corr[..., inner:2 * inner])
        vp = (vp.repeat_interleave(group, dim=0) + shift_v[:, None, :]
              + corr[..., 2 * inner:])
        scores = torch.matmul(_heads(qt, heads).to(ft),
                              _heads(kp, heads).to(ft).transpose(-1, -2)) \
            * scale
        out = torch.matmul(_softmax_to(scores, dt), _heads(vp, heads))
        out = out.transpose(1, 2).reshape(g, n, inner)
    queries = _ln(queries + F.linear(out, wo, bo), *n2)
    queries = _ln(queries + F.linear(act(F.linear(queries, w1, b1)), w2, b2),
                  *n3)

    # image-to-token: softmax over the tokens of each instance
    kt = _heads(F.linear(queries + q0, wk2, bk2), heads)    # (G, H, N, dh)
    vt = _heads(F.linear(queries, wv2, bv2), heads)
    if key_shift_map is None:
        # scores of all C instances of a base map in one product, plus the
        # per-instance query correction, constant over the image
        kt_grouped = kt.reshape(bm, group, heads, n, -1).transpose(1, 2) \
            .reshape(bm, heads, group * n, -1)
        scores = torch.matmul(_heads(qp_img, heads).to(ft),
                              kt_grouped.to(ft).transpose(-1, -2))
        row = torch.matmul(_heads(shift_q[:, None, :], heads).to(ft),
                           kt.to(ft).transpose(-1, -2))     # (G, H, 1, N)
        row = row.reshape(bm, group, heads, 1, n).permute(0, 2, 3, 1, 4)
        scores = (scores.reshape(bm, heads, s, group, n) + row) * scale
        probs = _softmax_to(scores, dt).permute(0, 3, 1, 2, 4) \
            .reshape(g, heads, s, n)
    else:
        scores = torch.matmul(_heads(qp_img, heads).to(ft),
                              kt.to(ft).transpose(-1, -2)) * scale
        probs = _softmax_to(scores, dt)
    out = torch.matmul(probs, vt).transpose(1, 2).reshape(g, s, inner)
    # the per-instance keys exist from here on
    keys = _ln(expanded() + F.linear(out, wo2, bo2), *n4)

    key_pe = key_pe[None]
    for layer in range(1, depth):
        queries, keys = twoway_block(
            keys, queries, q0, key_pe,
            params[layer * _LAYER_N:(layer + 1) * _LAYER_N], heads, act,
            first=False)
    queries = twoway_final(keys, queries, q0, key_pe,
                           params[depth * _LAYER_N:], heads)
    return queries, keys
