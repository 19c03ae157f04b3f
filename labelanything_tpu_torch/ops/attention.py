"""Scaled dot-product attention core (counterpart of
``labelanything_tpu/ops/attention.py``).

Only the plain path is ported: on the LAM slice no attention has both
sides of 1024 tokens or more, so the JAX dispatcher never selects its
flash kernel there. Shapes follow (batch, heads, tokens, head_dim).
"""

from __future__ import annotations

import torch


def dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """softmax(q.k^T / sqrt(dh)) . v; scores and softmax in fp32, the
    probabilities cast to v's dtype (the JAX ``_xla_attention``)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)
