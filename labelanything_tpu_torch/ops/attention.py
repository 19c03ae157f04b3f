"""Scaled dot-product attention core (counterpart of
``labelanything_tpu/ops/attention.py``). Shapes follow (batch, heads,
tokens, head_dim).

:func:`dot_product_attention` routes by the JAX package's rule
(``attention.py:79-88``), with "on the TPU" read as "a CUDA tensor": both
lengths at least 1024 and multiples of 128 and a head width of 32, 64, 128
or 256 take the flash kernel (``ops.flash_attention.flash_attention``),
anything else the plain product. The rule's last clause, no additive bias,
always holds in the port, whose attention takes no masks (see
``models.common.Attention``). Of the paths ported so far only the affinity
decoder's attention meets the rule (4096 query tokens against M x 4096
support tokens, heads 32 wide); the two-way transformers and the prompt
encoder's attention blocks attend over a few tokens on one side.
"""

from __future__ import annotations

import torch

from . import flash_attention as fa

# tokens below this bound, on either side, take the plain product
FLASH_MIN_TOKENS = 1024


def flash_ok(device: torch.device, q_len: int, k_len: int,
             head_dim: int) -> bool:
    """Whether :func:`dot_product_attention` takes the flash kernel."""
    return (torch.device(device).type == "cuda"
            and q_len >= FLASH_MIN_TOKENS and k_len >= FLASH_MIN_TOKENS
            and q_len % 128 == 0 and k_len % 128 == 0
            and head_dim in fa.FLASH_HEAD_DIMS)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                          ) -> torch.Tensor:
    """softmax(q.k^T / sqrt(dh)) . v; scores and softmax in fp32, the
    probabilities cast to v's dtype (the JAX ``_xla_attention``)."""
    scale = q.shape[-1] ** -0.5
    if flash_ok(q.device, q.shape[-2], k.shape[-2], q.shape[-1]):
        return fa.flash_attention(q, k, v, scale)
    return fa.flash_attention_plain(q, k, v, scale)
