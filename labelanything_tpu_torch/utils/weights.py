"""Weights for the port's modules.

* :func:`state_dict_from_jax` turns a JAX ``labelanything_tpu`` parameter
  tree (numpy leaves) into a state dict of the original PyTorch
  LabelAnything layout, which the port's modules load with
  ``load_state_dict(strict=True)``. It extends
  ``labelanything_tpu.utils.torch_import.export_state_dict`` (which covers
  the tree without the image encoder) by the SAM encoder's names, the
  inverse of the renames in ``torch_import._RENAMES``. That numpy-only
  module of the JAX package is imported only when JAX parameters are
  converted; nothing else in the port needs the JAX package.
* :func:`init_weights` fills every parameter and buffer of a module from a
  seeded ``torch.Generator`` on the CPU, so the same seed gives the same
  weights on every device.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

_ENCODER_RENAMES: List[Tuple[str, str]] = [
    (r"(^|\.)patch_embed\.", r"\1patch_embed.proj."),
    (r"(^|\.)neck_conv1\.", r"\1neck.0."),
    (r"(^|\.)neck_ln1\.", r"\1neck.1."),
    (r"(^|\.)neck_conv2\.", r"\1neck.2."),
    (r"(^|\.)neck_ln2\.", r"\1neck.3."),
]


def state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Reference-layout state dict (CPU tensors) of a JAX parameter tree,
    with or without the top-level ``{"params": ...}`` wrapper."""
    from labelanything_tpu.utils.torch_import import export_state_dict

    out = {}
    for key, value in export_state_dict(params).items():
        for pat, rep in _ENCODER_RENAMES:
            key = re.sub(pat, rep, key)
        out[key] = torch.from_numpy(np.array(value, np.float32))
    return out


def init_weights(module: nn.Module, seed: int = 0) -> None:
    """Seeded random weights for every entry of ``module.state_dict()``.

    The rule is the golden-fixture harness's (``tests/golden.py``,
    ``fill_state_dict``, undamped): in sorted key order, a standard normal
    x of each entry's shape; biases get 0.02 x, vectors (norm weights)
    1 + 0.05 x, and arrays of two or more axes x / sqrt(fan_in), where
    fan_in is the product of all axes but the first. So the relative
    position tables are nonzero, unlike a fresh model's."""
    gen = torch.Generator().manual_seed(seed)
    state = module.state_dict()
    with torch.no_grad():
        for key in sorted(state):
            target = state[key]
            n = torch.randn(tuple(target.shape), generator=gen)
            if key.endswith(".bias"):
                value = 0.02 * n
            elif n.dim() <= 1:
                value = 1.0 + 0.05 * n
            else:
                fan_in = max(1, int(np.prod(n.shape[1:])))
                value = n / fan_in ** 0.5
            target.copy_(value)
