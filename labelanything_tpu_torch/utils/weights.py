"""Weights for the port's modules.

* :func:`state_dict_from_jax` turns a JAX parameter tree of the LAM model
  (numpy leaves: parameters, or gradients or updated parameters of the same
  tree, since it is a pure layout map) into a state dict of the original
  PyTorch LabelAnything layout, which the port's modules load with
  ``load_state_dict(strict=True)``. :func:`export_state_dict` is the
  port's own copy of the JAX package's function of that name
  (``utils/torch_import.py``; held equal to it by a test), extended by the
  SAM encoder's names.
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

# flax module names -> reference (torch) module names, LAM tree
_EXPORT_RENAMES: List[Tuple[str, str]] = [
    (r"(^|\.)neck\.conv1\.", r"\1neck.0."),
    (r"(^|\.)neck\.ln1\.", r"\1neck.1."),
    (r"(^|\.)neck\.conv2\.", r"\1neck.2."),
    (r"(^|\.)neck\.ln2\.", r"\1neck.3."),
    (r"(^|\.)mask_down_conv1\.", r"\1mask_downscaling.0."),
    (r"(^|\.)mask_down_ln1\.", r"\1mask_downscaling.1."),
    (r"(^|\.)mask_down_conv2\.", r"\1mask_downscaling.3."),
    (r"(^|\.)mask_down_ln2\.", r"\1mask_downscaling.4."),
    (r"(^|\.)mask_down_conv3\.", r"\1mask_downscaling.6."),
    (r"(^|\.)class_attention_block\.", r"\1class_attention."),
    (r"(^|\.)example_attention_block\.", r"\1example_attention."),
    (r"(^|\.)class_example_attention_block\.", r"\1class_example_attention."),
    (r"(^|\.)up_conv1\.", r"\1output_upscaling.0."),
    (r"(^|\.)up_ln\.", r"\1output_upscaling.1."),
    (r"(^|\.)up_conv2\.", r"\1output_upscaling.3."),
    (r"(^|\.)spatial_conv_0\.", r"\1spatial_convs.0."),
    (r"(^|\.)spatial_ln_0\.", r"\1spatial_convs.1."),
    (r"(^|\.)spatial_conv_1\.", r"\1spatial_convs.3."),
    (r"(^|\.)spatial_ln_1\.", r"\1spatial_convs.4."),
    (r"(^|\.)spatial_conv_2\.", r"\1spatial_convs.6."),
    (r"(^|\.)spatial_ln_2\.", r"\1spatial_convs.7."),
    (r"(^|\.)prototype_tconv_(\d+)\.", r"\1prototype_tconv.\2."),
    (r"(^|\.)layers_(\d+)\.", r"\1layers.\2."),
    (r"(^|\.)blocks_(\d+)\.", r"\1blocks.\2."),
]

# the SAM encoder's names, which export_state_dict leaves in flax form
_ENCODER_RENAMES: List[Tuple[str, str]] = [
    (r"(^|\.)patch_embed\.", r"\1patch_embed.proj."),
    (r"(^|\.)neck_conv1\.", r"\1neck.0."),
    (r"(^|\.)neck_ln1\.", r"\1neck.1."),
    (r"(^|\.)neck_conv2\.", r"\1neck.2."),
    (r"(^|\.)neck_ln2\.", r"\1neck.3."),
]

_EMBEDDING_LEAVES = ("not_a_point_embed", "no_mask_embed", "not_a_mask_embed",
                     "no_sparse_embedding")


def _apply_renames(key: str, renames: List[Tuple[str, str]]) -> str:
    for pat, rep in renames:
        key = re.sub(pat, rep, key)
    return key


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def export_state_dict(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Reference-layout state dict (numpy) of a flax LAM parameter tree:
    kernels transposed to torch's (out, in, kh, kw) / (out, in), LayerNorm
    ``scale`` renamed ``weight``, the stacked point embeddings split into
    four rows, module names mapped back."""
    flat = _flatten(params["params"] if "params" in params else params)
    out: Dict[str, np.ndarray] = {}
    for path, value in flat.items():
        value = np.asarray(value)
        key = ".".join(path)
        leaf = path[-1]
        if leaf == "point_embeddings":
            base = ".".join(path[:-1])
            prefix = base + "." if base else ""
            for i in range(value.shape[0]):
                out[_apply_renames(f"{prefix}point_embeddings.{i}.weight",
                                   _EXPORT_RENAMES)] = value[i][None]
            continue
        if leaf in _EMBEDDING_LEAVES:
            key = key + ".weight"       # the full nn.Embedding weight (1, D)
        elif leaf == "kernel":
            value = (value.transpose(3, 2, 0, 1) if value.ndim == 4
                     else value.T)
            key = ".".join(path[:-1]) + ".weight"
        elif leaf == "scale":
            key = ".".join(path[:-1]) + ".weight"
        # a LayerNorm2d ``weight`` keeps its name
        out[_apply_renames(key, _EXPORT_RENAMES)] = np.ascontiguousarray(value)
    return out


def state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Reference-layout state dict (CPU tensors) of a JAX parameter tree,
    with or without the top-level ``{"params": ...}`` wrapper."""
    return {_apply_renames(key, _ENCODER_RENAMES):
            torch.from_numpy(np.array(value, np.float32))
            for key, value in export_state_dict(params).items()}


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
