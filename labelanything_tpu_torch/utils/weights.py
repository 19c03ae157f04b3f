"""Weights for the port's modules.

* :func:`state_dict_from_jax` turns a JAX parameter tree of the LAM model
  (numpy leaves: parameters, or gradients or updated parameters of the same
  tree, since it is a pure layout map) into a state dict of the original
  PyTorch LabelAnything layout, which the port's modules load with
  ``load_state_dict(strict=True)`` (the affinity decoder's up-convs keep
  their flax names, ``up_conv0`` to ``up_conv2``). The variants' modules
  take the names the export gives them: the one-way blocks'
  ``layers.i``, ``class_projector_in`` / ``_out``, ``proto_chooser_0`` /
  ``_1``, the pooler's ``attention`` and ``{fg,bg}_chooser_0..3``, the
  cross-attention extraction's ``embeddings`` and ``layers.i``,
  ``level_reducer``, ``prototype_tconv.i`` and PrototypeAffinity's
  ``attn_token_to_image``, ``class_embedding_mlp`` and ``proto_ln``.
  :func:`export_state_dict`
  is the port's own copy of the JAX package's function of that name
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

# the multi-level LAM's per-level lists and the is_pyramids neck
_LAM_RENAMES: List[Tuple[str, str]] = [
    (r"(^|\.)(prompt_encoders|mask_decoders)_(\d+)\.", r"\1\2.\3."),
    (r"(^|\.)(fm|ce)_projector_(\d+)\.", r"\1\2_projectors.\3."),
    (r"(^|\.)neck\.pyramid\.input_proj_(\d+)\.",
     r"\1neck.0.input_projections.\2.0."),
    (r"(^|\.)neck\.pyramid\.input_gn_(\d+)\.",
     r"\1neck.0.input_projections.\2.1."),
    (r"(^|\.)neck\.pyramid\.", r"\1neck.0."),
    (r"(^|\.)neck\.ln\.", r"\1neck.1."),
]

# StandardViT's flax names -> Hugging Face ViTModel's
_HF_VIT_INVERSE: List[Tuple[str, str]] = [
    (r"^cls_token$", "embeddings.cls_token"),
    (r"^pos_embed$", "embeddings.position_embeddings"),
    (r"^patch_embed\.", "embeddings.patch_embeddings.projection."),
    (r"^blocks_(\d+)\.q\.", r"encoder.layer.\1.attention.attention.query."),
    (r"^blocks_(\d+)\.k\.", r"encoder.layer.\1.attention.attention.key."),
    (r"^blocks_(\d+)\.v\.", r"encoder.layer.\1.attention.attention.value."),
    (r"^blocks_(\d+)\.proj\.", r"encoder.layer.\1.attention.output.dense."),
    (r"^blocks_(\d+)\.mlp\.lin1\.", r"encoder.layer.\1.intermediate.dense."),
    (r"^blocks_(\d+)\.mlp\.lin2\.", r"encoder.layer.\1.output.dense."),
    (r"^blocks_(\d+)\.norm1\.", r"encoder.layer.\1.layernorm_before."),
    (r"^blocks_(\d+)\.norm2\.", r"encoder.layer.\1.layernorm_after."),
    (r"^norm\.", "layernorm."),
]

# MixVisionTransformer's flax names -> Hugging Face SegformerModel's (the
# fused ``kv`` is split apart in _mit_from_jax)
_MIT_INVERSE: List[Tuple[str, str]] = [
    (r"^patch_embed(\d)\.norm\.",
     lambda m: f"encoder.patch_embeddings.{int(m.group(1)) - 1}.layer_norm."),
    (r"^patch_embed(\d)\.proj\.",
     lambda m: f"encoder.patch_embeddings.{int(m.group(1)) - 1}.proj."),
    (r"^block(\d)_(\d+)\.",
     lambda m: f"encoder.block.{int(m.group(1)) - 1}.{m.group(2)}."),
    (r"^norm(\d)\.",
     lambda m: f"encoder.layer_norm.{int(m.group(1)) - 1}."),
    (r"\.norm1\.", ".layer_norm_1."),
    (r"\.norm2\.", ".layer_norm_2."),
    (r"\.attn\.q\.", ".attention.self.query."),
    (r"\.attn\.sr_norm\.", ".attention.self.layer_norm."),
    (r"\.attn\.sr\.", ".attention.self.sr."),
    (r"\.attn\.proj\.", ".attention.output.dense."),
    (r"\.mlp\.fc1\.", ".mlp.dense1."),
    (r"\.mlp\.fc2\.", ".mlp.dense2."),
    (r"\.mlp\.dwconv\.", ".mlp.dwconv.dwconv."),
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


def _affinity_names(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The export maps ``up_conv1`` / ``up_conv2`` to the prototype decoder's
    ``output_upscaling.0`` / ``.3`` in any tree; an affinity decoder (the
    one with an ``up_conv0``) keeps its three up-convs' flax names."""
    prefixes = [key[:-len("up_conv0.weight")] for key in state
                if key.endswith("up_conv0.weight")]
    out = {}
    for key, value in state.items():
        for prefix in prefixes:
            for index, conv in (("0", "up_conv1."), ("3", "up_conv2.")):
                old = f"{prefix}output_upscaling.{index}."
                if key.startswith(old):
                    key = prefix + conv + key[len(old):]
        out[key] = value
    return out


def _torch_layout(path: Tuple[str, ...], value) -> Tuple[str, np.ndarray]:
    """(module path with torch's leaf name, value in torch's layout) of one
    flax leaf: conv kernels (kh, kw, in, out) to (out, in, kh, kw), dense
    kernels transposed, ``kernel`` and ``scale`` named ``weight``."""
    value = np.asarray(value, np.float32)
    leaf = path[-1]
    if leaf == "kernel":
        value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
    if leaf in ("kernel", "scale"):
        path = path[:-1] + ("weight",)
    return ".".join(path), np.ascontiguousarray(value)


def _vit_from_jax(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A JAX ``StandardViT`` tree in Hugging Face ``ViTModel``'s names."""
    out = {}
    for path, value in _flatten(tree).items():
        key, value = _torch_layout(path, value)
        out[_apply_renames(key, _HF_VIT_INVERSE)] = value
    return out


def _mit_from_jax(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A JAX ``MixVisionTransformer`` tree in Hugging Face
    ``SegformerModel``'s names; each fused ``kv`` projection split into
    ``key`` (its first half of outputs) and ``value``."""
    out = {}
    for path, value in _flatten(tree).items():
        key, value = _torch_layout(path, value)
        key = _apply_renames(key, _MIT_INVERSE)
        if ".attn.kv." in key:
            half = value.shape[0] // 2
            for name, part in (("key", value[:half]), ("value", value[half:])):
                out[key.replace(".attn.kv.", f".attention.self.{name}.")] = \
                    np.ascontiguousarray(part)
        else:
            out[key] = value
    return out


def _encoder_state(node: Dict[str, Any], stats: Dict[str, Any]):
    """The port's state dict of a plain-ViT, MiT or pyramid-backbone tree,
    or None for any other tree."""
    if "cls_token" in node:
        return _vit_from_jax(node)
    if "patch_embed1" in node:
        return _mit_from_jax(node)
    if isinstance(node.get("resnet"), dict) and "layer1_0" in node["resnet"]:
        return state_dict_from_jax_baseline(
            "ppnet", {"params": node, "batch_stats": stats})
    if isinstance(node.get("swin"), dict) and "patch_norm" in node["swin"]:
        return state_dict_from_jax_baseline("dcama", {"params": node})
    return None


def _split_encoders(tree: Dict[str, Any], stats: Dict[str, Any],
                    prefix: str = ""):
    """(the tree without its plain-ViT, MiT and pyramid-backbone sub-trees,
    those sub-trees in the port's names with their path as prefix)."""
    part = _encoder_state(tree, stats)
    if part is not None:
        return {}, {prefix + k: v for k, v in part.items()}
    rest, special = {}, {}
    for name, node in tree.items():
        if not isinstance(node, dict):
            rest[name] = node
            continue
        sub_stats = stats.get(name, {}) if isinstance(stats, dict) else {}
        rest[name], inner = _split_encoders(node, sub_stats,
                                            f"{prefix}{name}.")
        special.update(inner)
    return rest, special


def state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Reference-layout state dict (CPU tensors) of a JAX parameter tree,
    with or without the top-level ``{"params": ...}`` wrapper (whose
    ``batch_stats``, a ResNet-50 pyramid backbone's, are taken too). A
    plain ViT or MiT encoder gets Hugging Face's names, a pyramid backbone
    the names of the PPNet / DCAMA backbone it wraps, the multi-level
    model's lists and the ``is_pyramids`` neck the port's."""
    stats = params.get("batch_stats", {}) if "params" in params else {}
    tree, special = _split_encoders(
        params["params"] if "params" in params else params, stats)
    state = _affinity_names(export_state_dict(tree))
    out = {_apply_renames(_apply_renames(key, _ENCODER_RENAMES),
                          _LAM_RENAMES):
           torch.from_numpy(np.array(value, np.float32))
           for key, value in state.items()}
    out.update({k: torch.as_tensor(np.array(v)) for k, v in special.items()})
    return out


def reference_state_dict(state: Dict[str, Any],
                         model_keys) -> Dict[str, torch.Tensor]:
    """A checkpoint's state dict in the port's names: keys the model has
    stay, the others get the names :func:`state_dict_from_jax` gives the
    JAX package's export (``save_torch_compatible``), which leaves the SAM
    encoder's and the affinity up-convs' names as flax has them."""
    state = {k: torch.as_tensor(np.asarray(v)) if not isinstance(
        v, torch.Tensor) else v for k, v in state.items()}
    known = set(model_keys)
    return {key if key in known else _apply_renames(
                _apply_renames(key, _ENCODER_RENAMES), _LAM_RENAMES):
            value for key, value in _affinity_names(state).items()}


def init_weights(module: nn.Module, seed: int = 0) -> None:
    """Seeded random weights for every entry of ``module.state_dict()``.

    The rule is the golden-fixture harness's (``tests/golden.py``,
    ``fill_state_dict``, undamped): in sorted key order, a standard normal
    x of each entry's shape; biases get 0.02 x, vectors (norm weights)
    1 + 0.05 x, and arrays of two or more axes x / sqrt(fan_in), where
    fan_in is the product of all axes but the first. So the relative
    position tables are nonzero, unlike a fresh model's. BatchNorm's
    running means (the baselines' only; the LAM models have none) are
    drawn as biases, 0.02 x: at the harness's 1 + 0.05 x a unit behind a
    ReLU is mostly 0, and every DENet logit is."""
    gen = torch.Generator().manual_seed(seed)
    state = module.state_dict()
    with torch.no_grad():
        for key in sorted(state):
            target = state[key]
            n = torch.randn(tuple(target.shape), generator=gen)
            if key.endswith((".bias", ".running_mean")):
                value = 0.02 * n
            elif n.dim() <= 1:
                value = 1.0 + 0.05 * n
            else:
                fan_in = max(1, int(np.prod(n.shape[1:])))
                value = n / fan_in ** 0.5
            target.copy_(value)


# --------------------------------------------------------------------- #
# the baselines: JAX variables -> the reference's state-dict layout
# --------------------------------------------------------------------- #

# the inverses of the JAX package's convert_{ppnet,denet,bam,hdmnet,dcama,fptrans}_state_dict
# (``utils/torch_import.py``): flax module paths -> the reference's names,
# which are the port's; the wrapper's scope ("ppnet.", "denet.", "bam.",
# "hdmnet.", or none for a bare module) is kept
_DOWNSAMPLE_INVERSE: List[Tuple[str, str]] = [
    (r"\.downsample_conv\.", ".downsample.0."),
    (r"\.downsample_bn\.", ".downsample.1."),
]

_RESNET_INVERSE: List[Tuple[str, str]] = [
    (r"(^|\.)layer(\d)_(\d+)\.", r"\1layer\2.\3."),
] + _DOWNSAMPLE_INVERSE

_DENET_INVERSE: List[Tuple[str, str]] = [
    (r"(^|\.)gam\.gate_(\d)\.", r"\1estimator.gam.gate.\2."),
    (r"(^|\.)map\.linear\.", r"\1estimator.map.linear."),
    (r"(^|\.)embedding_0\.", r"\1embedding.0."),
    (r"\.aspp\.convs_4\.", ".aspp.convs.4.1."),
    (r"\.aspp\.convs_(\d)\.", r".aspp.convs.\1.0."),
    (r"\.aspp\.project\.", ".aspp.project.0."),
] + _RESNET_INVERSE

_BAM_BACKBONE_INVERSE: List[Tuple[str, str]] = [
    (r"(^|\.)backbone\.layer0_(\d)\.", r"\1layer0.\2."),
    (r"(^|\.)backbone\.layer([1-4])_(\d+)\.", r"\1layer\2.\3."),
    (r"(^|\.)kshot_rw_(\d)\.", r"\1kshot_rw.\2."),
] + _DOWNSAMPLE_INVERSE

_BAM_INVERSE: List[Tuple[str, str]] = _BAM_BACKBONE_INVERSE + [
    (r"(^|\.)ppm\.features_(\d)_conv\.", r"\1learner_base.0.features.\2.1."),
    (r"(^|\.)ppm\.features_(\d)_bn\.", r"\1learner_base.0.features.\2.2."),
    (r"(^|\.)base_cls_(\d)\.", r"\1learner_base.1.\2."),
    (r"(^|\.)(down_query|down_supp|init_merge|res1_meta)_0\.", r"\1\2.0."),
    (r"(^|\.)ASPP_meta\.layer6_(\d)\.", r"\1ASPP_meta.layer6_\2.0."),
    (r"(^|\.)(res2_meta|cls_meta)_(\d)\.", r"\1\2.\3."),
]

_MIX = r"\1transformer.mix_transformer."
_HDMNET_INVERSE: List[Tuple[str, str]] = _BAM_BACKBONE_INVERSE + [
    (r"(^|\.)ppm\.features_(\d)_conv\.", r"\1ppm.features.\2.1."),
    (r"(^|\.)ppm\.features_(\d)_bn\.", r"\1ppm.features.\2.2."),
    (r"(^|\.)cls_(\d)\.", r"\1cls.\2."),
    (r"(^|\.)base_learnear_2\.", r"\1base_learnear.2."),
    (r"(^|\.)(down_supp|down_query|query_merge|supp_merge)_0\.", r"\1\2.0."),
    (r"(^|\.)transformer\.down_(\d)_patch_proj\.",
     _MIX + r"down_sample_layers.\2.0.projection."),
    (r"(^|\.)transformer\.down_(\d)_patch_norm\.",
     _MIX + r"down_sample_layers.\2.0.norm."),
    (r"(^|\.)transformer\.down_(\d)_enc(\d)\.",
     lambda m: f"{m.group(1)}transformer.mix_transformer.down_sample_layers."
               f"{m.group(2)}.{int(m.group(3)) + 1}."),
    (r"(^|\.)transformer\.down_(\d)_norm\.",
     _MIX + r"down_sample_layers.\2.3."),
    (r"(^|\.)transformer\.match_(\d)_enc\.", _MIX + r"match_layers.\2.0."),
    (r"(^|\.)transformer\.match_(\d)_(conv|bn)\.",
     _MIX + r"match_layers.\2.1.\3."),
    (r"(^|\.)transformer\.parse_(\d)_(conv|bn)(\d)\.",
     lambda m: f"{m.group(1)}transformer.mix_transformer.parse_layers."
               f"{m.group(2)}.{2 * int(m.group(4)) + (m.group(3) == 'bn')}."),
    (r"(^|\.)transformer\.cls_(conv|bn)(\d)\.",
     lambda m: f"{m.group(1)}transformer.mix_transformer.cls."
               f"{2 * int(m.group(3)) + (m.group(2) == 'bn')}."),
    (r"\.attn\.linear_([qkvo])\.", r".attn.attn.linear_\1."),
    (r"\.attn_sr\.", ".attn.sr."),
    (r"\.attn_norm\.", ".attn.norm."),
    (r"\.ffn\.fc1\.", ".ffn.layers.0."),
    (r"\.ffn\.pe_conv\.", ".ffn.layers.1."),
    (r"\.ffn\.fc2\.", ".ffn.layers.4."),
]

# PANet: the JAX VGG16's conv_k are torchvision's vgg16().features indexes
_VGG16_CONV_INDEX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_PANET_INVERSE: List[Tuple[str, str]] = [
    (r"(^|\.)encoder\.conv_(\d+)\.",
     lambda m: f"{m.group(1)}encoder.features."
               f"{_VGG16_CONV_INDEX[int(m.group(2))]}."),
]

# DCAMA: the Swin-B backbone (``feature_extractor``) and the head
# (``model``); a backbone handed to the JAX module is scoped ``backbone``
_DCAMA_INVERSE: List[Tuple[str, str]] = [
    (r"^backbone\.", "feature_extractor."),
    (r"(^|\.)patch_embed\.", r"\1patch_embed.proj."),
    (r"(^|\.)patch_norm\.", r"\1patch_embed.norm."),
    (r"(^|\.)layers_(\d+)_blocks_(\d+)\.", r"\1layers.\2.blocks.\3."),
    (r"(^|\.)layers_(\d+)_downsample\.", r"\1layers.\2.downsample."),
    (r"\.mlp_fc([12])\.", r".mlp.fc\1."),
    (r"(^|\.)dcama_block_(\d)\.q\.", r"\1DCAMA_blocks.\2.linears.0."),
    (r"(^|\.)dcama_block_(\d)\.k\.", r"\1DCAMA_blocks.\2.linears.1."),
    (r"(^|\.)conv(\d)_(conv|gn)(\d)\.",
     lambda m: f"{m.group(1)}conv{m.group(2)}."
               f"{3 * int(m.group(4)) + (m.group(3) == 'gn')}."),
    (r"(^|\.)mixer(\d)_([01])\.",
     lambda m: f"{m.group(1)}mixer{m.group(2)}.{2 * int(m.group(3))}."),
]

# FPTrans: the prompted encoder sits in the reference's Sequential
# (``encoder.backbone``); ``original_encoder`` does not match the first rule
_FPTRANS_INVERSE: List[Tuple[str, str]] = [
    (r"(^|\.)encoder\.", r"\1encoder.backbone."),
    (r"(^|\.)patch_embed\.", r"\1patch_embed.proj."),
    (r"(^|\.)blocks_(\d+)\.", r"\1blocks.\2."),
    (r"(^|\.)layers_(\d+)\.", r"\1layers.\2."),
]

BASELINE_INVERSES = {"ppnet": _RESNET_INVERSE, "denet": _DENET_INVERSE,
                     "bam": _BAM_INVERSE, "hdmnet": _HDMNET_INVERSE,
                     "panet": _PANET_INVERSE, "dcama": _DCAMA_INVERSE,
                     "fptrans": _FPTRANS_INVERSE}

# keys of the reference checkpoints that no eval path holds (the JAX
# converters skip them too), as patterns: PPNet's training-time ASPP head,
# the losses' buffers; the buffers DCAMA computes (Swin's masks and index
# tables, the head's sine tables ``pe.{i}.pe``) and Swin's classifier
# (``norm``, ``head`` at its top); the ViTs' classifier heads
_NOT_HELD = {"ppnet": (r"aspp\.", r"\.sem"), "bam": (r"criterion",),
             "hdmnet": (r"criterion",),
             "dcama": (r"attn_mask$", r"relative_position_index$",
                       r"(^|\.)pe\.\d+\.pe$",
                       r"^(feature_extractor\.)?(norm|head)\."),
             "fptrans": (r"(^|\.)head\.", r"\.pre_logits\.")}


def state_dict_from_jax_baseline(name: str, variables: Dict[str, Any]
                                 ) -> Dict[str, torch.Tensor]:
    """The reference-layout state dict of a JAX baseline's variables
    (``{"params": ..., "batch_stats": ...}``, numpy or JAX leaves), which
    the port's model of ``name`` loads with ``strict=True``: flax paths
    mapped back by :data:`BASELINE_INVERSES` (the JAX converters' renames
    undone; PANet's ``encoder.conv_k`` to VGG16's ``encoder.features.i``),
    conv kernels (kh, kw, in, out) to (out, in, kh, kw), dense kernels
    transposed, ``scale`` to ``weight``, BatchNorm's ``mean`` / ``var`` to
    ``running_mean`` / ``running_var`` with a ``num_batches_tracked`` of 0.
    DENet's class bank ``weight`` is kept as it is; Swin's
    ``relative_position_bias_table`` and FPTrans's ``cls_token``,
    ``pos_embed`` and ``prompt_tokens`` too. A transposed convolution's
    kernel (FPTrans's purifier, (kh, kw, out, in)) takes the convolutions'
    transpose to torch's (in, out, kh, kw), as the JAX converter's."""
    renames = BASELINE_INVERSES[name]
    out: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(coll, {})).items():
            value = np.asarray(value)
            module, leaf = ".".join(path[:-1]), path[-1]
            if coll == "batch_stats":
                leaf = {"mean": "running_mean", "var": "running_var"}[leaf]
            elif leaf == "kernel":
                leaf = "weight"
                value = (value.transpose(3, 2, 0, 1) if value.ndim == 4
                         else value.T)
            elif leaf == "scale":
                leaf = "weight"
            elif leaf == "weight":              # DENet's class bank
                leaf = "estimator.weight"
            key = _apply_renames(f"{module}.{leaf}" if module else leaf,
                                 renames)
            out[key] = torch.from_numpy(np.array(value))
            if leaf == "running_mean":
                out[key[:-len("running_mean")] + "num_batches_tracked"] = \
                    torch.zeros((), dtype=torch.long)
    return out


def reference_baseline_state_dict(name: str, state: Dict[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """A reference baseline checkpoint (numpy or tensors) as the port's
    model of ``name`` loads it with ``strict=True``: a ``module.`` prefix
    dropped, and the keys that no eval path holds (PPNet's ``aspp.*`` head,
    the losses' buffers, the tables DCAMA computes, Swin's and the ViTs'
    classifiers: :data:`_NOT_HELD`), as the JAX converters drop them."""
    skip = _NOT_HELD.get(name, ())
    out = {}
    for key, value in state.items():
        key = key[len("module."):] if key.startswith("module.") else key
        if any(re.search(s, key) for s in skip):
            continue
        out[key] = (value if isinstance(value, torch.Tensor)
                    else torch.from_numpy(np.array(value)))
    return out
