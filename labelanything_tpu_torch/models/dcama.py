"""DCAMA few-shot baseline, Dense Cross-query-and-support Attention
weighted Mask Aggregation (counterpart of ``labelanything_tpu/models/
dcama.py``; reference: label_anything/models/dcama/).

A Swin-B backbone (``models/swin.py``) gives the feature map of every
block; at every block of stages 2 to 4 an attention from query pixels to
support pixels, whose values are the support mask, averaged over its 8
heads, makes a coarse mask (n shots: all shots' pixels on the key axis,
padded shots at -1e9); the coarse masks go through multi-scale conv
blocks, cascaded additions and mixer convs with skip connections up to the
input scale, ending in 2-channel (background, foreground) logits.
``DCAMAMultiClass`` runs the head once per class and merges the classes by
the BinaryLam rule. Convolutions are NCHW inside; the backbone's features
are channels-last, as the JAX package keeps them.

Module names are the reference's (``feature_extractor``, ``model
.DCAMA_blocks.{i}.linears.{0,1}``, ``model.conv{1..5}``, ``model
.mixer{1,2,3}``); the sine positional tables (``model.pe``) are computed,
not held. GroupNorm's eps is flax's 1e-6, as in the JAX package.

The backbone is frozen: it runs under ``no_grad``, so its parameters get
no gradient from the loss. The train step gives them zero gradients, so
that SGD's coupled weight decay and momentum move them as the JAX
package's optimizer does (ROADMAP C17).
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.image_norm import maybe_normalize_images
from ..ops.resize import resize_bilinear, resize_bilinear_ac
from ..typing import BatchKeys, ResultDict
from .ppnet import NEG_INF, mask_unflagged
from .swin import SwinTransformer


def sine_pe(n: int, d_model: int) -> np.ndarray:
    """(n, d_model) sine / cosine table (reference: dcama/transformer.py:
    41-60)."""
    pe = np.zeros((n, d_model), np.float32)
    position = np.arange(n)[:, None].astype(np.float32)
    div = np.exp(np.arange(0, d_model, 2).astype(np.float32)
                 * -(math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


@functools.lru_cache(maxsize=16)
def _pe(n: int, d_model: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(sine_pe(n, d_model), device=device)


class MaskAggregationAttention(nn.Module):
    """Query -> support attention whose values are the support mask
    (reference: dcama/transformer.py:9-39): per query pixel, the mask
    score averaged over heads."""

    def __init__(self, d_model: int, num_heads: int = 8):
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        self.linears = nn.ModuleList([nn.Linear(d_model, d_model)
                                      for _ in range(2)])

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                mask_values: torch.Tensor,
                key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """query (B, Q, D), key (B, K, D), mask_values (B, K); key_valid
        (B, K) or None: invalid keys (padded shots) score -1e9. -> (B, Q)."""
        b, qn, _ = query.shape
        heads, hd = self.num_heads, self.d_model // self.num_heads
        q = self.linears[0](query).reshape(b, qn, heads, hd).transpose(1, 2)
        k = self.linears[1](key).reshape(b, -1, heads, hd).transpose(1, 2)
        attn = (q @ k.transpose(-2, -1)) / math.sqrt(hd)
        if key_valid is not None:
            attn = attn.masked_fill(key_valid[:, None, None, :] <= 0, -1e9)
        out = attn.softmax(dim=-1) @ mask_values.to(attn.dtype)[:, None, :,
                                                                 None]
        return out[..., 0].mean(dim=1)


def conv_block(in_channels: int, out_channels: Sequence[int],
               kernel_sizes: Sequence[int], group: int = 4) -> nn.Sequential:
    """Conv, GroupNorm, ReLU, three times (reference: dcama/dcama.py:
    258-272): the reference's Sequential indexes 0, 1, 3, 4, 6, 7."""
    layers = []
    for out, k in zip(out_channels, kernel_sizes):
        layers += [nn.Conv2d(in_channels, out, k, padding=k // 2),
                   nn.GroupNorm(group, out, eps=1e-6), nn.ReLU()]
        in_channels = out
    return nn.Sequential(*layers)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _up2(x: torch.Tensor) -> torch.Tensor:
    return resize_bilinear_ac(x, (x.shape[-2] * 2, x.shape[-1] * 2))


class DCAMAModel(nn.Module):
    """The mask-aggregation and mixer head (reference: dcama/dcama.py:
    142-256). ``stack_ids``: cumulative block counts per stage (Swin-B:
    (2, 4, 22, 24)); features from index ``stack_ids[0]`` on take part."""

    def __init__(self, in_channels: Sequence[int] = (128, 256, 512, 1024),
                 stack_ids: Sequence[int] = (2, 4, 22, 24)):
        super().__init__()
        self.in_channels, self.stack_ids = tuple(in_channels), tuple(stack_ids)
        s0, s1, s2, s3 = stack_ids
        self.DCAMA_blocks = nn.ModuleList(
            [MaskAggregationAttention(in_channels[level + 1])
             for level in range(3)])
        o1, o2, o3 = 16, 64, 128
        self.conv1 = conv_block(s3 - s2, (o1, o2, o3), (3, 3, 3))
        self.conv2 = conv_block(s2 - s1, (o1, o2, o3), (5, 3, 3))
        self.conv3 = conv_block(s1 - s0, (o1, o2, o3), (5, 5, 3))
        self.conv4 = conv_block(o3, (o3, o3, o3), (3, 3, 3))
        self.conv5 = conv_block(o3, (o3, o3, o3), (3, 3, 3))
        skip = o3 + 2 * in_channels[1] + 2 * in_channels[0]
        self.mixer1 = nn.Sequential(nn.Conv2d(skip, o3, 3, padding=1),
                                    nn.ReLU(), nn.Conv2d(o3, o2, 3, padding=1),
                                    nn.ReLU())
        self.mixer2 = nn.Sequential(nn.Conv2d(o2, o2, 3, padding=1),
                                    nn.ReLU(), nn.Conv2d(o2, o1, 3, padding=1),
                                    nn.ReLU())
        self.mixer3 = nn.Sequential(nn.Conv2d(o1, o1, 3, padding=1),
                                    nn.ReLU(), nn.Conv2d(o1, 2, 3, padding=1))

    def forward(self, query_feats: List[torch.Tensor],
                support_feats: List[torch.Tensor], support_mask: torch.Tensor,
                shot_flags: Optional[torch.Tensor] = None) -> torch.Tensor:
        """query_feats: per block (B, H_s, W_s, C_s); support_feats: per
        block (B, M, H_s, W_s, C_s); support_mask (B, M, Hm, Wm) binary;
        shot_flags (B, M) or None. -> logits (B, 2, H, W) at the input
        scale. All shots' pixels are keys of one attention, each shot with
        the same positional table; the skip connections take the support
        features' maximum over the flagged shots (reference: dcama/dcama.py:
        190-245)."""
        s0, s1, s2, s3 = self.stack_ids
        m = support_feats[0].shape[1]
        if shot_flags is None:
            shot_flags = torch.ones(support_mask.shape[:2],
                                    device=support_mask.device)
        flagged = shot_flags > 0

        def shot_max(sf: torch.Tensor) -> torch.Tensor:
            """(B, M, h, w, ch) -> (B, ch, h, w): the maximum over flagged
            shots, 0 where no shot is flagged."""
            mx = sf.masked_fill(~flagged[:, :, None, None, None],
                                NEG_INF).amax(dim=1)
            return _nchw(torch.where(torch.isfinite(mx), mx,
                                     torch.zeros_like(mx)))

        masks = support_mask.float().reshape((-1,) + support_mask.shape[2:])
        coarse = []
        for idx in range(s0, s3):
            qf, sf = query_feats[idx], support_feats[idx]
            b, ha, wa, ch = qf.shape
            mask = resize_bilinear_ac(masks, (ha, wa)).reshape(b, m * ha * wa)
            level = 0 if idx < s1 else (1 if idx < s2 else 2)
            pe = _pe(ha * wa, self.in_channels[level + 1], qf.device)
            keys = sf.reshape(b, m, ha * wa, ch) + pe
            key_valid = shot_flags.repeat_interleave(ha * wa, dim=1)
            out = self.DCAMA_blocks[level](
                qf.reshape(b, -1, ch) + pe, keys.reshape(b, m * ha * wa, ch),
                mask, key_valid)
            coarse.append(out.reshape(b, 1, ha, wa))

        cm1 = self.conv1(torch.cat(coarse[s2 - s0:s3 - s0], dim=1))  # 1/32
        cm2 = self.conv2(torch.cat(coarse[s1 - s0:s2 - s0], dim=1))  # 1/16
        cm3 = self.conv3(torch.cat(coarse[0:s1 - s0], dim=1))        # 1/8
        mix = self.conv4(resize_bilinear_ac(cm1, cm2.shape[-2:]) + cm2)
        mix = self.conv5(resize_bilinear_ac(mix, cm3.shape[-2:]) + cm3)

        mix = torch.cat([mix, _nchw(query_feats[s1 - 1]),
                         shot_max(support_feats[s1 - 1])], dim=1)
        mix = torch.cat([_up2(mix), _nchw(query_feats[s0 - 1]),
                         shot_max(support_feats[s0 - 1])], dim=1)
        out = _up2(self.mixer1(mix))
        out = _up2(self.mixer2(out))
        return self.mixer3(out)


class DCAMAMultiClass(nn.Module):
    """LAM-batch adapter (reference: dcama/__init__.py:42-144): the binary
    head once per foreground class (its support mask that class's mask
    prompt in every shot, padded shots dropped by the class's flags), the
    classes merged by the BinaryLam rule (the background of the class
    whose foreground wins), resized to ``image_size``, -inf on the classes
    that ``FLAG_GTS`` leaves out. ``backbone`` replaces the Swin-B (tests
    put in a small one)."""

    def __init__(self, image_size: int = 384,
                 backbone: Optional[nn.Module] = None,
                 stack_ids: Sequence[int] = (2, 4, 22, 24),
                 in_channels: Sequence[int] = (128, 256, 512, 1024),
                 custom_preprocess: bool = True):
        super().__init__()
        self.image_size = image_size
        self.custom_preprocess = custom_preprocess
        self.feature_extractor = (backbone if backbone is not None
                                  else SwinTransformer(img_size=image_size))
        self.model = DCAMAModel(in_channels=in_channels, stack_ids=stack_ids)

    def forward(self, batch: dict, generator=None) -> dict:
        images = maybe_normalize_images(
            batch[BatchKeys.IMAGES], batch[BatchKeys.DIMS], self.image_size,
            self.custom_preprocess, batch.get(BatchKeys.RESIZED_DIMS))
        b, n = images.shape[:2]
        with torch.no_grad():      # the frozen backbone
            feats = self.feature_extractor(
                images.reshape((b * n,) + images.shape[2:]))
        feats = [f.reshape((b, n) + f.shape[1:]) for f in feats]
        query_feats = [f[:, 0] for f in feats]
        support_feats = [f[:, 1:] for f in feats]

        flag = batch[BatchKeys.FLAG_EXAMPLES].float()        # (B, M, C)
        prompt = batch.get(BatchKeys.PROMPT_MASKS)
        if prompt is None:
            # a training batch whose episodes drew no mask prompt (ROADMAP
            # C17): no class has a support mask
            prompt = torch.zeros(flag.shape + images.shape[2:4],
                                 device=images.device)
        prompt = prompt.float()                              # (B, M, C, h, w)
        if prompt.shape[1] == n:
            # a full batch: slot 0 is the query's own annotation
            prompt, flag = prompt[:, 1:], flag[:, 1:]
        m, c = prompt.shape[1:3]
        if m != n - 1:
            raise ValueError(f"prompt masks of {m} shots for {n - 1} "
                             f"support images")
        per_class = [self.model(query_feats, support_feats, prompt[:, :, ci],
                                flag[:, :, ci]) for ci in range(1, c)]
        logits = torch.stack(per_class, dim=1)               # (B, C-1, 2, h, w)
        fg, bgs = logits[:, :, 1], logits[:, :, 0]
        bg = bgs.gather(1, fg.argmax(dim=1, keepdim=True))
        seg = resize_bilinear(torch.cat([bg, fg], dim=1),
                              (self.image_size, self.image_size))
        return {ResultDict.LOGITS: mask_unflagged(seg, batch)}


def build_dcama(backbone: str = "swin", image_size: int = 384,
                custom_preprocess: bool = True) -> DCAMAMultiClass:
    """(reference: dcama/__init__.py:12-40). An argument it does not know
    raises; ``backbone_checkpoint`` is dropped before it, in
    ``api.build_from_config`` (ROADMAP C17)."""
    if backbone != "swin":
        raise NotImplementedError("only the Swin-B DCAMA backbone is ported")
    return DCAMAMultiClass(image_size=image_size,
                           custom_preprocess=custom_preprocess)
