"""HDMNet few-shot baseline, Hierarchically Decoupled Matching Network
(CVPR 2023) (counterpart of ``labelanything_tpu/models/hdmnet.py``;
reference: label_anything/models/hdmnet/).

BAM's deep-base dilated ResNet-50 feeds a SegFormer-style Mix
transformer: three down-sampling stages (patch embed, two efficient
self-attention layers whose keys and values come from a strided conv),
then reversed hierarchical matching in which the query's tokens
cross-attend to every support token with L2-normalized q / k, a 0.1
temperature, a softmax over the QUERY axis and the mask applied after it
(maskmultiheadattention.py:62-83); per-level similarity-conditioned
convs and parse blocks accumulate coarse to fine. BAM's base / meta
ensemble (with HDMNet's ``order[inverse]`` gather) gives the 2-way logits.
The module names are the reference's state-dict names
(``transformer.mix_transformer.down_sample_layers.0.1.attn.attn.linear_q``,
``base_learnear.2``, ...); the wrapper's are ``hdmnet.`` and those.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import (resize_bilinear, resize_bilinear_ac,
                          resize_nearest_torch)
from .bam import (BAMResNet, PPM, EPS_COS, conv3x3, ensemble, gram_estimate,
                  gram_matrix, group_rows, kshot_reweighting,
                  multiclass_forward, shot_weights, weighted_gap)
from .ppnet import BN, SameConv2d, conv1x1


def get_similarity(q: torch.Tensor, s: torch.Tensor, mask: torch.Tensor
                   ) -> torch.Tensor:
    """Max-over-support-pixels cosine prior (reference: HDMNet.py:18-35),
    no min-max normalization (unlike BAM's). q, s (B, C, h, w); mask (B,
    Hm, Wm), nearest-resized. Returns (B, 1, h, w)."""
    b, c, h, w = q.shape
    m = resize_nearest_torch((mask == 1).to(q.dtype), (h, w))
    sf = (s * m[:, None]).flatten(2)                       # (B, C, hw)
    qf = q.flatten(2)
    qn = torch.linalg.vector_norm(qf, dim=1)[:, None, :]
    sn = torch.linalg.vector_norm(sf, dim=1)[:, :, None]
    sim = torch.einsum("bcm,bcn->bmn", sf, qf) / (sn * qn + EPS_COS)
    return sim.max(dim=1).values.reshape(b, 1, h, w)


class MixFFN(nn.Module):
    """fc1, a depthwise 3 x 3, GELU, fc2 (reference: transformer.py:46-96),
    as ``layers`` 0, 1 and 4."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Conv2d(dim, hidden, 1),
            nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden),
            nn.GELU(), nn.Dropout(0.0), nn.Conv2d(hidden, dim, 1))

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        b, l, c = x.shape
        y = self.layers(x.transpose(1, 2).reshape(b, c, *hw))
        return y.flatten(2).transpose(1, 2)


class MaskAttention(nn.Module):
    """MaskMultiHeadAttention (reference: maskmultiheadattention.py):
    bias-free q / k / v / o linears; self mode: softmax over the keys at
    scale 1 / (sqrt(dk) + 1e-9); cross mode: q and k L2-normalized (eps
    1e-12), temperature 0.1, softmax over the QUERY axis, the mask's zeros
    applied after it."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        for name in ("linear_q", "linear_k", "linear_v", "linear_o"):
            setattr(self, name, nn.Linear(dim, dim, bias=False))

    def forward(self, q: torch.Tensor, kv: torch.Tensor,
                mask: Optional[torch.Tensor] = None, cross: bool = False
                ) -> torch.Tensor:
        b, lq, dim = q.shape
        heads = self.num_heads
        hd = dim // heads
        split = lambda t: t.reshape(b, t.shape[1], heads, hd).transpose(1, 2)
        qh = split(self.linear_q(q))
        kh = split(self.linear_k(kv))
        vh = split(self.linear_v(kv))
        if cross:
            qh = F.normalize(qh, dim=-1, eps=1e-12)
            kh = F.normalize(kh, dim=-1, eps=1e-12)
            attn = (qh @ kh.transpose(-1, -2) / 0.1).softmax(dim=-2)
            attn = attn.masked_fill(mask[:, None] == 0, 0.0)
        else:
            scores = qh @ kh.transpose(-1, -2) / (hd ** 0.5 + 1e-9)
            attn = scores.softmax(dim=-1)
        out = (attn @ vh).transpose(1, 2).reshape(b, lq, dim)
        return self.linear_o(out)


class EfficientAttention(nn.Module):
    """The attention of an encoder layer: ``attn``, and with a reduction
    ratio over 1 the keys' strided conv ``sr`` (flax's "SAME" padding) and
    its LayerNorm ``norm``."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1):
        super().__init__()
        self.sr_ratio = sr_ratio
        self.attn = MaskAttention(dim, num_heads)
        if sr_ratio > 1:
            self.sr = SameConv2d(dim, dim, sr_ratio, sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=1e-6)


class HDMEncoderLayer(nn.Module):
    """TransformerEncoderLayer (reference: transformer.py:156-199):
    pre-LN attention, then a MixFFN."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = EfficientAttention(dim, num_heads, sr_ratio)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.ffn = MixFFN(dim, 4 * dim)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int],
                source: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                cross: bool = False) -> torch.Tensor:
        xq = self.norm1(x)
        kv = xq if source is None else self.norm1(source)
        if self.attn.sr_ratio > 1:
            b, _, c = kv.shape
            y = self.attn.sr(kv.transpose(1, 2).reshape(b, c, *hw))
            kv = self.attn.norm(y.flatten(2).transpose(1, 2))
        x = x + self.attn.attn(xq, kv, mask, cross)
        return x + self.ffn(self.norm2(x), hw)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, kernel: int, stride: int, padding: int):
        super().__init__()
        self.projection = nn.Conv2d(dim, dim, kernel, stride, padding)
        self.norm = nn.LayerNorm(dim, eps=1e-6)


class MatchConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = conv3x3(dim + 2, dim)
        self.bn = BN(dim)


def parse_block(d: int) -> nn.Sequential:
    """conv 1 x 1, BN, conv 3 x 3, BN, conv 1 x 1, BN (then a ReLU)."""
    return nn.Sequential(nn.Conv2d(d, 4 * d, 1), BN(4 * d),
                         nn.Conv2d(4 * d, 4 * d, 3, padding=1), BN(4 * d),
                         nn.Conv2d(4 * d, d, 1), BN(d), nn.ReLU())


class MixTransformer(nn.Module):
    """(reference: transformer.py:202-356): three down stages (width 64;
    heads 2, 4, 8; key reduction 4, 2, 1; patch kernel, stride, padding
    below), reversed hierarchical matching (2 heads), parse and classifier
    heads."""

    def __init__(self):
        super().__init__()
        d = 64
        stages = [(2, 4, (1, 1, 0)), (4, 2, (3, 2, 1)), (8, 1, (3, 2, 1))]
        self.down_sample_layers = nn.ModuleList([
            nn.ModuleList([PatchEmbed(d, *patch),
                           HDMEncoderLayer(d, heads, sr),
                           HDMEncoderLayer(d, heads, sr),
                           nn.LayerNorm(d, eps=1e-6)])
            for heads, sr, patch in stages])
        self.match_layers = nn.ModuleList([
            nn.ModuleList([HDMEncoderLayer(d, 2), MatchConv(d)])
            for _ in stages])
        self.parse_layers = nn.ModuleList([parse_block(d) for _ in stages])
        self.cls = nn.Sequential(nn.Conv2d(d, 4 * d, 1), BN(4 * d),
                                 nn.Conv2d(4 * d, 4 * d, 3, padding=1),
                                 BN(4 * d), nn.Conv2d(4 * d, 2, 1))

    def forward(self, q_x: torch.Tensor, s_x: torch.Tensor,
                mask: torch.Tensor, similarity: torch.Tensor) -> torch.Tensor:
        """q_x (B, d, h, w); s_x (B Sh, d, h, w); mask (B Sh, Hm, Wm);
        similarity (B, 2, h, w). Returns the logits (B, 2, h, w)."""
        b, d = q_x.shape[:2]
        tokens = lambda t: t.flatten(2).transpose(1, 2)
        down_q, down_s, shapes, masks, sims = [], [], [], [], []
        q_map, s_map = q_x, s_x
        last = len(self.down_sample_layers) - 1
        for i, (patch, enc0, enc1, norm) in enumerate(
                self.down_sample_layers):
            qm, sm = patch.projection(q_map), patch.projection(s_map)
            hw = tuple(qm.shape[-2:])
            q_t, s_t = patch.norm(tokens(qm)), patch.norm(tokens(sm))
            for enc in (enc0, enc1):
                q_t, s_t = enc(q_t, hw), enc(s_t, hw)
            q_t, s_t = norm(q_t), norm(s_t)
            m = resize_nearest_torch(mask, hw).reshape(b, 1, -1)
            masks.append(m.expand(-1, hw[0] * hw[1], -1))
            sims.append(resize_bilinear_ac(similarity, hw))
            down_q.append(q_t)
            down_s.append(s_t.reshape(b, -1, d))
            shapes.append(hw)
            if i != last:
                q_map = q_t.transpose(1, 2).reshape(b, d, *hw)
                s_map = s_t.transpose(1, 2).reshape(-1, d, *hw)

        outs = None
        for i in reversed(range(len(shapes))):
            h, w = shapes[i]
            enc, match = self.match_layers[i]
            out = enc(down_q[i], (h, w), source=down_s[i], mask=masks[i],
                      cross=True)
            out = torch.cat([out.transpose(1, 2).reshape(b, d, h, w),
                             sims[i]], dim=1)
            out = F.relu(match.bn(match.conv(out)))
            parse = self.parse_layers[i]
            if outs is None:
                outs = parse(out)
            else:
                outs = resize_bilinear(outs, (h, w))
                outs = outs + parse(out + outs)
        return self.cls(outs)


class HDMNet(BAMResNet):
    """(reference: hdmnet/HDMNet.py:79-306 OneModel, eval path), its
    episodes in groups as :class:`..bam.BAM` takes them."""

    def __init__(self, shot: int = 1, base_classes: int = 60,
                 resnet_layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__(resnet_layers)
        self.shot = shot
        self.ppm = PPM()
        self.cls = nn.Sequential(nn.Conv2d(4096, 512, 3, padding=1,
                                           bias=False), BN(512))
        self.base_learnear = nn.Sequential(
            nn.ReLU(), nn.Identity(), nn.Conv2d(512, base_classes + 1, 1))
        self.down_query = nn.Sequential(conv1x1(1536, 256))
        self.down_supp = nn.Sequential(conv1x1(1536, 256))
        self.query_merge = nn.Sequential(conv1x1(514, 64))
        self.supp_merge = nn.Sequential(conv1x1(512, 64))
        self.transformer = nn.Module()
        self.transformer.mix_transformer = MixTransformer()
        self.gram_merge = conv1x1(2, 1)
        self.cls_merge = conv1x1(2, 1)
        if shot > 1:
            self.kshot_rw = kshot_reweighting(shot)

    def feats(self, imgs: torch.Tensor):
        f2, f3 = self.features(imgs)
        f4 = self.layer4_features(f3)
        return f2, f3, f4, self.cls(self.ppm(f4))

    def forward(self, x: torch.Tensor, s_x: torch.Tensor, s_y: torch.Tensor
                ) -> torch.Tensor:
        """x (B, 3, H, W); s_x (B, Sh, 3, H, W); s_y (B, Sh, Hm, Wm) ->
        (B, 2, H, W)."""
        return self.grouped(x, s_x[:, None], s_y[:, None])[:, 0]

    def grouped(self, x: torch.Tensor, s_x: torch.Tensor, s_y: torch.Tensor
                ) -> torch.Tensor:
        """s_x (B, G, Sh, 3, H, W), s_y (B, G, Sh, Hm, Wm) -> (B, G, 2, H,
        W)."""
        b, g, sh, _, hh, ww = s_x.shape
        assert sh == self.shot
        mh, mw = s_y.shape[-2:]
        n = b * g
        qf2, qf3, qf4, qf5 = self.feats(x)
        h3, w3 = qf3.shape[-2:]
        query_feat = F.relu(self.down_query(torch.cat([qf3, qf2], dim=1)))

        # supports: the image is masked before the backbone
        mask_m = (s_y == 1).to(x.dtype).reshape(n * sh, 1, mh, mw)
        mask_img = resize_nearest_torch(mask_m, (hh, ww))
        with torch.no_grad():
            sf2, sf3, sf4, sf5 = self.feats(
                s_x.reshape(n * sh, 3, hh, ww) * mask_img)
        supp_feat = F.relu(self.down_supp(torch.cat([sf3, sf2], dim=1)))
        mask3 = resize_bilinear_ac(mask_m, (h3, w3))
        supp_bin = weighted_gap(supp_feat, mask3).expand_as(supp_feat)

        # similarity priors from layer4 and the PPM head, shots averaged
        s_y_flat = s_y.reshape(n * sh, mh, mw)
        prior = lambda qf, sf: get_similarity(
            group_rows(qf, g * sh), sf, s_y_flat).reshape(
                n, sh, 1, h3, w3).mean(dim=1)
        similarity = torch.cat([prior(qf5, sf5), prior(qf4, sf4)], dim=1)

        supp_merged = F.relu(self.supp_merge(torch.cat([supp_feat, supp_bin],
                                                       dim=1)))
        bin_mean = supp_bin.reshape(n, sh, *supp_bin.shape[1:]).mean(dim=1)
        query_merged = F.relu(self.query_merge(torch.cat(
            [group_rows(query_feat, g), bin_mean, similarity * 10], dim=1)))
        meta_out = self.transformer.mix_transformer(
            query_merged, supp_merged, mask_m.reshape(n * sh, mh, mw),
            similarity)
        base_out = group_rows(self.base_learnear(qf5), g)

        # K-shot Gram reweighting on layer2 (HDMNet's gather)
        est_val = gram_estimate(group_rows(gram_matrix(qf2), g),
                                gram_matrix(sf2).reshape(n, sh, 512, 512))
        weight_soft = (shot_weights(est_val, self.kshot_rw, True) if sh > 1
                       else torch.ones_like(est_val))
        est_val = (weight_soft * est_val).sum(dim=1)

        final = ensemble(meta_out, base_out, est_val, self.gram_merge,
                         self.cls_merge)
        final = resize_bilinear_ac(final, (hh, ww))
        return final.reshape(b, g, 2, hh, ww)


class HDMNetMultiClass(nn.Module):
    """LAM-batch adapter (reference: hdmnet/__init__.py:31-112), BAM's
    protocol."""

    def __init__(self, shot: int = 1, base_classes: int = 60,
                 image_size: int = 473,
                 resnet_layers: Sequence[int] = (3, 4, 6, 3),
                 custom_preprocess: bool = True):
        super().__init__()
        self.shot = shot
        self.image_size = image_size
        self.custom_preprocess = custom_preprocess
        self.hdmnet = HDMNet(shot=shot, base_classes=base_classes,
                             resnet_layers=resnet_layers)

    def forward(self, batch: dict, generator=None) -> dict:
        return multiclass_forward(self, self.hdmnet, batch)


def build_hdmnet(dataset: str = "coco", shots: int = 1, val_fold_idx: int = 0,
                 image_size: int = 473, custom_preprocess: bool = True,
                 **kwargs) -> HDMNetMultiClass:
    """(reference: hdmnet/__init__.py:114-173)."""
    base_classes = 15 if dataset.lower() == "pascal" else 60
    return HDMNetMultiClass(shot=shots, base_classes=base_classes,
                            image_size=image_size,
                            custom_preprocess=custom_preprocess, **kwargs)
