"""DENet few-shot baseline, Dynamic Extension Nets (ACM MM 2020)
(counterpart of ``labelanything_tpu/models/denet.py``; reference:
label_anything/models/denet/).

A frozen dilated ResNet-50 (layer3, stride 8) feeds a dilated embedding
conv and a DeepLab head (BN-free ASPP with a pooled branch); support
prototypes (GAM channel gate, masked average pooling, 1 x 1 projection)
overwrite their classes' rows of a learned class-weight bank; the logits
are pixel features times class weights, reduced per way to [max over the
other classes, own class]. The module names are the reference's
state-dict names (``estimator.gam.gate.0``, ``deeplab_head.aspp.convs.4.1``,
...); the wrapper's are ``denet.`` and those.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear, resize_nearest_torch
from ..typing import BatchKeys, ResultDict
from .ppnet import (BN, NEG_INF, ResNetSem, channels_first_images,
                    example_masks, mask_unflagged)

DEPTH = 256          # the head's and the prototypes' width


class RegASPP(nn.Module):
    """BN-free ASPP (reference: denet/common.py:61-91): a 1 x 1, 3 x 3s
    dilated 6 / 12 / 18 and a pooled branch."""

    def __init__(self):
        super().__init__()
        convs = [nn.Sequential(nn.Conv2d(DEPTH, DEPTH, 1), nn.ReLU())]
        for rate in (6, 12, 18):
            convs.append(nn.Sequential(
                nn.Conv2d(DEPTH, DEPTH, 3, padding=rate, dilation=rate),
                nn.ReLU()))
        convs.append(nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                   nn.Conv2d(DEPTH, DEPTH, 1), nn.ReLU()))
        self.convs = nn.ModuleList(convs)
        self.project = nn.Sequential(nn.Conv2d(5 * DEPTH, DEPTH, 1),
                                     nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = [conv(x) for conv in self.convs[:-1]]
        pooled = self.convs[-1](x)
        res.append(pooled.expand_as(res[0]))
        return self.project(torch.cat(res, dim=1))


class DeepLabHead(nn.Module):
    """(reference: denet/common.py:131-147)."""

    def __init__(self):
        super().__init__()
        self.aspp = RegASPP()
        self.conv1 = nn.Conv2d(DEPTH, DEPTH, 3, padding=1, bias=False)
        self.bn = BN(DEPTH)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv1(self.aspp(x))))


class GAM(nn.Module):
    """Guided-attention channel gate (reference: common.py:216-249)."""

    def __init__(self):
        super().__init__()
        self.gate = nn.Sequential(nn.Conv2d(DEPTH, DEPTH, 1), nn.ReLU(),
                                  nn.Conv2d(DEPTH, DEPTH, 1))

    def forward(self, fs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
        """fs (N, C, h, w); ys (N, H, W) binary."""
        mask = resize_nearest_torch(ys, fs.shape[-2:])[:, None]
        att = (fs * mask).mean(dim=(2, 3), keepdim=True)
        return fs * torch.sigmoid(self.gate(att))


class MaskedAveragePooling(nn.Module):
    """(reference: common.py:150-201): nearest mask resize, masked mean with
    ``eps`` on the denominator, a 1 x 1 projection."""

    def __init__(self):
        super().__init__()
        self.linear = nn.Conv2d(DEPTH, DEPTH, 1)

    def forward(self, emb: torch.Tensor, mask: torch.Tensor,
                eps: float = 1e-3) -> torch.Tensor:
        m = resize_nearest_torch(mask, emb.shape[-2:])[:, None]
        num = (m * emb).sum(dim=(2, 3), keepdim=True)
        den = m.sum(dim=(2, 3), keepdim=True)
        return self.linear(num / (den + eps))               # (N, C, 1, 1)


class WeightEstimator(nn.Module):
    """The class-weight bank and the prototype path (reference:
    common.py WeightEstimator, 'training'-mode extension)."""

    def __init__(self, maximum_num_classes: int = 21):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(maximum_num_classes, DEPTH))
        self.gam = GAM()
        self.map = MaskedAveragePooling()


def get_binary_logits(logits_full: torch.Tensor, label: torch.Tensor
                      ) -> torch.Tensor:
    """[max over the other class channels, own channel] (reference:
    denet/utils.py:313-338). logits_full (N, K, h, w), label (N,) ->
    (N, 2, h, w)."""
    k = logits_full.shape[1]
    lab = label.long()
    own = logits_full.gather(1, lab[:, None, None, None].expand(
        -1, 1, *logits_full.shape[2:]))[:, 0]
    other = torch.arange(k, device=lab.device)[None] != lab[:, None]
    others = torch.where(other[:, :, None, None], logits_full,
                         torch.full_like(logits_full, NEG_INF))
    return torch.stack([others.max(dim=1).values, own], dim=1)


class DENet(nn.Module):
    """(reference: denet/head/denet.py:8-96). ``backbone`` replaces the
    frozen ResNet (the golden case's tiny conv)."""

    def __init__(self, maximum_num_classes: int = 21,
                 resnet_layers: Sequence[int] = (3, 4, 6, 3),
                 backbone: Optional[nn.Module] = None):
        super().__init__()
        self.backbone = backbone or ResNetSem(
            layers=resnet_layers, out_layer="layer3", quirk_last_relu=False)
        self.embedding = nn.Sequential(      # from layer3's 1024 channels
            nn.Conv2d(1024, DEPTH, 3, padding=2, dilation=2), nn.ReLU())
        self.deeplab_head = DeepLabHead()
        self.estimator = WeightEstimator(maximum_num_classes)

    def embed(self, imgs: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():                     # the backbone is frozen
            f = self.backbone(imgs)
        return self.deeplab_head(self.embedding(f))

    def forward(self, s_imgs: torch.Tensor, s_masks: torch.Tensor,
                q_img: torch.Tensor, label: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """s_imgs (B, Wa, Sh, 3, H, W); s_masks (B, Wa, Sh, H, W) binary;
        q_img (B, 3, H, W); label (B, Wa) rows of the class bank. Returns
        (logits_full (B, K, h, w), logits_binary (B Wa, 2, h, w))."""
        b, wa, sh, _, hh, ww = s_imgs.shape
        fs = self.embed(s_imgs.reshape(b * wa * sh, 3, hh, ww))
        fq = self.embed(q_img)
        h, w = fq.shape[-2:]
        ys = s_masks.reshape(b * wa * sh, hh, ww)
        est = self.estimator
        protos = est.map(est.gam(fs, ys), ys)[:, :, 0, 0]
        protos = protos.reshape(b, wa, sh, DEPTH).mean(dim=2)
        # the episode's rows of the bank replaced by its prototypes
        # (reference: common.py:334-349)
        label = label.long()
        weights = est.weight.expand(b, -1, -1).scatter(
            1, label[..., None].expand(-1, -1, DEPTH), protos)
        logits_full = torch.einsum("bchw,bkc->bkhw", fq, weights)
        binary = torch.stack([get_binary_logits(logits_full, label[:, way])
                              for way in range(wa)], dim=1)
        return logits_full, binary.reshape(b * wa, 2, h, w)


class DENetMultiClass(nn.Module):
    """LAM-batch adapter (reference: denet/__init__.py:39-117) with the
    BinaryLam background-gather merge. Supports are way-major "(k c)";
    the bank's rows are ``INTENDED_CLASSES`` where the batch carries them
    on the device, else the episode's 1 .. C - 1."""

    def __init__(self, image_size: int = 417, maximum_num_classes: int = 21,
                 resnet_layers: Sequence[int] = (3, 4, 6, 3),
                 custom_preprocess: bool = True):
        super().__init__()
        self.image_size = image_size
        self.custom_preprocess = custom_preprocess
        self.denet = DENet(maximum_num_classes=maximum_num_classes,
                           resnet_layers=resnet_layers)

    def forward(self, batch: dict, generator=None) -> dict:
        images = channels_first_images(batch, self.image_size,
                                       self.custom_preprocess)
        b, n_imgs, _, hh, ww = images.shape
        qry, sup = images[:, 0], images[:, 1:]
        masks = example_masks(batch, n_imgs)
        m, c = masks.shape[1:3]
        c_fg = c - 1
        k = m // c_fg
        sup = sup.reshape(b, k, c_fg, 3, hh, ww).transpose(1, 2)
        ys = resize_nearest_torch(masks, (hh, ww))
        ys = ys.reshape(b, k, c_fg, c, hh, ww).transpose(1, 2)
        # each way's examples, their own class's channel
        ys = torch.stack([ys[:, ci - 1, :, ci] for ci in range(1, c)], dim=1)
        label = batch.get(BatchKeys.INTENDED_CLASSES)
        if isinstance(label, torch.Tensor):
            label = label.reshape(b, -1)[:, :c_fg]
        else:
            label = torch.arange(1, c, device=ys.device).expand(b, -1)
        _, binary = self.denet(sup, ys, qry, label)
        binary = binary.reshape(b, c_fg, 2, *binary.shape[2:])
        fg, bgs = binary[:, :, 1], binary[:, :, 0]
        bg = bgs.gather(1, fg.argmax(dim=1, keepdim=True))
        seg = resize_bilinear(torch.cat([bg, fg], dim=1),
                              (self.image_size, self.image_size))
        return {ResultDict.LOGITS: mask_unflagged(seg, batch)}


def build_denet(maximum_num_classes: int = 21, image_size: int = 417,
                custom_preprocess: bool = True, **kwargs) -> DENetMultiClass:
    """(reference: denet/__init__.py:119-122)."""
    return DENetMultiClass(image_size=image_size,
                           maximum_num_classes=maximum_num_classes,
                           custom_preprocess=custom_preprocess, **kwargs)
