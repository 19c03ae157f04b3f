"""BAM few-shot baseline, Base and Meta learner ensemble (CVPR 2022)
(counterpart of ``labelanything_tpu/models/bam.py``; reference:
label_anything/models/bam/).

* :class:`BAMResNet`: the PSPNet deep-base dilated ResNet-50 (3-conv stem
  to 128 channels, dilation 2 / 4 in layers 3 / 4, output stride 8), whose
  ``layer4`` the supports run on masked layer3 features.
* Meta learner: down-projected features, weighted-GAP prototypes, the
  per-shot Gram-difference reweighting, the cosine prior from masked
  layer4 support pixels, merge convs, ASPP, residual blocks, a 2-way head.
* Base learner: the frozen PSPNet PPM and classifier over layer4, whose
  non-target mass fuses with the meta background in the 2 -> 1 ensemble
  convs.

The module names are the reference's state-dict names (``layer0.0``,
``learner_base.0.features.1.1``, ``ASPP_meta.layer6_2.0``, ...); the
wrapper's are ``bam.`` and those. :class:`BAM` takes its episodes in
groups (one query, a support set a group): the query's features, Gram
matrix and base learner are computed once for all the groups, which are
the wrapper's classes.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import adaptive_avg_pool, resize_bilinear_ac
from ..typing import BatchKeys, ResultDict
from .ppnet import (BN, Bottleneck, SameConv2d, channels_first_images,
                    conv1x1, example_masks, mask_unflagged)

EPS_COS = 1e-7


def conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=False)


class BAMResNet(nn.Module):
    """Deep-base dilated ResNet (reference: bam/resnet.py:100-165 and the
    PSPNet.py:75-87 surgery), its modules at the top level as the
    reference's BAM and HDMNet hold them. :meth:`features` gives (layer2,
    layer3); :meth:`layer4_features` runs layer4."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        # the stride-2 stem conv pads as flax's "SAME": high side only on an
        # even size (the reference pads 1 all round: equal on odd sizes)
        self.layer0 = nn.Sequential(
            SameConv2d(3, 64, 3, 2, bias=False), BN(64), nn.ReLU(),
            conv3x3(64, 64), BN(64), nn.ReLU(),
            conv3x3(64, 128), BN(128), nn.ReLU())
        cin = 128
        # (planes, first stride, dilation): stride 1 and uniform dilation
        # 2 / 4 in layers 3 / 4 after the surgery
        for i, (planes, stride, dil) in enumerate(
                [(64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4)]):
            blocks = []
            for bi in range(layers[i]):
                blocks.append(Bottleneck(cin, planes, stride if bi == 0 else 1,
                                         dil, bi == 0))
                cin = planes * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    def features(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = F.max_pool2d(self.layer0(x), 3, 2, padding=1)
        f2 = self.layer2(self.layer1(x))
        return f2, self.layer3(f2)

    def layer4_features(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer4(x)


class PPM(nn.Module):
    """Pyramid pooling (reference: bam/PPM.py)."""

    bins = (1, 2, 3, 6)

    def __init__(self):
        super().__init__()
        self.features = nn.ModuleList([
            nn.Sequential(nn.AdaptiveAvgPool2d(b), conv1x1(2048, 512),
                          BN(512), nn.ReLU()) for b in self.bins])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = [x]
        for b, f in zip(self.bins, self.features):
            p = adaptive_avg_pool(x, (b, b))
            p = F.relu(f[2](f[1](p)))
            out.append(resize_bilinear_ac(p, x.shape[-2:]))
        return torch.cat(out, dim=1)


class ASPPMeta(nn.Module):
    """(reference: bam/ASPP.py): a pooled branch, a 1 x 1 and 3 x 3s dilated
    6 / 12 / 18, concatenated in that order."""

    def __init__(self):
        super().__init__()
        self.layer6_0 = nn.Sequential(nn.Conv2d(256, 256, 1), nn.ReLU())
        self.layer6_1 = nn.Sequential(nn.Conv2d(256, 256, 1), nn.ReLU())
        for i, rate in enumerate((6, 12, 18)):
            setattr(self, f"layer6_{i + 2}", nn.Sequential(
                nn.Conv2d(256, 256, 3, padding=rate, dilation=rate),
                nn.ReLU()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.layer6_0(x.mean(dim=(2, 3), keepdim=True))
        outs = [g.expand(-1, -1, *x.shape[-2:]), self.layer6_1(x)]
        outs += [getattr(self, f"layer6_{i}")(x) for i in (2, 3, 4)]
        return torch.cat(outs, dim=1)


def weighted_gap(feat: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked global average pooling (reference: BAM.py:19-24). feat
    (N, C, h, w), mask (N, 1, h, w) -> (N, C, 1, 1)."""
    num = (feat * mask).sum(dim=(2, 3), keepdim=True)
    return num / (mask.sum(dim=(2, 3), keepdim=True) + 0.0005)


def gram_matrix(feat: torch.Tensor) -> torch.Tensor:
    """Normalized Gram matrix (reference: BAM.py:26-33). feat (N, C, h, w)
    -> (N, C, C)."""
    f = feat.flatten(2)                                    # (N, C, hw)
    norm = torch.linalg.vector_norm(f, dim=2, keepdim=True)
    return torch.bmm(f, f.transpose(1, 2)) / (
        norm * norm.transpose(1, 2) + EPS_COS)


def gram_estimate(que_gram: torch.Tensor, sup_gram: torch.Tensor
                  ) -> torch.Tensor:
    """The Frobenius distance of each shot's Gram matrix from the query's,
    over that of a matrix of ones. que_gram (N, C, C), sup_gram (N, Sh, C,
    C) -> (N, Sh)."""
    c = que_gram.shape[1]
    diff = (que_gram[:, None] - sup_gram).flatten(2)
    return torch.linalg.vector_norm(diff, dim=-1) / float(c)


def ensemble(meta_out: torch.Tensor, base_out: torch.Tensor,
             est_val: torch.Tensor, gram_merge: nn.Conv2d,
             cls_merge: nn.Conv2d) -> torch.Tensor:
    """The classifier ensemble (reference: BAM.py:277-299): the meta
    background and foreground each merged with the Gram estimate, then the
    background with the base learner's foreground mass. Returns (N, 2, h,
    w)."""
    meta_soft = meta_out.softmax(dim=1)
    base_soft = base_out.softmax(dim=1)
    meta_bg, meta_fg = meta_soft[:, 0:1], meta_soft[:, 1:2]
    base_map = base_soft[:, 1:].sum(dim=1, keepdim=True)
    est_map = est_val[:, None, None, None].expand_as(meta_fg)
    meta_bg = gram_merge(torch.cat([meta_bg, est_map], dim=1))
    meta_fg = gram_merge(torch.cat([meta_fg, est_map], dim=1))
    merge_bg = cls_merge(torch.cat([meta_bg, base_map], dim=1))
    return torch.cat([merge_bg, meta_fg], dim=1)


def shot_weights(est_val: torch.Tensor, kshot_rw: nn.Sequential,
                 hdmnet_gather: bool = False) -> torch.Tensor:
    """Softmax weights of the shots (reference: BAM.py:225-237): the sorted
    estimates through the 1 x 1 MLP, put back in shot order. HDMNet gathers
    by ``order[inverse]`` in place of ``inverse`` (HDMNet.py:233-239).
    est_val (N, Sh) -> (N, Sh)."""
    order = est_val.argsort(dim=1, stable=True)
    val1 = est_val.gather(1, order)
    inv = order.argsort(dim=1, stable=True)
    if hdmnet_gather:
        inv = order.gather(1, inv)
    wgt = kshot_rw(val1[:, :, None, None])[:, :, 0, 0]
    return wgt.gather(1, inv).softmax(dim=1)


def kshot_reweighting(shot: int) -> nn.Sequential:
    """The 1 x 1 MLP over the sorted Gram estimates, through 2 units."""
    return nn.Sequential(nn.Conv2d(shot, 2, 1), nn.ReLU(),
                         nn.Conv2d(2, shot, 1))


def group_rows(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, ...) -> (B G, ...), each row repeated for its ``groups``."""
    return x.repeat_interleave(groups, dim=0)


class BAM(BAMResNet):
    """(reference: bam/BAM.py:37-317 OneModel, eval path)."""

    def __init__(self, shot: int = 1, base_classes: int = 60,
                 resnet_layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__(resnet_layers)
        self.shot = shot
        self.learner_base = nn.ModuleList([
            PPM(), nn.Sequential(nn.Conv2d(4096, 512, 3, padding=1,
                                           bias=False),
                                 BN(512), nn.ReLU(), nn.Dropout(0.1),
                                 nn.Conv2d(512, base_classes + 1, 1))])
        self.down_query = nn.Sequential(conv1x1(1536, 256))
        self.down_supp = nn.Sequential(conv1x1(1536, 256))
        self.init_merge = nn.Sequential(conv1x1(513, 256))
        self.ASPP_meta = ASPPMeta()
        self.res1_meta = nn.Sequential(conv1x1(1280, 256))
        self.res2_meta = nn.Sequential(conv3x3(256, 256), nn.ReLU(),
                                       conv3x3(256, 256))
        self.cls_meta = nn.Sequential(conv3x3(256, 256), nn.ReLU(),
                                      nn.Dropout(0.1),
                                      nn.Conv2d(256, 2, 1))
        self.gram_merge = conv1x1(2, 1)
        self.cls_merge = conv1x1(2, 1)
        if shot > 1:
            self.kshot_rw = kshot_reweighting(shot)

    def forward(self, x: torch.Tensor, s_x: torch.Tensor, s_y: torch.Tensor
                ) -> torch.Tensor:
        """x (B, 3, H, W); s_x (B, Sh, 3, H, W); s_y (B, Sh, Hm, Wm) binary
        at any resolution. Returns the logits (B, 2, H, W)."""
        return self.grouped(x, s_x[:, None], s_y[:, None])[:, 0]

    def grouped(self, x: torch.Tensor, s_x: torch.Tensor, s_y: torch.Tensor
                ) -> torch.Tensor:
        """One query, G support sets: s_x (B, G, Sh, 3, H, W), s_y (B, G,
        Sh, Hm, Wm) -> (B, G, 2, H, W)."""
        b, g, sh, _, hh, ww = s_x.shape
        assert sh == self.shot
        mh, mw = s_y.shape[-2:]
        n = b * g
        qf2, qf3 = self.features(x)
        qf4 = self.layer4_features(qf3)
        query_feat = F.relu(self.down_query(torch.cat([qf3, qf2], dim=1)))
        h3, w3 = qf3.shape[-2:]
        sp = qf4.shape[-2]

        # supports (frozen): layer4 on the masked layer3 features
        with torch.no_grad():
            sf2, sf3 = self.features(s_x.reshape(n * sh, 3, hh, ww))
        mask_img = (s_y == 1).to(x.dtype).reshape(n * sh, 1, mh, mw)
        mask3 = resize_bilinear_ac(mask_img, (h3, w3))
        with torch.no_grad():
            sf4 = self.layer4_features(sf3 * mask3)
        supp_feat = F.relu(self.down_supp(torch.cat([sf3, sf2], dim=1)))
        supp_pro = weighted_gap(supp_feat, mask3).reshape(n, sh, -1)

        # K-shot Gram reweighting on layer2
        que_gram = group_rows(gram_matrix(qf2), g)
        sup_gram = gram_matrix(sf2)
        est_val = gram_estimate(que_gram, sup_gram.reshape(
            n, sh, *sup_gram.shape[1:]))                   # (N, Sh)
        weight_soft = (shot_weights(est_val, self.kshot_rw) if sh > 1
                       else torch.ones_like(est_val))
        est_val = (weight_soft * est_val).sum(dim=1)

        # the prior mask (reference: BAM.py:240-263)
        mask4 = resize_bilinear_ac(mask3, (sp, sp))
        s4m = (sf4 * mask4).reshape(n, sh, sf4.shape[1], -1)
        q4 = group_rows(qf4.flatten(2), g)                 # (N, C, hw)
        qn = torch.linalg.vector_norm(q4, dim=1)[:, None, None, :]
        sn = torch.linalg.vector_norm(s4m, dim=2)[..., None]
        sim = torch.einsum("bscm,bcn->bsmn", s4m, q4) / (sn * qn + EPS_COS)
        sim = sim.max(dim=2).values                        # (N, Sh, hw)
        smin = sim.min(dim=2, keepdim=True).values
        smax = sim.max(dim=2, keepdim=True).values
        sim = (sim - smin) / (smax - smin + EPS_COS)
        corr = resize_bilinear_ac(sim.reshape(n * sh, 1, sp, sp), (h3, w3))
        corr = corr.reshape(n, sh, h3, w3)
        corr_query_mask = torch.einsum("bs,bshw->bhw", weight_soft,
                                       corr)[:, None]

        supp_pro = torch.einsum("bs,bsc->bc", weight_soft, supp_pro)
        merge = torch.cat([group_rows(query_feat, g),
                           supp_pro[:, :, None, None].expand(
                               -1, -1, h3, w3), corr_query_mask], dim=1)
        merge = F.relu(self.init_merge(merge))

        # base learner (frozen PSPNet head), once a query
        head = self.learner_base[1]
        base = F.relu(head[1](head[0](self.learner_base[0](qf4))))
        base_out = group_rows(head[4](base), g)

        # meta learner
        meta = F.relu(self.res1_meta(self.ASPP_meta(merge)))
        r = F.relu(self.res2_meta[0](meta))
        meta = F.relu(self.res2_meta[2](r)) + meta
        meta_out = self.cls_meta[3](F.relu(self.cls_meta[0](meta)))

        final = ensemble(meta_out, base_out, est_val, self.gram_merge,
                         self.cls_merge)
        final = resize_bilinear_ac(final, (hh, ww))
        return final.reshape(b, g, 2, hh, ww)


def select_supports(sup: torch.Tensor, masks: torch.Tensor,
                    flag: torch.Tensor, shot: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per class 1 .. C - 1, the first ``shot`` examples that flag it, the
    last repeated where fewer do (an argsort with a 1e-4 tie-break by
    index, reference bam/__init__.py:50-60). sup (B, M, 3, H, W), masks
    (B, M, C, Hm, Wm), flag (B, M, C) -> s_x (B, C - 1, shot, 3, H, W),
    s_y (B, C - 1, shot, Hm, Wm)."""
    b, m, c = flag.shape
    fl = flag[:, :, 1:].float().transpose(1, 2)            # (B, C-1, M)
    ramp = torch.arange(m, device=fl.device, dtype=torch.float32) * 1e-4
    order = (-fl + ramp).argsort(dim=2, stable=True)
    count = fl.sum(dim=2).int().clamp(min=1)
    pos = torch.minimum(torch.arange(shot, device=fl.device)[None, None],
                        count[..., None] - 1)
    sel = order.gather(2, pos.long())                      # (B, C-1, shot)
    rows = torch.arange(b, device=fl.device)[:, None, None]
    s_x = sup[rows, sel]
    cls = torch.arange(1, c, device=fl.device)[None, :, None]
    s_y = masks[rows, sel, cls]
    return s_x, s_y


def merge_binary(logits: torch.Tensor) -> torch.Tensor:
    """Per-class binary logits (B, C - 1, 2, H, W) -> (B, C, H, W): the
    foregrounds, and the background of the class whose foreground is
    largest."""
    fg, bgs = logits[:, :, 1], logits[:, :, 0]
    bg = bgs.gather(1, fg.argmax(dim=1, keepdim=True))
    return torch.cat([bg, fg], dim=1)


class BAMMultiClass(nn.Module):
    """LAM-batch adapter (reference: bam/__init__.py:40-72): per class the
    flagged supports (:func:`select_supports`), all classes in one grouped
    forward, the binary outputs merged BinaryLam-style."""

    def __init__(self, shot: int = 1, base_classes: int = 60,
                 image_size: int = 473,
                 resnet_layers: Sequence[int] = (3, 4, 6, 3),
                 custom_preprocess: bool = True):
        super().__init__()
        self.shot = shot
        self.image_size = image_size
        self.custom_preprocess = custom_preprocess
        self.bam = BAM(shot=shot, base_classes=base_classes,
                       resnet_layers=resnet_layers)

    def forward(self, batch: dict, generator=None) -> dict:
        return multiclass_forward(self, self.bam, batch)


def multiclass_forward(wrapper: nn.Module, model: nn.Module, batch: dict
                       ) -> dict:
    """BAM's and HDMNet's adapter: ``model.grouped`` on every class's
    supports, merged, the unflagged classes -inf."""
    images = channels_first_images(batch, wrapper.image_size,
                                   wrapper.custom_preprocess)
    n_imgs = images.shape[1]
    qry, sup = images[:, 0], images[:, 1:]
    masks = example_masks(batch, n_imgs)
    flag = batch[BatchKeys.FLAG_EXAMPLES]
    if batch[BatchKeys.PROMPT_MASKS].shape[1] == n_imgs:
        flag = flag[:, 1:]
    s_x, s_y = select_supports(sup, masks, flag, wrapper.shot)
    seg = merge_binary(model.grouped(qry, s_x, s_y))
    return {ResultDict.LOGITS: mask_unflagged(seg, batch)}


def build_bam(dataset: str = "coco", shots: int = 1, val_fold_idx: int = 0,
              image_size: int = 473, custom_preprocess: bool = True,
              **kwargs) -> BAMMultiClass:
    """(reference: bam/__init__.py:75-147): 15 base classes for PASCAL, 60
    for COCO."""
    base_classes = 15 if dataset.lower() == "pascal" else 60
    return BAMMultiClass(shot=shots, base_classes=base_classes,
                         image_size=image_size,
                         custom_preprocess=custom_preprocess, **kwargs)
