"""PANet few-shot baseline (counterpart of
``labelanything_tpu/models/panet.py``; reference:
label_anything/models/panet/): a VGG16 encoder, masked-average-pooling
prototypes (the background the complement of every class) and a scaled
cosine similarity, adapted to the LAM episode batch.

The encoder's names are torchvision's ``vgg16().features`` indexes, so its
convolutions are ``encoder.features.{0, 2, 5, 7, 10, 12, 14, 17, 19, 21,
24, 26, 28}``: the JAX package's ``encoder.conv_0`` to ``conv_12`` in
order (``utils/weights.state_dict_from_jax_baseline``). The pools are 2 x 2
with flax's ``"SAME"`` padding (-inf on the high side where the size is
odd, and for the fourth pool, whose stride is 1); the last three convs
are dilated 2: stride-8 features, as the JAX package has them.
``SAMFewShotModel`` (SAM filling missing support masks) waits for the SAM
builders (ROADMAP A13).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear, resize_nearest
from ..typing import BatchKeys, ResultDict
from .ppnet import channels_first_images, mask_unflagged

VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512)


class SamePool(nn.Module):
    """2 x 2 max pool with flax's "SAME" padding at ``stride``."""

    def __init__(self, stride: int):
        super().__init__()
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        s = self.stride
        ph = max((-(-h // s) - 1) * s + 2 - h, 0)
        pw = max((-(-w // s) - 1) * s + 2 - w, 0)
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), value=float("-inf"))
        return F.max_pool2d(x, 2, s)


class VGG16Features(nn.Module):
    """VGG16 to conv5_3 at stride 8: the first three pools stride 2, the
    fourth 1, the convs after it dilated 2."""

    def __init__(self):
        super().__init__()
        layers, cin, pools = [], 3, 0
        for v in VGG16_CFG:
            if v == "M":
                pools += 1
                layers.append(SamePool(2 if pools <= 3 else 1))
            else:
                d = 2 if pools >= 4 else 1
                layers += [nn.Conv2d(cin, v, 3, padding=d, dilation=d),
                           nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.features(x)


class PANet(nn.Module):
    """(reference: panet/__init__.py + panet/panet.py)."""

    def __init__(self, image_size: int = 417, custom_preprocess: bool = True):
        super().__init__()
        self.image_size = image_size
        self.custom_preprocess = custom_preprocess
        self.encoder = VGG16Features()

    def forward(self, batch: dict, generator=None) -> dict:
        images = channels_first_images(batch, self.image_size,
                                       self.custom_preprocess)
        b, n = images.shape[:2]
        feats = self.encoder(images.reshape((b * n,) + images.shape[2:]))
        d, fh, fw = feats.shape[1:]
        feats = feats.reshape(b, n, d, fh, fw)
        prompt = batch[BatchKeys.PROMPT_MASKS].float()     # (B, M, C, Hm, Wm)
        c = prompt.shape[2]
        masks = resize_nearest(prompt, (fh, fw))
        m = masks.shape[1]
        query, support = feats[:, 0], feats[:, 1:m + 1]

        # masked average pooling: class prototypes, the background the
        # complement of every class
        fg = torch.einsum("bmdhw,bmchw->bcd", support, masks)
        fg_proto = fg / masks.sum(dim=(1, 3, 4)).clamp(min=1e-5)[..., None]
        bg_mask = 1.0 - masks[:, :, 1:].max(dim=2).values  # (B, M, h, w)
        bg = torch.einsum("bmdhw,bmhw->bd", support, bg_mask)
        bg_proto = bg / bg_mask.sum(dim=(1, 2, 3)).clamp(min=1e-5)[:, None]
        protos = torch.cat([bg_proto[:, None], fg_proto[:, 1:]], dim=1)

        qn = query / torch.linalg.vector_norm(
            query, dim=1, keepdim=True).clamp(min=1e-8)
        pn = protos / torch.linalg.vector_norm(
            protos, dim=-1, keepdim=True).clamp(min=1e-8)
        seg = torch.einsum("bdhw,bcd->bchw", qn, pn) * 20.0
        seg = resize_bilinear(seg, (self.image_size, self.image_size))
        return {ResultDict.LOGITS: mask_unflagged(seg, batch)}


def build_panet(image_size: int = 417, custom_preprocess: bool = True,
                **kwargs) -> PANet:
    """As the JAX builder, other arguments are taken and unused."""
    return PANet(image_size=image_size, custom_preprocess=custom_preprocess)
