"""PPNet few-shot baseline, Part-aware Prototype Network (ECCV 2020)
(counterpart of ``labelanything_tpu/models/ppnet.py``; reference:
label_anything/models/ppnet/).

The module names are the reference's state-dict names (``encoder.layer1.0
.conv1``, ``encoder.layer1.0.downsample.0``, ...), so a reference-layout
state dict loads with ``load_state_dict(strict=True)`` once the training
head's ``aspp.*`` keys, which the eval path never runs, are dropped
(``utils/weights.reference_baseline_state_dict``). Tensors are NCHW inside;
the batch's channels-last images are transposed once, at the wrapper.

As in the JAX package: k-means runs over the full fixed-size point grid
with a 0/1 weight a point (empty clusters keep their centre, and get a
zero centre in the last assignment); the global prototypes are masked
means of the align-corners upsampled features, taken at feature
resolution through the interpolation's adjoint; the reference's
``<= 10`` masked pixels fallback is not reproduced.

Shared with ``denet.py``, ``bam.py`` and ``hdmnet.py``: :class:`BN` (eval
BatchNorm on running statistics, whatever the module's mode),
:class:`SameConv2d` (flax's ``padding="SAME"``, which pads the high side
only where the total is odd) and :class:`Bottleneck`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.image_norm import maybe_normalize_images
from ..ops.resize import resize_bilinear_ac, resize_nearest_torch
from ..typing import BatchKeys, ResultDict

NEG_INF = float("-inf")
GLOBAL_CONST = 0.5  # reference: FewShotSegPartResnetSem.py:38


class BN(nn.BatchNorm2d):
    """BatchNorm over its running statistics in every mode (the baselines
    are eval-only: batch statistics are never taken), eps 1e-5."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def same_pads(size: int, kernel: int, stride: int, dilation: int = 1
              ) -> Tuple[int, int]:
    """(low, high) padding of flax's ``"SAME"`` along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax's ``padding="SAME"``: symmetric padding goes
    to the convolution, an odd total is padded high first (a stride-2 3 x 3
    on an even size, a kernel-4 stride-4 on a size it does not divide)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kh, kw), (sh, sw), (dh, dw) = (self.kernel_size, self.stride,
                                        self.dilation)
        ph = same_pads(x.shape[-2], kh, sh, dh)
        pw = same_pads(x.shape[-1], kw, sw, dw)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, self.weight, self.bias, self.stride,
                            (ph[0], pw[0]), self.dilation, self.groups)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0,
                        self.dilation, self.groups)


def conv1x1(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1, bias=False)


class Bottleneck(nn.Module):
    """(reference: ResNetBackbone.py:66-108). ``last_relu=False`` leaves the
    block's output before its ReLU; the 3 x 3 pads by its dilation."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False,
                 last_relu: bool = True):
        super().__init__()
        out = planes * 4
        self.conv1 = conv1x1(cin, planes)
        self.bn1 = BN(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = BN(planes)
        self.conv3 = conv1x1(planes, out)
        self.bn3 = BN(out)
        self.downsample = (nn.Sequential(
            nn.Conv2d(cin, out, 1, stride, bias=False), BN(out))
            if has_downsample else None)
        self.last_relu = last_relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample is not None:
            x = self.downsample(x)
        y = y + x
        return F.relu(y) if self.last_relu else y


class ResNetSem(nn.Module):
    """Output-stride-8 dilated ResNet (reference: ResNetBackbone.py:203-268):
    layers 3 and 4 trade their stride for dilation 2 and 4 (the first block
    of each keeps the previous dilation, 1 and 2); with ``quirk_last_relu``
    the last block of layer4 skips its ReLU (only where layer4 has more
    than one block, as the reference's flag reaches blocks 1 on). Layers
    past ``out_layer`` are not built. ``dilated=False`` is torchvision's
    ResNet with its strides 8, 16, 32 (the pyramid backbone,
    ``models/pyramid_encoders.py``), whose stage maps :meth:`stages`
    returns."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 out_layer: str = "layer4", quirk_last_relu: bool = True,
                 dilated: bool = True):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = BN(64)
        # (planes, first stride, dilations of the first block and the rest)
        if dilated:
            stages = [(64, 1, (1, 1)), (128, 2, (1, 1)), (256, 1, (1, 2)),
                      (512, 1, (2, 4))]
        else:
            stages = [(64, 1, (1, 1)), (128, 2, (1, 1)), (256, 2, (1, 1)),
                      (512, 2, (1, 1))]
        cin = 64
        self.stage_names = []
        for si, (planes, stride, (dil0, dil)) in enumerate(stages):
            name = f"layer{si + 1}"
            n = layers[si]
            blocks = []
            for bi in range(n):
                last = (quirk_last_relu and name == "layer4"
                        and bi == n - 1 and bi > 0)
                blocks.append(Bottleneck(
                    cin, planes, stride if bi == 0 else 1,
                    dil0 if bi == 0 else dil, bi == 0, not last))
                cin = planes * 4
            setattr(self, name, nn.Sequential(*blocks))
            self.stage_names.append(name)
            if name == out_layer:
                break

    def stages(self, x: torch.Tensor) -> dict:
        """NCHW images -> every built layer's map, by name."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        out = {}
        for name in self.stage_names:
            x = out[name] = getattr(self, name)(x)
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.stages(x)[self.stage_names[-1]]


# ------------------------------------------------------------------ #
# masked k-means and prototypes
# ------------------------------------------------------------------ #

def kmeans_first_valid_init(points: torch.Tensor, weights: torch.Tensor,
                            k: int) -> torch.Tensor:
    """The first ``k`` valid points in order, then (where fewer are valid)
    the first invalid ones: ``lax.top_k``'s order, whose ties go to the
    lower index. points (G, N, C), weights (G, N) -> (G, k, C)."""
    n = points.shape[1]
    idx = torch.arange(n, device=points.device)
    key = torch.where(weights > 0, idx, idx + n)
    pick = key.argsort(dim=1)[:, :k]
    return points.gather(1, pick[..., None].expand(-1, -1, points.shape[2]))


def masked_kmeans(points: torch.Tensor, weights: torch.Tensor,
                  init: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Weighted-point k-means (reference: ppnet/kmeans.py:37-67): ``iters -
    1`` rounds in which an empty cluster keeps its centre, then a last
    assignment in which it gets a zero centre. points (G, N, C), weights
    (G, N) in {0, 1}, init (G, k, C)."""
    k = init.shape[1]

    def assign(centers):
        d2 = ((points[:, :, None, :] - centers[:, None]) ** 2).sum(-1)
        member = F.one_hot(d2.argmin(dim=2), k).to(points.dtype)
        member = member * weights[..., None]
        return torch.einsum("gnk,gnc->gkc", member, points), member.sum(1)

    centers = init
    for _ in range(iters - 1):
        sums, counts = assign(centers)
        new = sums / counts.clamp(min=1.0)[..., None]
        centers = torch.where(counts[..., None] > 0, new, centers)
    sums, counts = assign(centers)
    new = sums / counts.clamp(min=1.0)[..., None]
    return torch.where(counts[..., None] > 0, new, torch.zeros_like(new))


def _interp_matrix_ac(n_in: int, n_out: int) -> np.ndarray:
    """Row-stochastic 1-D bilinear align-corners matrix (n_out, n_in)."""
    m = np.zeros((n_out, n_in), np.float32)
    if n_out == 1 or n_in == 1:
        m[:, 0] = 1.0
        return m
    pos = np.linspace(0.0, n_in - 1.0, n_out)
    lo = np.clip(np.floor(pos).astype(int), 0, n_in - 1)
    hi = np.clip(lo + 1, 0, n_in - 1)
    w = pos - lo
    m[np.arange(n_out), lo] += 1 - w
    m[np.arange(n_out), hi] += w
    return m


def masked_mean_upsampled(fts: torch.Tensor, mask: torch.Tensor
                          ) -> torch.Tensor:
    """Masked mean of the align-corners upsampling of ``fts`` (N, C, h, w)
    to ``mask``'s (N, H, W) size, taken at feature resolution: the mask is
    brought down by the interpolation's adjoint. Returns (N, C)."""
    (h1, w1), (hh, ww) = fts.shape[-2:], mask.shape[-2:]
    a_h = torch.from_numpy(_interp_matrix_ac(h1, hh)).to(fts.device)
    a_w = torch.from_numpy(_interp_matrix_ac(w1, ww)).to(fts.device)
    down = torch.einsum("nHW,Hh,Ww->nhw", mask, a_h, a_w)
    num = torch.einsum("nchw,nhw->nc", fts, down)
    return num / (mask.sum(dim=(1, 2))[:, None] + 1e-5)


def cal_dist(fts: torch.Tensor, prototypes: torch.Tensor) -> torch.Tensor:
    """Max-over-centres cosine similarity, times 20 (reference:
    FewShotSegPartResnetSem.py:115-131). fts (B, C, h, w); prototypes
    (B, P, k, C) -> (B, P, h, w)."""
    eps = 1e-8
    fn = fts / torch.linalg.vector_norm(fts, dim=1,
                                        keepdim=True).clamp(min=eps)
    pn = prototypes / torch.linalg.vector_norm(
        prototypes, dim=-1, keepdim=True).clamp(min=eps)
    sim = torch.einsum("bchw,bpkc->bpkhw", fn, pn)
    return sim.max(dim=2).values * 20.0


class PPNet(nn.Module):
    """Eval-path PPNet (reference: FewShotSegPartResnetSem.py:24-113).

    ``forward(supp_imgs, fore_mask, back_mask, qry_img)``: supports (B, Wa,
    Sh, 3, H, W), masks (B, Wa, Sh, H, W), query (B, 3, H, W); returns the
    logits (B, 1 + Wa, H, W). Every episode of the batch and every way goes
    through one batched k-means."""

    def __init__(self, num_centers: int = 5, kmeans_iters: int = 10,
                 resnet_layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.num_centers = num_centers
        self.kmeans_iters = kmeans_iters
        self.encoder = ResNetSem(layers=resnet_layers)

    def forward(self, supp_imgs: torch.Tensor, fore_mask: torch.Tensor,
                back_mask: torch.Tensor, qry_img: torch.Tensor
                ) -> torch.Tensor:
        b, wa, sh, _, hh, ww = supp_imgs.shape
        n_sup = b * wa * sh
        fts = self.encoder(torch.cat(
            [supp_imgs.reshape(n_sup, 3, hh, ww), qry_img], dim=0))
        c, h1, w1 = fts.shape[1:]
        flat_f, qry_f = fts[:n_sup], fts[n_sup:]            # (B Wa Sh, C, h, w)

        fg = fore_mask.reshape(n_sup, hh, ww)
        bg = back_mask.reshape(n_sup, hh, ww)
        fg_glo = masked_mean_upsampled(flat_f, fg).reshape(b, wa, sh, c)
        bg_glo = masked_mean_upsampled(flat_f, bg).reshape(b, wa, sh, c)
        fg_glo = fg_glo.mean(dim=2)                          # (B, Wa, C)
        bg_glo = bg_glo.mean(dim=2).mean(dim=1)              # (B, C)

        # foreground points on the 2x grid, background on the feature grid
        # (reference upscale 2 / 1, FewShotSegPartResnetSem.py:91-92)
        fts_s4 = resize_bilinear_ac(flat_f, (2 * h1, 2 * w1))
        m_fg = resize_nearest_torch(fg, (2 * h1, 2 * w1))
        m_bg = resize_nearest_torch(bg, (h1, w1))
        pts = fts_s4.reshape(b * wa, sh, c, -1).permute(0, 1, 3, 2)
        pts = pts.reshape(b * wa, -1, c)                     # (B Wa, Sh n4, C)
        wf = m_fg.reshape(b * wa, -1)
        k = self.num_centers
        fg_cls = masked_kmeans(pts, wf, kmeans_first_valid_init(pts, wf, k),
                               self.kmeans_iters).reshape(b, wa, k, c)
        p_all = flat_f.reshape(b, wa * sh, c, -1).permute(0, 1, 3, 2)
        p_all = p_all.reshape(b, -1, c)                      # (B, Wa Sh n1, C)
        w_all = m_bg.reshape(b, -1)
        bg_cls = masked_kmeans(p_all, w_all,
                               kmeans_first_valid_init(p_all, w_all, k),
                               self.kmeans_iters)            # (B, k, C)

        fg_protos = fg_cls + GLOBAL_CONST * fg_glo[:, :, None]
        bg_protos = bg_cls + GLOBAL_CONST * bg_glo[:, None]
        protos = torch.cat([bg_protos[:, None], fg_protos], dim=1)
        pred = cal_dist(qry_f, protos)                       # (B, 1+Wa, h, w)
        return resize_bilinear_ac(pred, (hh, ww))


def channels_first_images(batch: dict, long_side: int,
                          custom_preprocess: bool) -> torch.Tensor:
    """The batch's images (B, N, S, S, 3), normalized on the device when
    they are uint8, as (B, N, 3, S, S)."""
    images = maybe_normalize_images(
        batch[BatchKeys.IMAGES], batch[BatchKeys.DIMS], long_side,
        custom_preprocess, batch.get(BatchKeys.RESIZED_DIMS))
    return images.permute(0, 1, 4, 2, 3)


def example_masks(batch: dict, n_imgs: int) -> torch.Tensor:
    """The examples' prompt masks (B, M, C, Hm, Wm) in fp32: the query's row
    is dropped where the batch still has it."""
    masks = batch[BatchKeys.PROMPT_MASKS]
    if masks.shape[1] == n_imgs:
        masks = masks[:, 1:]
    return masks.float()


def mask_unflagged(logits: torch.Tensor, batch: dict) -> torch.Tensor:
    """-inf for the classes that ``FLAG_GTS`` leaves out, where it is
    given."""
    flags = batch.get(BatchKeys.FLAG_GTS)
    if flags is None:
        return logits
    return torch.where(flags.bool()[:, :, None, None], logits,
                       torch.full_like(logits, NEG_INF))


class PPNetMultiClass(nn.Module):
    """LAM-batch adapter (reference: ppnet/__init__.py:18-122): the prompt
    masks' argmax labels each support pixel; per way, foreground is that
    class and background no class; the (1 + Wa)-way logits come out
    directly. Examples are way-major "(k c)": example ``e`` is shot
    ``e // (C - 1)`` of way ``e % (C - 1) + 1``."""

    def __init__(self, image_size: int = 417, num_centers: int = 5,
                 resnet_layers: Sequence[int] = (3, 4, 6, 3),
                 custom_preprocess: bool = True):
        super().__init__()
        self.image_size = image_size
        self.custom_preprocess = custom_preprocess
        self.ppnet = PPNet(num_centers, resnet_layers=resnet_layers)

    def forward(self, batch: dict, generator=None) -> dict:
        images = channels_first_images(batch, self.image_size,
                                       self.custom_preprocess)
        b, n_imgs, _, hh, ww = images.shape
        assert b == 1, "PPNet supports batch size 1 (reference assertion)"
        qry, sup = images[:, 0], images[:, 1:]
        masks = example_masks(batch, n_imgs)
        m, c = masks.shape[1:3]
        c_fg = c - 1
        k = m // c_fg
        labels = resize_nearest_torch(masks.argmax(dim=2), (hh, ww))
        labels = labels.reshape(b, k, c_fg, hh, ww).transpose(1, 2)
        sup = sup.reshape(b, k, c_fg, 3, hh, ww).transpose(1, 2)
        ways = torch.arange(1, c_fg + 1, device=labels.device)
        fore = (labels == ways[None, :, None, None, None]).float()
        back = (labels == 0).float()
        logits = self.ppnet(sup, fore, back, qry)
        return {ResultDict.LOGITS: mask_unflagged(logits, batch)}


def build_ppnet(fold: int = 0, image_size: int = 417,
                custom_preprocess: bool = True, **kwargs) -> PPNetMultiClass:
    """(reference: ppnet/__init__.py:125-143). ``custom_preprocess`` only
    tells the device normalization of uint8 images where the pad lies."""
    return PPNetMultiClass(image_size=image_size,
                           custom_preprocess=custom_preprocess, **kwargs)
