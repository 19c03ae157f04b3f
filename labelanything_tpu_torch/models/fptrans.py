"""FPTrans few-shot baseline, Feature-Proxy Transformer (NeurIPS 2022)
(counterpart of ``labelanything_tpu/models/fptrans.py``; reference:
label_anything/models/fptrans/FPTrans.py, fptrans/vit.py).

* ``FPTransViT``: a timm ViT (fused-qkv attention, LayerNorm eps 1e-6,
  Swin's MLP with exact GELU) with FPTrans's prompt tokens: rows of a learned prompt bank
  added to class-aware foreground / background tokens, appended to every
  image's tokens and averaged across the S + 1 images of an episode after
  every block.
* ``FPTrans``: the frozen ``original_encoder`` makes the class-aware tokens
  from the support masks; the prompted ``encoder.backbone`` takes them; a
  ``Purifier`` upsamples the features; each query pixel's cosine
  similarity to the foreground prototype and to ``bg_num`` background
  prototypes a shot, found by farthest-point sampling (FPS), gives the
  logits.
* ``FPTransMultiClass``: one binary pass a class, merged by the BinaryLam
  rule, as the JAX package completes the reference's unfinished adapter.

FPS runs over the whole pixel grid with the invalid pixels masked, as in
the JAX package. Its first centre is, with ``fps_first="random"``, the
draw of ``jax.random.categorical(jax.random.key(1289), ...)`` over the
valid pixels, reproduced bit for bit by ``ops/jax_random.py`` (the
reference draws from ``np.random.RandomState(1289)``: ROADMAP C), and with
``"first_valid"`` the first valid pixel. Module names are the reference's
(``encoder.backbone``, ``original_encoder``, ``purifier.layers.{0,3,6}``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.image_norm import maybe_normalize_images
from ..ops.jax_random import categorical_valid
from ..ops.resize import resize_bilinear_ac, resize_nearest_torch
from ..typing import BatchKeys, ResultDict
from .ppnet import mask_unflagged
from .swin import Mlp

# the key of the JAX package's seed-point draw
FPS_SEED = 1289


class TimmAttention(nn.Module):
    """Fused-qkv attention (reference: fptrans/vit.py:180-205), through
    ``ops.attention.dot_product_attention`` and its routing rule."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads,
                                  self.dim // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        out = dot_product_attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(b, n, self.dim))


class TimmBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = TimmAttention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


def group_mean_sync(x: torch.Tensor, group: int, start: int, end: int
                    ) -> torch.Tensor:
    """The first ``start`` and last ``end`` tokens averaged over each group
    of ``group`` consecutive batch rows, the mean put back in every row
    (reference: vit.py:440-447 reduce_and_expand)."""
    bg, n, c = x.shape
    xg = x.reshape(bg // group, group, n, c)
    head = xg[:, :, :start].mean(dim=1, keepdim=True).expand(-1, group, -1, -1)
    tail = xg[:, :, n - end:].mean(dim=1, keepdim=True).expand(-1, group, -1,
                                                               -1)
    return torch.cat([head, xg[:, :, start:n - end], tail],
                     dim=2).reshape(bg, n, c)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, N, C)."""
        return self.proj(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)


class FPTransViT(nn.Module):
    """ViT-B/16 with FPTrans's prompt tokens (reference: fptrans/vit.py:
    230-460). ``original=True`` is the frozen token extractor (the plain
    ViT, returning the feature map); otherwise ``forward`` takes the
    foreground / background tokens and the prompt bank's rows and returns
    (feature map, foreground token, background tokens)."""

    def __init__(self, img_size: int = 480, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 10, num_heads: int = 12,
                 mlp_ratio: float = 4.0, original: bool = False,
                 bank_size: int = 360, prompt_group: int = 12,
                 bg_num: int = 5):
        super().__init__()
        self.grid = img_size // patch_size
        self.embed_dim, self.original = embed_dim, original
        self.bank_size, self.prompt_group, self.bg_num = (
            bank_size, prompt_group, bg_num)
        if not original:
            self.prompt_tokens = nn.Parameter(
                torch.zeros(bank_size, prompt_group, embed_dim))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, self.grid ** 2 + 1, embed_dim))
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.blocks = nn.ModuleList([TimmBlock(embed_dim, num_heads, mlp_ratio)
                                     for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def _features(self, seq: torch.Tensor) -> torch.Tensor:
        seq = self.norm(seq)
        return seq[:, 1:].reshape(seq.shape[0], self.grid, self.grid,
                                  self.embed_dim)

    def forward(self, x: torch.Tensor,
                tokens: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                shot: int = 1, prompt_idx: Optional[torch.Tensor] = None):
        """x (B', H, W, 3) channels-last; with prompts B' = B (shot + 1),
        each episode's images consecutive."""
        patches = self.patch_embed(x)
        bsz, n_patches, c = patches.shape
        seq = torch.cat([self.cls_token.expand(bsz, 1, c), patches],
                        dim=1) + self.pos_embed
        if self.original:
            for block in self.blocks:
                seq = block(seq)
            return self._features(seq)

        # the prompted forward (reference: vit.py:365-438)
        fg_in, bg_in = tokens                       # (B, 1, C), (B, k, C)
        g = self.prompt_group
        divider = 1 + self.bg_num * shot
        b = bsz // (shot + 1)
        if prompt_idx is None:
            prompt_idx = torch.arange(b * divider,
                                      device=x.device) % self.bank_size
        prompts = self.prompt_tokens[prompt_idx].reshape(b, divider * g, c)
        fg_tok = prompts[:, :g] + fg_in
        bg_tok = prompts[:, g:] + bg_in.repeat_interleave(g, dim=1)
        n1, n2 = fg_tok.shape[1], bg_tok.shape[1]
        # every image of an episode sees the same prompt tokens
        seq = torch.cat([seq, fg_tok.repeat_interleave(shot + 1, dim=0),
                         bg_tok.repeat_interleave(shot + 1, dim=0)], dim=1)
        for block in self.blocks:
            seq = group_mean_sync(block(seq), shot + 1, 1, n1 + n2)
        # the tokens are equal across an episode after the last sync
        fg_out = seq[:, n_patches + 1:n_patches + 1 + n1].reshape(
            b, shot + 1, n1, c)[:, 0]
        bg_out = seq[:, n_patches + 1 + n1:].reshape(b, shot + 1, n2, c)[:, 0]
        feat = self._features(seq[:, :n_patches + 1])
        # a proxy's token: the mean over its G rows (reference: vit.py:
        # 431-438)
        return (feat, fg_out.mean(dim=1),
                bg_out.reshape(b * self.bg_num, n2 // self.bg_num, c).mean(1))


class Purifier(nn.Module):
    """Residual 2x upsampler (reference: FPTrans.py:18-29, 75-85), on
    channels-last features."""

    def __init__(self, embed_dim: int, drop_rate: float = 0.1):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Conv2d(embed_dim, 256, 1), nn.ReLU(), nn.Dropout(drop_rate),
            nn.ConvTranspose2d(256, 256, 2, 2), nn.ReLU(),
            nn.Dropout(drop_rate), nn.Conv2d(256, embed_dim, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        up = resize_bilinear_ac(x, (x.shape[2] * 2, x.shape[3] * 2))
        return (up + self.layers(x)).permute(0, 2, 3, 1)


# ---- prototypes and similarity -------------------------------------------- #

def fps_prototypes(feat: torch.Tensor, valid: torch.Tensor,
                   first_idx: torch.Tensor, bg_num: int, width: int
                   ) -> torch.Tensor:
    """Masked farthest-point-sampling prototypes of K slices at once
    (reference: FPTrans.py:204-262; the JAX ``_fps_prototypes_single``):
    feat (K, n, c) over a row-major grid ``width`` wide, valid (K, n)
    bool, first_idx (K,) the first centre. Where a slice has fewer valid
    pixels than prototypes, its first ``bg_num`` pixels are made valid.
    -> (K, bg_num, c)."""
    k, n, _ = feat.shape
    dev = feat.device
    pixel = torch.arange(n, device=dev)
    few = valid.sum(dim=-1, keepdim=True) < bg_num
    valid = torch.where(few, valid | (pixel < bg_num), valid)
    coords = torch.stack([pixel // width, pixel % width], dim=1).float()
    centers = torch.zeros(k, bg_num, 2, device=dev)
    centers[:, 0] = coords[first_idx]
    slots = torch.arange(bg_num, device=dev)

    def sq_dist(centers):                       # (K, n, bg_num)
        return ((coords[None, :, None, :] - centers[:, None]) ** 2).sum(-1)

    for j in range(1, bg_num):
        d2 = sq_dist(centers).masked_fill(slots >= j, float("inf"))
        min_d = d2.amin(dim=-1).masked_fill(~valid, -1.0)
        centers[:, j] = coords[min_d.argmax(dim=-1)]
    labels = sq_dist(centers).argmin(dim=-1)                    # (K, n)
    member = ((labels[..., None] == slots) & valid[..., None]).to(feat.dtype)
    sums = torch.einsum("knb,knc->kbc", member, feat)
    return sums / member.sum(dim=1).clamp(min=1.0)[..., None]


def compute_multiple_prototypes(bg_num: int, sup_fts: torch.Tensor,
                                sup_bg: torch.Tensor, first: str = "random"
                                ) -> torch.Tensor:
    """Background prototypes (B, c, S * bg_num), shot-major (reference:
    FPTrans.py:236-260). sup_fts (B, S, h, w, c), sup_bg (B, S, h, w)
    bool. ``first``: "random", the JAX package's draw over each slice's
    valid pixels, or "first_valid", the first valid pixel; a slice with no
    valid pixel starts at pixel 0."""
    b, s, h, w, c = sup_fts.shape
    valid = sup_bg.reshape(b * s, h * w)
    if first == "first_valid":
        first_idx = valid.int().argmax(dim=-1)
    elif first == "random":
        first_idx = categorical_valid(FPS_SEED, valid)
    else:
        raise ValueError(f"unknown FPS seed mode {first!r}")
    protos = fps_prototypes(sup_fts.reshape(b * s, h * w, c), valid,
                            first_idx, bg_num, w)
    return protos.reshape(b, s * bg_num, c).transpose(1, 2)


def _norm(x: torch.Tensor, dim: int, eps: float) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=dim).clamp(min=eps)


def compute_similarity(fg_proto: torch.Tensor, bg_proto: torch.Tensor,
                       qry_fts: torch.Tensor, dist_scalar: float = 20.0,
                       proto_valid: Optional[torch.Tensor] = None,
                       eps: float = 1e-8) -> torch.Tensor:
    """(reference: FPTrans.py:264-297) ``F.cosine_similarity`` (norms
    clamped at eps) times ``dist_scalar``. qry_fts (B, h, w, c); fg_proto
    (B, c); bg_proto (B, c, k); proto_valid (B, k) drops padded shots'
    prototypes from the background's maximum. -> (B, 2, h, w) [bg, fg]."""
    qn = _norm(qry_fts, -1, eps)                              # (B, h, w)
    fg_d = torch.einsum("bhwc,bc->bhw", qry_fts, fg_proto) / (
        qn * _norm(fg_proto, -1, eps)[:, None, None])
    bg_d = torch.einsum("bhwc,bck->bkhw", qry_fts, bg_proto) / (
        qn[:, None] * _norm(bg_proto, 1, eps)[:, :, None, None])
    if proto_valid is not None:
        bg_d = bg_d.masked_fill(proto_valid[:, :, None, None] <= 0,
                                float("-inf"))
    return torch.stack([bg_d.amax(dim=1), fg_d], dim=1) * dist_scalar


def pairwise_loss(x1: torch.Tensor, y1: torch.Tensor, x2: torch.Tensor,
                  y2: torch.Tensor, scale: float = 10.0) -> torch.Tensor:
    """Intra-episode contrastive pairwise loss (reference:
    fptrans/losses.py:61-96): x1 (B, S, C, N) support features, x2 (B, 1,
    C, N) query features, labels in {0, 1, 255}."""
    b, s, c, n = x1.shape
    x1 = x1 / torch.linalg.vector_norm(x1, dim=2, keepdim=True).clamp(
        min=1e-12)
    x2 = x2 / torch.linalg.vector_norm(x2, dim=2, keepdim=True).clamp(
        min=1e-12)
    x1 = x1.transpose(2, 3).reshape(b, s * n, c)
    y1 = y1.reshape(b, s * n, 1)
    x2 = x2.transpose(1, 2).reshape(b, c, n)
    y2 = y2.reshape(b, 1, n)
    logits = torch.bmm(x1, x2) * scale
    lab = (y1 == y2).float()
    keep = (~(((y1 + y2) >= 255) | ((y1 + y2) == 0))).float()
    bce = (logits.clamp(min=0) - logits * lab
           + torch.log1p(torch.exp(-logits.abs())))
    return (bce * keep).sum() / (keep.sum() + 1e-6)


# ---- the models ------------------------------------------------------------ #

class _Encoder(nn.Module):
    """The reference's ``nn.Sequential(OrderedDict(backbone=vit))``."""

    def __init__(self, backbone: FPTransViT):
        super().__init__()
        self.backbone = backbone


class FPTrans(nn.Module):
    """Binary few-shot segmenter (reference: FPTrans.py:31-202)."""

    def __init__(self, image_size: int = 480, embed_dim: int = 768,
                 depth: int = 10, num_heads: int = 12, bg_num: int = 5,
                 num_prompt: int = 72, ncls: int = 60, shot: int = 1,
                 drop_rate: float = 0.1, fps_first: str = "random"):
        super().__init__()
        self.bg_num, self.shot, self.fps_first = bg_num, shot, fps_first
        divider = 1 + bg_num * shot
        kw = dict(img_size=image_size, embed_dim=embed_dim, depth=depth,
                  num_heads=num_heads, bg_num=bg_num,
                  bank_size=ncls * divider,
                  prompt_group=num_prompt // divider)
        self.encoder = _Encoder(FPTransViT(original=False, **kw))
        self.original_encoder = FPTransViT(original=True, **kw)
        self.purifier = Purifier(embed_dim, drop_rate)

    def forward(self, query: torch.Tensor, s_x: torch.Tensor,
                s_y: torch.Tensor, shot_flags: Optional[torch.Tensor] = None,
                prompt_idx: Optional[torch.Tensor] = None,
                out_shape: Optional[Tuple[int, int]] = None
                ) -> Dict[str, torch.Tensor]:
        """query (B, H, W, 3), s_x (B, S, H, W, 3), s_y (B, S, H, W) in {0,
        1}, shot_flags (B, S) or None. -> {"out": (B, 2, H, W) logits,
        "tokens_fg", "tokens_bg"}."""
        b, s, hh, ww, _ = s_x.shape
        if s != self.shot:
            raise ValueError(f"{s} shots; the prompt bank is sized for "
                             f"{self.shot}")
        if shot_flags is None:
            shot_flags = torch.ones((b, s), device=s_x.device)
        flat_sup = s_x.reshape(b * s, hh, ww, 3)
        wts = shot_flags.float()[..., None]

        # class-aware tokens from the frozen encoder (FPTrans.py:118-135)
        with torch.no_grad():
            sup_feat = self.original_encoder(flat_sup)       # (BS, h0, w0, c)
            h0, w0, c = sup_feat.shape[1:]
            mask0 = resize_nearest_torch(s_y.reshape(b * s, hh, ww), (h0, w0))
            fg_m = (mask0 == 1).to(sup_feat.dtype)[..., None]
            fg_tok = (sup_feat * fg_m).sum(dim=(1, 2)) / (
                fg_m.sum(dim=(1, 2)) + 1e-6)
            fg_tok = (fg_tok.reshape(b, s, c) * wts).sum(
                dim=1, keepdim=True) / wts.sum(dim=1, keepdim=True).clamp(
                    min=1e-6)                                # (B, 1, c)
            bg_tok = compute_multiple_prototypes(
                self.bg_num, sup_feat.reshape(b, s, h0, w0, c),
                mask0.reshape(b, s, h0, w0) == 0,
                self.fps_first).transpose(1, 2)              # (B, k, c)

        # the prompted encoder over [supports..., query] (FPTrans.py:116,137)
        img_cat = torch.cat([s_x, query[:, None]], dim=1).reshape(
            b * (s + 1), hh, ww, 3)
        feat, fg_out, bg_out = self.encoder.backbone(
            img_cat, tokens=(fg_tok, bg_tok), shot=s, prompt_idx=prompt_idx)
        features = self.purifier(feat)
        h, w = features.shape[1:3]
        features = features.reshape(b, s + 1, h, w, c)
        sup_mask = resize_nearest_torch(s_y.reshape(b * s, hh, ww), (h, w))
        pred = self._classify(features[:, :s], features[:, s],
                              sup_mask.reshape(b, s, h, w), wts)
        out = resize_bilinear_ac(pred, out_shape or (hh, ww))
        return {"out": out, "tokens_fg": fg_out, "tokens_bg": bg_out}

    def _classify(self, sup_fts, qry_fts, sup_mask, wts):
        """(reference: FPTrans.py:172-202)."""
        b, s, h, w, c = sup_fts.shape
        fg_m = (sup_mask == 1).reshape(b, s, h * w, 1).to(sup_fts.dtype)
        fg_vecs = (sup_fts.reshape(b, s, h * w, c) * fg_m).sum(dim=2) / (
            fg_m.sum(dim=2) + 1e-5)                          # (B, S, c)
        fg_proto = (fg_vecs * wts).sum(dim=1) / wts.sum(dim=1).clamp(
            min=1e-6)
        bg_proto = compute_multiple_prototypes(self.bg_num, sup_fts,
                                               sup_mask == 0, self.fps_first)
        proto_valid = wts[..., 0].repeat_interleave(self.bg_num, dim=1)
        return compute_similarity(fg_proto, bg_proto, qry_fts,
                                  proto_valid=proto_valid)


class FPTransMultiClass(nn.Module):
    """LAM-batch adapter: one binary FPTrans pass a foreground class (its
    mask prompts nearest-resized to the images), merged by the BinaryLam
    rule, -inf on the classes that ``FLAG_GTS`` leaves out."""

    def __init__(self, image_size: int = 480, embed_dim: int = 768,
                 depth: int = 10, num_heads: int = 12, bg_num: int = 5,
                 num_prompt: int = 72, ncls: int = 60, shot: int = 1,
                 fps_first: str = "random", custom_preprocess: bool = True):
        super().__init__()
        self.image_size = image_size
        self.custom_preprocess = custom_preprocess
        self.fptrans = FPTrans(image_size=image_size, embed_dim=embed_dim,
                               depth=depth, num_heads=num_heads,
                               bg_num=bg_num, num_prompt=num_prompt,
                               ncls=ncls, shot=shot, fps_first=fps_first)

    def forward(self, batch: dict, generator=None) -> dict:
        images = maybe_normalize_images(
            batch[BatchKeys.IMAGES], batch[BatchKeys.DIMS], self.image_size,
            self.custom_preprocess, batch.get(BatchKeys.RESIZED_DIMS))
        b, n, hh, ww, _ = images.shape
        query, s_x = images[:, 0], images[:, 1:]
        masks = batch[BatchKeys.PROMPT_MASKS].float()        # (B, M, C, h, w)
        flag = batch[BatchKeys.FLAG_EXAMPLES].float()
        if masks.shape[1] == n:                # a full batch
            masks, flag = masks[:, 1:], flag[:, 1:]
        if masks.shape[1] != n - 1:
            raise ValueError("prompt masks misaligned with support images")
        per_class = [self.fptrans(
            query, s_x, resize_nearest_torch(masks[:, :, ci], (hh, ww)),
            shot_flags=flag[:, :, ci])["out"]
            for ci in range(1, masks.shape[2])]
        logits = torch.stack(per_class, dim=1)               # (B, C-1, 2, H, W)
        fg, bgs = logits[:, :, 1], logits[:, :, 0]
        bg = bgs.gather(1, fg.argmax(dim=1, keepdim=True))
        return {ResultDict.LOGITS: mask_unflagged(torch.cat([bg, fg], dim=1),
                                                  batch)}


def build_fptrans(dataset: str = "COCO", image_size: int = 480,
                  vit_depth: int = 10, shot: int = 1,
                  fps_first: str = "random", custom_preprocess: bool = True,
                  embed_dim: int = 768, num_heads: int = 12, bg_num: int = 5,
                  num_prompt: int = 72) -> FPTransMultiClass:
    """(reference: fptrans/__init__.py:33-62). ``dataset`` picks the prompt
    bank's classes (PASCAL 15, else 60); ``shot`` sizes it. An argument it
    does not know raises."""
    return FPTransMultiClass(image_size=image_size, depth=vit_depth,
                             ncls=15 if dataset.upper() == "PASCAL" else 60,
                             shot=shot, fps_first=fps_first,
                             custom_preprocess=custom_preprocess,
                             embed_dim=embed_dim, num_heads=num_heads,
                             bg_num=bg_num, num_prompt=num_prompt)
