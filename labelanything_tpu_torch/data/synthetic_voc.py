"""A synthetic PASCAL VOC root on disk, made from a seed, beside
``synthetic_coco.py``: the split lists ``ImageSets/Segmentation/{train,val}.txt``,
palette class masks ``SegmentationClass/<name>.png`` of VOC's sizes with
VOC's 20 classes (1 to 3 a mask, each object ringed by the 255 "void"
border VOC draws), written by ``data/png.py``, and one random embedding
cache an image (``<emb_dir>/<name>.safetensors`` holding ``embedding``,
(C, h, w)), or ``JPEGImages/<name>.jpg`` copied from given JPEG files
(the masks then take each file's size), or both. The episode engine reads
it as it reads a real VOC root's masks, caches and images.
"""

from __future__ import annotations

import pathlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..utils.safetensors import save_file
from .png import voc_palette, write_png
from .synthetic_coco import copy_images

# (height, width) of common VOC 2012 images
VOC_SIZES = ((375, 500), (500, 375), (333, 500), (500, 333), (366, 500),
             (281, 500))
VOC_NUM_CLASSES = 20
VOID = 255
BORDER = 2      # the void ring's width in pixels


def _object(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A filled ellipse of random centre, axes and angle, at least some
    3000 pixels (above the 2 x 32 x 32 that ``remove_small_annotations``
    drops)."""
    cy, cx = rng.uniform(0.2 * h, 0.8 * h), rng.uniform(0.2 * w, 0.8 * w)
    ry = rng.uniform(0.12, 0.35) * h
    rx = rng.uniform(0.12, 0.35) * w
    t = rng.uniform(0, np.pi)
    y, x = np.mgrid[:h, :w]
    dy, dx = y - cy, x - cx
    u = (dx * np.cos(t) + dy * np.sin(t)) / rx
    v = (-dx * np.sin(t) + dy * np.cos(t)) / ry
    return u * u + v * v <= 1.0


def _ring(mask: np.ndarray, width: int) -> np.ndarray:
    """The pixels within ``width`` (chessboard distance) of ``mask``,
    outside it."""
    grown = mask.copy()
    h, w = mask.shape
    span = lambda d, n: (slice(max(0, -d), n - max(0, d)),
                         slice(max(0, d), n - max(0, -d)))
    for dy in range(-width, width + 1):
        for dx in range(-width, width + 1):
            (ys, yd), (xs, xd) = span(dy, h), span(dx, w)
            grown[yd, xd] |= mask[ys, xs]
    return grown & ~mask


def write_synthetic_voc(root: str, seed: int = 0, num_images: int = 200,
                        embed_dim: int = 768, grid: int = 30,
                        sizes: Sequence[Tuple[int, int]] = VOC_SIZES,
                        classes_per_image: Tuple[int, int] = (1, 3),
                        val_share: float = 0.3,
                        image_sources: Optional[Sequence[str]] = None,
                        embeddings: bool = True) -> Dict[str, str]:
    """Write the VOC root under ``root``; returns ``data_dir`` (the root)
    and ``emb_dir`` (no caches when ``embeddings`` is False); with
    ``image_sources`` (JPEG files) also ``JPEGImages``, one copy a name. Each mask draws ``classes_per_image`` (inclusive)
    classes dealt from a shuffled deck of VOC's 20, so that every class
    shows in about as many images as any other, one ellipse a class, later
    ones over earlier ones. A ``val_share`` of the names go to ``val.txt``,
    the rest to ``train.txt``. The masks take no row filter, libpng's
    choice for a palette image."""
    rng = np.random.default_rng(seed)
    root_p = pathlib.Path(root)
    masks_dir = root_p / "SegmentationClass"
    sets_dir = root_p / "ImageSets" / "Segmentation"
    emb_dir = root_p / "embeddings"
    for d in (masks_dir, sets_dir) + ((emb_dir,) if embeddings else ()):
        d.mkdir(parents=True, exist_ok=True)
    palette = voc_palette()
    deck: list = []
    splits: Dict[str, list] = {"train": [], "val": []}
    names = [f"{2007 + i % 6}_{i:06d}" for i in range(num_images)]
    files = (copy_images(root_p / "JPEGImages", rng, names, image_sources)
             if image_sources else None)
    for name in names:
        if files is None:
            h, w = sizes[int(rng.integers(len(sizes)))]
        else:
            _, h, w = files[name]
        lo, hi = classes_per_image
        n = int(rng.integers(lo, hi + 1))
        classes: list = []
        while len(classes) < n:
            if not deck:
                deck = [int(c) for c in rng.permutation(VOC_NUM_CLASSES) + 1]
            c = deck.pop()
            if c not in classes:
                classes.append(c)
        seg = np.zeros((h, w), np.uint8)
        void = np.zeros((h, w), bool)
        for c in classes:
            obj = _object(rng, h, w)
            seg[obj] = c
            void &= ~obj
            void |= _ring(obj, BORDER)
        seg[void & (seg == 0)] = VOID
        write_png(str(masks_dir / f"{name}.png"), seg, palette)
        if embeddings:
            emb = rng.standard_normal((embed_dim, grid, grid), np.float32)
            save_file({"embedding": emb},
                      str(emb_dir / f"{name}.safetensors"))
        splits["val" if rng.random() < val_share else "train"].append(name)
    for split, names in splits.items():
        (sets_dir / f"{split}.txt").write_text(
            "".join(f"{n}\n" for n in names))
    out = {"data_dir": str(root_p)}
    if embeddings:
        out["emb_dir"] = str(emb_dir)
    return out
