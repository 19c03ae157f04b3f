"""A synthetic COCO root on disk, made from a seed: an instances JSON with
COCO's 80 category ids and images of COCO's sizes, each with polygon
annotations, and one embedding cache per image in the layout ``preprocess``
writes (``{id:012d}.safetensors`` holding ``embedding``, (C, h, w)), or an
image folder, or both. The episode engine reads it as it reads a real COCO
root's annotations, caches and images; the embeddings are random.

The image folder is made without a JPEG encoder (the card's machine has
none): each image is a copy of one of the given JPEG files, and every
fourth an RGB PNG of a seeded scene written by ``data/png.py``; the
instances file gives each image its file's own height and width.
"""

from __future__ import annotations

import json
import pathlib
import shutil
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..utils.safetensors import save_file
from .image_io import open_image
from .png import write_png

# COCO's 80 category ids (instances_train2014.json)
COCO_CATEGORY_IDS = (
    list(range(1, 12)) + list(range(13, 26)) + [27, 28]
    + list(range(31, 45)) + list(range(46, 66)) + [67, 70]
    + list(range(72, 83)) + list(range(84, 91)))
# (height, width) of common COCO images
COCO_SIZES = ((480, 640), (427, 640), (640, 480), (375, 500), (640, 427),
              (612, 612))


def _star_polygon(rng: np.random.Generator, h: int, w: int
                  ) -> Tuple[list, list, float]:
    """A simple polygon (vertices around a centre at sorted angles) with
    float vertices, its xywh box and its shoelace area."""
    cx, cy = rng.uniform(0.1 * w, 0.9 * w), rng.uniform(0.1 * h, 0.9 * h)
    r_max = rng.uniform(0.15, 0.4) * min(h, w)
    k = int(rng.integers(5, 24))
    ang = np.sort(rng.uniform(0, 2 * np.pi, k))
    rad = rng.uniform(0.4, 1.0, k) * r_max
    x = np.clip(cx + rad * np.cos(ang), 0, w - 1).round(2)
    y = np.clip(cy + rad * np.sin(ang), 0, h - 1).round(2)
    area = 0.5 * abs(float(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1))))
    box = [float(x.min()), float(y.min()), float(x.max() - x.min()),
           float(y.max() - y.min())]
    return [float(v) for xy in zip(x, y) for v in xy], box, area


def scene(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """An (h, w, 3) uint8 image: a gradient a channel and noise."""
    yy, xx = np.mgrid[0:h, 0:w]
    angles = rng.uniform(0, 2 * np.pi, 3)
    base = [127 + 100 * np.cos(a) * (xx / w - 0.5) * 2
            + 100 * np.sin(a) * (yy / h - 0.5) for a in angles]
    noisy = np.stack(base, -1) + rng.normal(0, 12, (h, w, 3))
    return np.clip(noisy, 0, 255).astype(np.uint8)


def copy_images(image_dir: pathlib.Path, rng: np.random.Generator,
                names: Sequence[str], sources: Sequence[str],
                png_every: int = 0,
                sizes: Sequence[Tuple[int, int]] = COCO_SIZES
                ) -> Dict[str, Tuple[str, int, int]]:
    """Fill ``image_dir`` with one image a name: a copy of a file of
    ``sources`` drawn from ``rng``, or, for every ``png_every``-th name, an
    RGB PNG of a :func:`scene` of a size drawn from ``sizes``. Returns
    name -> (file name, height, width)."""
    image_dir.mkdir(parents=True, exist_ok=True)
    dims = {}
    out = {}
    for i, name in enumerate(names):
        if png_every and i % png_every == png_every - 1:
            h, w = sizes[int(rng.integers(len(sizes)))]
            file_name = f"{name}.png"
            write_png(str(image_dir / file_name), scene(rng, h, w))
        else:
            src = sources[int(rng.integers(len(sources)))]
            if src not in dims:
                dims[src] = open_image(src).array.shape[:2]
            h, w = dims[src]
            file_name = f"{name}.jpg"
            shutil.copyfile(src, image_dir / file_name)
        out[name] = (file_name, int(h), int(w))
    return out


def write_synthetic_coco(root: str, seed: int = 0, num_images: int = 240,
                         embed_dim: int = 768, grid: int = 30,
                         anns_per_image: Tuple[int, int] = (2, 6),
                         sizes: Sequence[Tuple[int, int]] = COCO_SIZES,
                         category_ids: Sequence[int] = COCO_CATEGORY_IDS,
                         classes_per_image: int = 4,
                         image_sources: Optional[Sequence[str]] = None,
                         embeddings: bool = True,
                         ) -> Dict[str, str]:
    """Write ``instances.json`` and ``embeddings/`` under ``root`` (no
    caches when ``embeddings`` is False) and, given ``image_sources`` (JPEG
    files), ``images/`` (:func:`copy_images`, every fourth image a PNG);
    returns the paths (``instances_path``, ``emb_dir``, ``img_dir``). Each
    image draws ``anns_per_image`` polygons (inclusive) from up to
    ``classes_per_image`` categories dealt from a shuffled deck of all of
    them, so that every category shows in about as many images as any
    other, as the example generators need."""
    rng = np.random.default_rng(seed)
    root_p = pathlib.Path(root)
    emb_dir = root_p / "embeddings"
    if embeddings:
        emb_dir.mkdir(parents=True, exist_ok=True)
    files = None
    if image_sources:
        files = copy_images(root_p / "images", rng,
                            [f"{i:012d}" for i in range(1, num_images + 1)],
                            image_sources, png_every=4, sizes=sizes)
    images, annotations = [], []
    ann_id = 1
    deck: list = []
    for image_id in range(1, num_images + 1):
        if files is None:
            h, w = sizes[int(rng.integers(len(sizes)))]
            file_name = f"{image_id:012d}.jpg"
        else:
            file_name, h, w = files[f"{image_id:012d}"]
        images.append({"id": image_id, "file_name": file_name,
                       "height": int(h), "width": int(w)})
        lo, hi = anns_per_image
        n_anns = int(rng.integers(lo, hi + 1))
        pool: list = []
        while len(pool) < min(n_anns, classes_per_image):
            if not deck:
                deck = [int(c) for c in rng.permutation(category_ids)]
            cat = deck.pop()
            if cat not in pool:
                pool.append(cat)
        for i in range(n_anns):
            poly, box, area = _star_polygon(rng, h, w)
            cat = pool[i] if i < len(pool) else int(rng.choice(pool))
            annotations.append({
                "id": ann_id, "image_id": image_id, "category_id": cat,
                "segmentation": [poly], "bbox": box, "area": area,
                "iscrowd": 0})
            ann_id += 1
        if embeddings:
            emb = rng.standard_normal((embed_dim, grid, grid), np.float32)
            save_file({"embedding": emb},
                      str(emb_dir / f"{image_id:012d}.safetensors"))
    instances = {"images": images, "annotations": annotations,
                 "categories": [{"id": int(c), "name": f"class{c}",
                                 "supercategory": "none"}
                                for c in category_ids]}
    inst_path = root_p / "instances.json"
    inst_path.write_text(json.dumps(instances))
    out = {"instances_path": str(inst_path)}
    if embeddings:
        out["emb_dir"] = str(emb_dir)
    if files is not None:
        out["img_dir"] = str(root_p / "images")
    return out
