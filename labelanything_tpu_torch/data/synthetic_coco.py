"""A synthetic COCO root on disk, made from a seed: an instances JSON with
COCO's 80 category ids and images of COCO's sizes, each with polygon
annotations, and one embedding cache per image in the layout ``preprocess``
writes (``{id:012d}.safetensors`` holding ``embedding``, (C, h, w)). The
episode engine reads it as it reads a real COCO root's annotations and
caches; the embeddings are random.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, Sequence, Tuple

import numpy as np

from ..utils.safetensors import save_file

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


def write_synthetic_coco(root: str, seed: int = 0, num_images: int = 240,
                         embed_dim: int = 768, grid: int = 30,
                         anns_per_image: Tuple[int, int] = (2, 6),
                         sizes: Sequence[Tuple[int, int]] = COCO_SIZES,
                         category_ids: Sequence[int] = COCO_CATEGORY_IDS,
                         classes_per_image: int = 4,
                         ) -> Dict[str, str]:
    """Write ``instances.json`` and ``embeddings/`` under ``root``; returns
    their paths (``instances_path``, ``emb_dir``). Each image draws
    ``anns_per_image`` polygons (inclusive) from up to
    ``classes_per_image`` categories dealt from a shuffled deck of all of
    them, so that every category shows in about as many images as any
    other, as the example generators need."""
    rng = np.random.default_rng(seed)
    root_p = pathlib.Path(root)
    emb_dir = root_p / "embeddings"
    emb_dir.mkdir(parents=True, exist_ok=True)
    images, annotations = [], []
    ann_id = 1
    deck: list = []
    for image_id in range(1, num_images + 1):
        h, w = sizes[int(rng.integers(len(sizes)))]
        images.append({"id": image_id, "file_name": f"{image_id:012d}.jpg",
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
        emb = rng.standard_normal((embed_dim, grid, grid), np.float32)
        save_file({"embedding": emb}, str(emb_dir / f"{image_id:012d}.safetensors"))
    instances = {"images": images, "annotations": annotations,
                 "categories": [{"id": int(c), "name": f"class{c}",
                                 "supercategory": "none"}
                                for c in category_ids]}
    inst_path = root_p / "instances.json"
    inst_path.write_text(json.dumps(instances))
    return {"instances_path": str(inst_path), "emb_dir": str(emb_dir)}
