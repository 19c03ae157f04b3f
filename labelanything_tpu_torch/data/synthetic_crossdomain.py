"""Synthetic roots of the four cross-domain test sets (``data/crossdomain.py``)
on disk, made from a seed and given image files, in each set's folder
layout and file formats:

* Kvasir-SEG: ``{train,test}/{images,masks}/<name>.jpg``, JPEG images and
  JPEG masks (polyp where the mask is at least 245);
* WeedMap: ``{train,test}/tile/{R,G,B}/<frame>.png``, one grayscale PNG a
  channel, and ``groundtruth/<frame>_GroundTruth_color.png``, an RGB PNG
  (green crop, red weed);
* Brain MRI: ``<patient>/<name>.tif`` and ``<name>_mask.tif``;
* DRAM: ``{train,test}/<painting>/<name>.jpg`` with palette PNG labels
  under ``{train,test}/labels/<painting>/<name>.png`` (12 classes).

JPEG and TIFF files are copies of the given sources (the card's machine
has no encoder for them); PNGs are written by ``data/png.py``. The support
files take the names the datasets default to, so a config needs only the
root.
"""

from __future__ import annotations

import os
import pathlib
import shutil
from typing import Dict, Sequence

import numpy as np

from .crossdomain import KvasirTestDataset, WeedMapTestDataset
from .image_io import open_image
from .png import voc_palette, write_png
from .synthetic_coco import scene


def _blobs(rng: np.random.Generator, h: int, w: int, labels: int,
           count: int = 3) -> np.ndarray:
    """(h, w) uint8: ``count`` ellipses of labels 1 to ``labels`` on 0."""
    out = np.zeros((h, w), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(count):
        cy, cx = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w
        ry, rx = rng.uniform(0.1, 0.3) * h, rng.uniform(0.1, 0.3) * w
        out[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1] = \
            int(rng.integers(1, labels + 1))
    return out


def write_kvasir(root: str, pairs: Sequence[Sequence[str]],
                 num_test: int = 4, seed: int = 0) -> Dict[str, str]:
    """``pairs``: (image JPEG, mask JPEG) files of equal size; the first
    becomes the default support image, ``num_test`` drawn ones the
    queries."""
    rng = np.random.default_rng(seed)
    root_p = pathlib.Path(root)
    names = ([("train", KvasirTestDataset.DEFAULT_PROMPTS[0])]
             + [("test", f"query{i:03d}.jpg") for i in range(num_test)])
    for k, (split, name) in enumerate(names):
        image, mask = pairs[0] if k == 0 else pairs[
            int(rng.integers(len(pairs)))]
        for kind, src in (("images", image), ("masks", mask)):
            d = root_p / split / kind
            d.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(src, d / name)
    return {"root": str(root_p)}


def write_weedmap(root: str, size=(96, 128), num_test: int = 4,
                  seed: int = 0) -> Dict[str, str]:
    rng = np.random.default_rng(seed)
    root_p = pathlib.Path(root)
    h, w = size
    frames = ([("train", n) for n in WeedMapTestDataset.DEFAULT_PROMPTS]
              + [("test", f"frame{100 + i:04d}_0.png")
                 for i in range(num_test)])
    for split, name in frames:
        image = scene(rng, h, w)
        for c, ch in enumerate("RGB"):
            d = root_p / split / "tile" / ch
            d.mkdir(parents=True, exist_ok=True)
            write_png(str(d / name), image[..., c])
        labels = _blobs(rng, h, w, 2)
        colour = np.zeros((h, w, 3), np.uint8)
        colour[labels == 1, 1] = 255      # crop: green
        colour[labels == 2, 0] = 255      # weed: red
        d = root_p / split / "groundtruth"
        d.mkdir(parents=True, exist_ok=True)
        write_png(str(d / f"{name.split('.')[0]}_GroundTruth_color.png"),
                  colour)
    return {"train_root": str(root_p / "train"),
            "test_root": str(root_p / "test")}


def write_brain(root: str, pairs: Sequence[Sequence[str]],
                num_images: int = 8, seed: int = 0) -> Dict[str, str]:
    """``pairs``: (image TIFF, mask TIFF) files of equal size, copied into
    two patients' folders."""
    rng = np.random.default_rng(seed)
    root_p = pathlib.Path(root)
    for i in range(num_images):
        image, mask = pairs[int(rng.integers(len(pairs)))]
        d = root_p / f"TCGA_CS_{4941 + i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(image, d / f"TCGA_CS_{4941 + i % 2}_{i + 1}.tif")
        shutil.copyfile(mask, d / f"TCGA_CS_{4941 + i % 2}_{i + 1}_mask.tif")
    return {"root": str(root_p)}


def write_dram(root: str, images: Sequence[str], num_train: int = 4,
               num_test: int = 4, seed: int = 0) -> Dict[str, str]:
    """``images``: JPEG files; each copy gets a palette label of its size
    with 12 classes."""
    rng = np.random.default_rng(seed)
    root_p = pathlib.Path(root)
    dims: Dict[str, tuple] = {}
    palette = voc_palette()
    for split, count in (("train", num_train), ("test", num_test)):
        for i in range(count):
            src = images[int(rng.integers(len(images)))]
            if src not in dims:
                dims[src] = open_image(src).array.shape[:2]
            painting = f"painter{i % 2}"
            name = f"{split}{i:03d}"
            d = root_p / split / painting
            d.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(src, d / f"{name}.jpg")
            labels = root_p / split / "labels" / painting
            labels.mkdir(parents=True, exist_ok=True)
            write_png(str(labels / f"{name}.png"),
                      _blobs(rng, *dims[src], labels=11, count=4), palette)
    return {"root": str(root_p)}


def write_crossdomain_roots(root: str, jpegs: Sequence[str],
                            kvasir_pairs: Sequence[Sequence[str]],
                            brain_pairs: Sequence[Sequence[str]],
                            seed: int = 0) -> Dict[str, Dict[str, str]]:
    """The four roots under ``root``: the dataset parameters of each
    (``test_kvasir``, ``test_weedmap``, ``test_brain``, ``test_dram``)."""
    return {
        "test_kvasir": write_kvasir(os.path.join(root, "kvasir"),
                                    kvasir_pairs, seed=seed),
        "test_weedmap": write_weedmap(os.path.join(root, "weedmap"),
                                      seed=seed),
        "test_brain": write_brain(os.path.join(root, "brain"), brain_pairs,
                                  seed=seed),
        "test_dram": write_dram(os.path.join(root, "dram"), jpegs, seed=seed),
    }
