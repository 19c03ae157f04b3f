"""Image preprocessing on decoded uint8 arrays (counterpart of the image
parts of ``labelanything_tpu/data/transforms.py``; reference:
label_anything/data/transforms.py).

The JAX package resizes PIL images; the port takes images already decoded
to (H, W, 3) uint8 arrays and resizes them with ``F.interpolate`` on the
host: bilinear with antialiasing, which on uint8 input is PIL's BILINEAR
filter (a triangle stretched by the downscale factor, fixed-point sums,
the rows' pass rounded to uint8 before the columns').

The prompt half (``PromptsProcessor``, ``gt_to_input_frame``,
``nearest_index_map``) is the JAX module's numpy code; the one piece that
went through PIL there, the index map of a NEAREST resize, is computed
here as PIL's affine nearest sampler computes it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.image_norm import IMAGENET_MEAN, IMAGENET_STD  # noqa: F401
from ..typing import IGNORE_INDEX
from . import rle as rle_codec


def get_preprocess_shape(oldh: int, oldw: int,
                         long_side_length: int) -> Tuple[int, int]:
    """(reference: data/utils.py:441-449)."""
    scale = long_side_length * 1.0 / max(oldh, oldw)
    return int(oldh * scale + 0.5), int(oldw * scale + 0.5)


def as_rgb(image: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 of a decoded image: a grey (H, W) one repeated over
    three channels, an alpha channel dropped (PIL's ``convert("RGB")``)."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise TypeError(f"images are uint8 arrays, got {image.dtype}")
    if image.ndim == 2:
        image = np.repeat(image[:, :, None], 3, axis=2)
    if image.ndim != 3 or image.shape[2] not in (3, 4):
        raise ValueError(f"an image is (H, W), (H, W, 3) or (H, W, 4), got "
                         f"{image.shape}")
    return image[:, :, :3]


def resize_uint8(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL's BILINEAR resize of an (H, W, 3) uint8 array to ``size`` (h, w):
    ``F.interpolate(antialias=True)`` on the uint8 tensor laid out channels
    last."""
    x = torch.from_numpy(np.array(image, copy=True)).permute(2, 0, 1)[None]
    y = F.interpolate(x, size=tuple(int(s) for s in size), mode="bilinear",
                      align_corners=False, antialias=True)
    return np.ascontiguousarray(y[0].permute(1, 2, 0).numpy())


class CustomResize:
    """Long-side resize preserving aspect ratio (reference:
    transforms.py:14-24), on (H, W, 3) uint8 arrays."""

    def __init__(self, long_side_length: int = 1024):
        self.long_side_length = long_side_length

    def __call__(self, image: np.ndarray) -> np.ndarray:
        image = as_rgb(image)
        h, w = image.shape[:2]
        nh, nw = get_preprocess_shape(h, w, self.long_side_length)
        if (nh, nw) == (h, w):
            return image        # PIL's identity resize changes nothing
        return resize_uint8(image, (nh, nw))


def gt_to_input_frame(gt: np.ndarray, long_side: int,
                      custom: bool = True) -> np.ndarray:
    """Nearest-resize an int GT map into the padded input frame with
    IGNORE_INDEX fill, one numpy gather through :func:`nearest_index_map`."""
    h, w = gt.shape
    s = long_side
    nh, nw = get_preprocess_shape(h, w, s) if custom else (s, s)
    out = np.full((s, s), IGNORE_INDEX, np.int32)
    if (nh, nw) == (h, w):  # identity resize: the maps are arange
        out[:nh, :nw] = gt
    else:
        out[:nh, :nw] = gt[np.ix_(nearest_index_map(h, nh),
                                  nearest_index_map(w, nw))]
    return out


_NEAREST_MAP_CACHE: dict = {}


def nearest_index_map(n_src: int, n_dst: int) -> np.ndarray:
    """The source index that PIL's NEAREST resize samples for each of
    ``n_dst`` positions along an axis of ``n_src``: PIL walks the affine
    map from ``scale / 2`` in steps of ``scale = n_src / n_dst``, adding in
    float64, and truncates; ``np.cumsum`` adds in the same order, so the
    map is PIL's bit for bit. Cached per (n_src, n_dst)."""
    key = (n_src, n_dst)
    m = _NEAREST_MAP_CACHE.get(key)
    if m is None:
        scale = n_src / n_dst
        steps = np.full(n_dst, scale)
        steps[0] = scale * 0.5
        m = np.cumsum(steps).astype(np.int64)
        _NEAREST_MAP_CACHE[key] = m
    return m


class PromptsProcessor:
    """Annotation -> prompt conversion (reference: transforms.py:68-224)."""

    def __init__(self, long_side_length: int = 1024, masks_side_length: int = 256,
                 custom_preprocess: bool = True,
                 rng: Optional[np.random.Generator] = None):
        self.long_side_length = long_side_length
        self.masks_side_length = masks_side_length
        self.custom_preprocess = custom_preprocess
        self.rng = rng or np.random.default_rng()

    def convert_mask(self, segm, h: int, w: int) -> np.ndarray:
        """Polygons / RLE -> binary mask with the degenerate single-pixel
        fallback (reference: transforms.py:123-149)."""
        return rle_codec.ann_to_mask(segm, h, w)

    def _add_bbox_noise(self, bbox, hb, wb, h, w):
        x1, y1, x2, y2 = bbox
        n = lambda s: float(np.clip(self.rng.normal(0, s), -20, 20))
        return [
            float(np.clip(x1 + n(0.1 * wb), 0, w)),
            float(np.clip(y1 + n(0.1 * hb), 0, h)),
            float(np.clip(x2 + n(0.1 * wb), 0, w)),
            float(np.clip(y2 + n(0.1 * hb), 0, h)),
        ]

    def convert_bbox(self, bbox, h: int, w: int, noise: bool = False):
        """xywh -> xyxy with optional clipped Gaussian noise
        (reference: transforms.py:96-122)."""
        x, y, wb, hb = bbox
        box = [x, y, x + wb, y + hb]
        return self._add_bbox_noise(box, hb, wb, h, w) if noise else box

    def sample_points(self, mask: np.ndarray, k: int) -> List[Tuple[int, int]]:
        """k uniform positive-pixel samples -> [(x, y), ...]."""
        flat = np.flatnonzero(mask)
        idx = flat[self.rng.integers(len(flat), size=k)]
        w = mask.shape[1]
        return [(int(i % w), int(i // w)) for i in idx]

    def apply_coords(self, coords: np.ndarray,
                     original_size: Tuple[int, int]) -> np.ndarray:
        """Rescale xy coords from the original frame to the input frame
        (reference: transforms.py:159-177)."""
        old_h, old_w = original_size
        if self.custom_preprocess:
            new_h, new_w = get_preprocess_shape(old_h, old_w,
                                                self.long_side_length)
        else:
            new_h, new_w = self.long_side_length, self.long_side_length
        coords = np.asarray(coords, np.float64).copy()
        coords[..., 0] *= new_w / old_w
        coords[..., 1] *= new_h / old_h
        return coords

    def apply_boxes(self, boxes: np.ndarray,
                    original_size: Tuple[int, int]) -> np.ndarray:
        boxes = self.apply_coords(np.asarray(boxes).reshape(-1, 2, 2),
                                  original_size)
        return boxes.reshape(-1, 4)

    def apply_masks(self, masks: List[np.ndarray]) -> np.ndarray:
        """OR-reduce instance masks, resize (nearest) into the padded input
        frame, then downsample to masks_side_length (reference:
        transforms.py:203-224), composed into one gather of
        ``masks_side_length ** 2`` pixels per instance."""
        msl = self.masks_side_length
        if len(masks) == 0:
            return np.zeros((msl, msl), np.uint8)
        first = np.asarray(masks[0])
        h, w = first.shape
        s = self.long_side_length
        if self.custom_preprocess:
            nh, nw = get_preprocess_shape(h, w, s)
            r2 = nearest_index_map(s, msl)
            valid = (r2 < nh)[:, None] & (r2 < nw)[None, :]
            rows = nearest_index_map(h, nh)[np.minimum(r2, nh - 1)]
            cols = nearest_index_map(w, nw)[np.minimum(r2, nw - 1)]
        else:
            valid = None
            rows = nearest_index_map(h, msl)
            cols = nearest_index_map(w, msl)
        ix = np.ix_(rows, cols)
        acc = first[ix] != 0
        for m in masks[1:]:
            acc |= np.asarray(m)[ix] != 0
        out = acc.astype(np.uint8)
        if valid is not None:
            out[~valid] = 0
        return out
