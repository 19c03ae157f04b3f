"""Image preprocessing on decoded uint8 arrays (counterpart of the image
parts of ``labelanything_tpu/data/transforms.py``; reference:
label_anything/data/transforms.py).

The JAX package resizes PIL images; the port takes images already decoded
to (H, W, 3) uint8 arrays and resizes them with ``F.interpolate`` on the
host: bilinear with antialiasing, which on uint8 input is PIL's BILINEAR
filter (a triangle stretched by the downscale factor, fixed-point sums,
the rows' pass rounded to uint8 before the columns'). The prompt and mask
helpers of the JAX module are not ported yet (ROADMAP A11).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.image_norm import IMAGENET_MEAN, IMAGENET_STD  # noqa: F401


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
