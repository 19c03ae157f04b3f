"""Device-side image normalization for uint8 ingest (counterpart of
``labelanything_tpu/ops/image_norm.py``).

The valid region of each image gets ``(u8 / 255 - mean) / std`` in fp32 and
the bottom/right pad region is zero in the normalized frame. The valid
extent comes from ``RESIZED_DIMS`` when the loader ships it, else from the
original (H, W) by exact integer round-half-up.
"""

from __future__ import annotations

from typing import Optional

import torch

# ImageNet statistics (labelanything_tpu/data/transforms.py; that module
# imports PIL, so the two tuples are copied rather than imported)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def preprocess_shape(dims: torch.Tensor, long_side: int):
    """(nh, nw) of the long-side resize: ``int(h * S / m + 0.5)`` computed
    as ``(2 h S + m) // (2 m)`` in integers."""
    h = dims[..., 0].long()
    w = dims[..., 1].long()
    m = torch.maximum(h, w)
    return (2 * h * long_side + m) // (2 * m), (2 * w * long_side + m) // (2 * m)


def normalize_images(images: torch.Tensor, dims: torch.Tensor, long_side: int,
                     custom_preprocess: bool = True,
                     resized_dims: Optional[torch.Tensor] = None) -> torch.Tensor:
    """uint8 (..., S, S, 3) -> normalized fp32 with the pad region zeroed."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=images.device)
    x = (images.float() / 255.0 - mean) / std
    if custom_preprocess:
        s = images.shape[-2]
        if resized_dims is not None:
            nh, nw = resized_dims[..., 0].long(), resized_dims[..., 1].long()
        else:
            nh, nw = preprocess_shape(dims, long_side)
        idx = torch.arange(s, device=images.device)
        valid = ((idx[:, None] < nh[..., None, None])
                 & (idx[None, :] < nw[..., None, None]))
        x = x * valid[..., None].to(x.dtype)
    return x


def maybe_normalize_images(images: torch.Tensor, dims: torch.Tensor,
                           long_side: int, custom_preprocess: bool = True,
                           resized_dims: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Normalize uint8 pixels on device; pass host-normalized floats through."""
    if images.dtype == torch.uint8:
        return normalize_images(images, dims, long_side, custom_preprocess,
                                resized_dims)
    return images
