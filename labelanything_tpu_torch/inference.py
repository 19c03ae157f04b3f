"""Postprocess at each image's original resolution (counterpart of
``labelanything_tpu/inference.py``; reference:
label_anything/models/lam.py:383-452).

The model returns logits in the fixed ``image_size`` frame; the reference
evaluates at each image's own size: a bilinear resize to the model's size,
the per-image unpad, a bilinear resize to the original (H, W), then -inf
padding to the batch's largest size with the background forced to 0. The
JAX module emulates ``F.interpolate`` with matmuls; here it is
``F.interpolate`` (``ops/resize.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .data.transforms import get_preprocess_shape
from .ops.resize import resize_bilinear
from .typing import BatchKeys


def postprocess_to_original(seg: torch.Tensor,
                            original_sizes: Sequence[Tuple[int, int]],
                            image_size: int, custom_preprocess: bool = True
                            ) -> torch.Tensor:
    """(B, C, h, w) decoder-resolution logits to (B, C, Hmax, Wmax) fp32
    at the original sizes (the reference's postprocess)."""
    seg = resize_bilinear(seg.float(), (image_size, image_size))
    b, c = seg.shape[:2]
    max_h = max(int(h) for h, _ in original_sizes)
    max_w = max(int(w) for _, w in original_sizes)
    out = torch.full((b, c, max_h, max_w), float("-inf"),
                     dtype=torch.float32, device=seg.device)
    for i, (h, w) in enumerate(original_sizes):
        h, w = int(h), int(w)
        if custom_preprocess:
            ih, iw = get_preprocess_shape(h, w, image_size)
            cropped = seg[i, :, :ih, :iw]
        else:
            cropped = seg[i]
        out[i, :, :h, :w] = resize_bilinear(cropped[None], (h, w))[0]
    bg = out[:, 0]
    bg[torch.isneginf(bg)] = 0.0
    return out


@torch.no_grad()
def predict_original_resolution(model, batch: dict,
                                class_embeddings: Optional[dict] = None
                                ) -> torch.Tensor:
    """Decode and postprocess at the original resolutions: (B, C, Hmax,
    Wmax) logits, the reference ``Lam.forward``'s output. ``model`` is a
    ``LabelAnything`` (the batch goes to its device) or a ``Lam``;
    ``batch`` carries the decoder's inputs and ``dims`` (B, N, 2). Without
    ``class_embeddings`` the whole episode is decoded (query index 0)."""
    if hasattr(model, "to_device"):
        batch = model.to_device(batch)
        model = model.model
    if class_embeddings is None:
        seg, _ = model._forward(batch)
    else:
        seg = model.raw_decode(batch, class_embeddings)
    dims = batch[BatchKeys.DIMS].reshape(seg.shape[0], -1, 2)[:, 0]
    return postprocess_to_original(
        seg, [tuple(int(x) for x in d) for d in dims.tolist()],
        model.image_size, model.custom_preprocess)
