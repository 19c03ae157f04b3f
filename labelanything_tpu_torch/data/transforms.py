"""Image preprocessing on decoded uint8 arrays (counterpart of the image
parts of ``labelanything_tpu/data/transforms.py``; reference:
label_anything/data/transforms.py).

The JAX package resizes PIL images; the port takes images decoded to
arrays (``data/image_io.py``) and resizes them as PIL's ``Image.resize``
does with the BILINEAR filter, bit for bit: the triangle filter stretched
by the downscale factor, its weights computed in double precision and
rounded to 22 fractional bits, the horizontal pass rounded to uint8 before
the vertical one (Pillow's ``Resample.c``). :func:`resize_uint8` runs the
passes in C (``csrc/resample.c``, in the host library of
``data/native.py``; it raises when that cannot be built),
:func:`resize_uint8_plain` in numpy, for the tests.

The prompt half (``PromptsProcessor``, ``gt_to_input_frame``,
``nearest_index_map``) is the JAX module's numpy code; the one piece that
went through PIL there, the index map of a NEAREST resize, is computed
here as PIL's affine nearest sampler computes it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..ops.image_norm import IMAGENET_MEAN, IMAGENET_STD  # noqa: F401
from ..typing import IGNORE_INDEX
from . import native
from . import rle as rle_codec
from .image_io import read_rgb


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


_PRECISION_BITS = 32 - 8 - 2


def _bilinear_coeffs(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` for the BILINEAR filter and its
    ``normalize_coeffs_8bpc``: per output position the first input index
    and the integer weights (out_size, ksize) of the taps, 0 past the
    window. Double precision and the C order of every operation, the sum
    of the weights taken tap by tap."""
    scale = float(np.float32(in_size)) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size)
    xmax -= xmin
    taps = np.arange(ksize)
    x = (taps[None, :] + xmin[:, None]).astype(np.float64)
    w = 1.0 - np.abs((x - center[:, None] + 0.5) * ss)
    w = np.where((w > 0.0) & (taps[None, :] < xmax[:, None]), w, 0.0)
    ww = np.zeros(out_size)
    for t in range(ksize):
        ww = ww + w[:, t]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    k = np.where(w < 0, -0.5 + w * (1 << _PRECISION_BITS),
                 0.5 + w * (1 << _PRECISION_BITS)).astype(np.int64)
    return xmin, k


def _resample_axis(x: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resample along ``axis`` (0 or 1) of a
    uint8 array: fixed-point sums (int32, as Pillow's) rounded by half
    and clipped to uint8."""
    xmin, k = _bilinear_coeffs(x.shape[axis], out_size)
    idx = np.minimum(xmin[:, None] + np.arange(k.shape[1])[None, :],
                     x.shape[axis] - 1)
    shape = list(x.shape)
    shape[axis] = out_size
    acc = np.full(shape, 1 << (_PRECISION_BITS - 1), np.int32)
    bshape = [1] * x.ndim
    bshape[axis] = out_size
    for t in range(k.shape[1]):
        taps = np.take(x, idx[:, t], axis=axis).astype(np.int32)
        taps *= k[:, t].astype(np.int32).reshape(bshape)
        acc += taps
    acc >>= _PRECISION_BITS
    return np.clip(acc, 0, 255).astype(np.uint8)


def resize_uint8_plain(image: np.ndarray, size: Tuple[int, int]
                       ) -> np.ndarray:
    """PIL's ``Image.resize((w, h), BILINEAR)`` of an (H, W[, C]) uint8
    array to ``size`` (h, w), bit for bit, in numpy: the horizontal pass
    first, each pass skipped where its axis keeps its length."""
    h, w = (int(s) for s in size)
    out = np.asarray(image)
    if out.shape[1] != w:
        out = _resample_axis(out, w, 1)
    if out.shape[0] != h:
        out = _resample_axis(out, h, 0)
    return np.ascontiguousarray(out)


def resize_uint8(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """:func:`resize_uint8_plain`'s result by ``csrc/resample.c``."""
    lib = native.load_library()
    image = np.ascontiguousarray(image, dtype=np.uint8)
    squeeze = image.ndim == 2
    x = image[:, :, None] if squeeze else image
    h, w, c = x.shape
    oh, ow = (int(s) for s in size)
    if (oh, ow) == (h, w):
        return image.copy()
    args = []
    for n_in, n_out in ((w, ow), (h, oh)):
        if n_in == n_out:
            args.append((None, None, 0))
            continue
        start, k = _bilinear_coeffs(n_in, n_out)
        args.append((np.ascontiguousarray(start, np.int32),
                     np.ascontiguousarray(k, np.int32), k.shape[1]))
    out = np.empty((oh, ow, c), np.uint8)
    tmp = np.empty((h, ow, c), np.uint8)
    ptr = lambda a: None if a is None else a.ctypes.data  # noqa: E731
    (xmin, xk, xks), (ymin, yk, yks) = args
    if lib.la_resample_u8(x.ctypes.data, h, w, c, out.ctypes.data, oh, ow,
                          ptr(xmin), ptr(xk), xks, ptr(ymin), ptr(yk), yks,
                          tmp.ctypes.data) != 0:
        raise ValueError(f"resample of {image.shape} to {size} refused")
    return out[:, :, 0] if squeeze else out


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


def normalize_padded(image: np.ndarray, long_side_length: int) -> np.ndarray:
    """ImageNet normalization of an (h, w, 3) uint8 image in float32 and a
    bottom-right pad to (S, S, 3) with zeros (reference: transforms.py:
    27-46; the JAX ``CustomNormalize``)."""
    x = np.asarray(image, np.float32) / 255.0
    x = (x - np.asarray(IMAGENET_MEAN, np.float32)) / np.asarray(
        IMAGENET_STD, np.float32)
    h, w = x.shape[:2]
    out = np.zeros((long_side_length, long_side_length, 3), np.float32)
    out[:h, :w] = x
    return out


def preprocess_image(image: np.ndarray, long_side_length: int,
                     custom: bool = True, normalize: bool = True,
                     out: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """The JAX ``preprocess_image`` on a decoded RGB uint8 array: the
    long-side resize (``custom``) or the square one, then with
    ``normalize`` the normalized (S, S, 3) float32 frame, else the (S, S,
    3) uint8 frame padded with zeros (written into ``out`` when given).
    Returns it and the image's (H, W) before the resize."""
    image = as_rgb(image)
    h, w = image.shape[:2]
    if custom:
        image = CustomResize(long_side_length)(image)
    elif image.shape[:2] != (long_side_length, long_side_length):
        image = resize_uint8(image, (long_side_length, long_side_length))
    if normalize:
        return normalize_padded(image, long_side_length), (h, w)
    s = long_side_length
    if out is None:
        out = np.zeros((s, s, 3), np.uint8)
    out[:image.shape[0], :image.shape[1]] = image
    return out, (h, w)


def image_frames(paths: Sequence[str], size: int, custom: bool
                 ) -> np.ndarray:
    """(N, S, S, 3) uint8 of image files: each read as RGB and put in its
    frame by :func:`preprocess_image` without normalizing (the JAX uint8
    ingest; the card normalizes)."""
    buf = np.zeros((len(paths), size, size, 3), np.uint8)
    for frame, path in zip(buf, paths):
        preprocess_image(read_rgb(path), size, custom, normalize=False,
                         out=frame)
    return buf


def resized_dims(sizes: Sequence[Tuple[int, int]], size: int,
                 custom: bool) -> np.ndarray:
    """(N, 2) int32: the extent that images of (H, W) ``sizes`` take in
    their frames after the resize, so that the card's normalization never
    derives it again with other rounding."""
    return np.asarray([get_preprocess_shape(h, w, size) if custom
                       else (size, size) for h, w in sizes], np.int32)


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
