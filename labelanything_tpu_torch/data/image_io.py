"""Opening and converting image files without PIL: the port's stand-in
for every ``Image.open(path).convert(mode)`` of the JAX package.

:func:`open_image` reads a file, finds its format by its signature (JPEG,
PNG, TIFF) and returns the decoded array with PIL's name for its mode, as
``np.asarray(Image.open(path))`` and ``Image.open(path).mode`` give them,
and the palette of a "P" image. :func:`convert` does what PIL's
``convert`` does to such an array, bit for bit: "RGB" from L, LA, P,
RGBA, CMYK or I;16; "L" from RGB, RGBA, LA, P, CMYK or I;16 (PIL's
integer ITU-R 601-2 luma, ``(19595 R + 38470 G + 7471 B + 0x8000) >>
16``); "P" from P or L, for ``preprocess_voc``. PIL dithers RGB to its web
palette for "P"; that conversion raises here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from . import jpeg, png, tiff


class DecodedImage(NamedTuple):
    array: np.ndarray
    mode: str
    palette: Optional[np.ndarray] = None   # (N, 3) uint8 of a "P" image


def _png_mode(image: np.ndarray, palette) -> str:
    if image.ndim == 2:
        return "I;16" if image.dtype == np.uint16 else (
            "P" if palette is not None else "L")
    return {2: "LA", 3: "RGB", 4: "RGBA"}[image.shape[2]]


def decode_image(data: bytes) -> DecodedImage:
    """The decoded image of a file's bytes (module docstring)."""
    if data[:2] == b"\xff\xd8":
        array = jpeg.decode_jpeg(data)
        return DecodedImage(array, jpeg.MODES[1 if array.ndim == 2
                                              else array.shape[2]])
    if data[:8] == png.SIGNATURE:
        array, palette = png.decode_png(data)
        return DecodedImage(array, _png_mode(array, palette), palette)
    if data[:4] in tiff.SIGNATURES:
        array = tiff.decode_tiff(data)
        return DecodedImage(array, "L" if array.ndim == 2 else
                            {3: "RGB", 4: "RGBA"}[array.shape[2]])
    raise ValueError(f"unknown image format (signature {data[:8]!r}): "
                     "JPEG, PNG and TIFF are read")


def open_image(path) -> DecodedImage:
    """``decode_image`` of the file at ``path``."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_image(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from e


def _luma(rgb: np.ndarray) -> np.ndarray:
    x = rgb.astype(np.int64)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def _palette_rgb(palette: Optional[np.ndarray]) -> np.ndarray:
    """The 256-entry palette PIL looks indices up in: entries past the
    file's palette are black."""
    table = np.zeros((256, 3), np.uint8)
    if palette is not None:
        table[:len(palette)] = palette[:256]
    return table


def _cmyk_rgb(cmyk: np.ndarray) -> np.ndarray:
    """PIL's ``cmyk2rgb``: nk - c nk / 255 with its rounding division."""
    x = cmyk.astype(np.int64)
    nk = 255 - x[..., 3:]
    t = x[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def convert(image, mode: Optional[str] = None, target: str = "RGB",
            palette: Optional[np.ndarray] = None) -> np.ndarray:
    """PIL's ``convert(target)`` of an array of mode ``mode`` (or of a
    :class:`DecodedImage`, whose mode and palette are used)."""
    if isinstance(image, DecodedImage):
        image, mode, palette = image
    image = np.asarray(image)
    if mode == target:
        return image
    if target == "RGB":
        if mode in ("L", "LA"):
            g = image if mode == "L" else image[..., 0]
            return np.repeat(g[..., None], 3, axis=2)
        if mode == "I;16":
            g = np.minimum(image, 255).astype(np.uint8)
            return np.repeat(g[..., None], 3, axis=2)
        if mode == "P":
            return _palette_rgb(palette)[image]
        if mode == "RGBA":
            return np.ascontiguousarray(image[..., :3])
        if mode == "CMYK":
            return _cmyk_rgb(image)
    elif target == "L":
        if mode in ("RGB", "RGBA"):
            return _luma(image[..., :3])
        if mode == "LA":
            return np.ascontiguousarray(image[..., 0])
        if mode == "I;16":
            return np.minimum(image, 255).astype(np.uint8)
        if mode == "P":
            return _luma(_palette_rgb(palette))[image]
        if mode == "CMYK":
            return _luma(_cmyk_rgb(image))
    elif target == "P":
        if mode == "L":
            return image
    raise ValueError(f"converting {mode} to {target} is not supported"
                     + (" (PIL dithers to its web palette)"
                        if target == "P" else ""))


def read_rgb(path) -> np.ndarray:
    """``np.asarray(Image.open(path).convert("RGB"))``."""
    return convert(open_image(path), target="RGB")


def read_gray(path) -> np.ndarray:
    """``np.asarray(Image.open(path).convert("L"))``."""
    return convert(open_image(path), target="L")
