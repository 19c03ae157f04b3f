"""PNG reading and writing in numpy and the standard library's ``zlib``:
the port's stand-in for PIL wherever the JAX package opens a PNG (the
VOC masks of ``data/pascal.py``, WeedMap's channel tiles and DRAM's
labels in ``data/crossdomain.py``, any ``.png`` of an image folder), as
``data/rle.py`` stands in for PIL's polygon fill.

:func:`read_png` and :func:`decode_png` return what
``np.asarray(PIL.Image.open(path))`` returns: grayscale (colour type 0)
as (H, W) uint8 at 8 bits and (H, W) uint16 at 16 (PIL's "I;16"),
palette images (3) as (H, W) uint8 indices with the palette beside them,
RGB (2) as (H, W, 3), grayscale with alpha (4) as (H, W, 2) ("LA"; at 16
bits PIL reads it as "RGBA", the grey repeated), RGBA (6) as (H, W, 4);
16-bit colour samples keep their high byte, as PIL's "RGB;16B" rawmodes
do. Adam7 interlacing is undone. Bit depths below 8 raise ``ValueError``,
as do combinations the standard does not allow. The writer writes 8-bit
grayscale, palette and RGB images, not interlaced.

Decoding undoes the five row filters of the PNG standard (section 9.2)
in C (:func:`unfilter`: ``csrc/png_unfilter.c`` in the host library of
``data/native.py``, which raises when it cannot be built).
:func:`unfilter_plain` is its numpy twin, for the tests: a filter predicts
a byte from the byte one pixel to its left, so the bytes of a pixel form
lanes that unfilter apart; None, Sub and Up are whole-row operations;
Average and Paeth rows are recurrences, and a run of such rows is decoded
as a wavefront over anti-diagonals, each diagonal one vector operation
over the rows (a pixel depends on its left, upper and upper-left
neighbours, all on earlier diagonals).
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple, Union

import numpy as np

from . import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
GRAY, RGB, PALETTE, GRAY_ALPHA, RGBA = 0, 2, 3, 4, 6
_CHANNELS = {GRAY: 1, RGB: 3, PALETTE: 1, GRAY_ALPHA: 2, RGBA: 4}
# Adam7: (x0, y0, dx, dy) of the seven passes
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_COLOUR_NAMES = {0: "grayscale", 2: "RGB", 3: "palette", 4: "grayscale+alpha",
                 6: "RGBA"}


def _chunks(data: bytes):
    """(type, payload) of each chunk after the signature, CRC checked."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        length, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before its IEND chunk")


def _wavefront(filtered: np.ndarray, kinds: np.ndarray, prev: np.ndarray,
               out: np.ndarray) -> None:
    """Undo the filters ``kinds`` (one a row, any of the five) on ``n``
    consecutive rows, ``prev`` the decoded row above the first (zeros at
    the top of the image), into ``out`` (n, w).

    The rows are skewed so that diagonal ``k`` (pixels with x + j == k) is
    row ``k + 2`` of ``t``; column ``j + 1`` holds run row ``j`` and column
    0 the row above the run. A pixel left of its row's start stays 0, as
    the standard reads it."""
    n, w = filtered.shape
    diagonals = w + n - 1
    jj = np.arange(n)[:, None]
    kk = jj + np.arange(w)[None, :]
    skewed = np.zeros((diagonals, n), np.int16)
    skewed[kk, np.broadcast_to(jj, kk.shape)] = filtered
    t = np.zeros((diagonals + 2, n + 1), np.int16)
    t[1:w + 1, 0] = prev
    masks = [(kind, kinds == kind) for kind in (1, 2, 3)]
    masks = [(kind, m) for kind, m in masks if m.any()]
    paeth = kinds == 4
    any_paeth, all_paeth = bool(paeth.any()), bool(paeth.all())
    for k in range(diagonals):
        a = t[k + 1, 1:]          # left
        b = t[k + 1, :-1]         # up
        c = t[k, :-1]             # up-left
        if any_paeth:
            bc, ac = b - c, a - c
            pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
            if not all_paeth:
                pred = np.where(paeth, pred, 0)
        else:
            pred = np.zeros_like(a)
        for kind, m in masks:
            pred = np.where(m, (a, b, (a + b) >> 1)[kind - 1], pred)
        pred += skewed[k]
        np.bitwise_and(pred, 255, out=t[k + 2, 1:])
    out[:] = t[kk + 2, jj + 1]


def _unfilter(raw: np.ndarray, height: int, width: int) -> np.ndarray:
    """(height, 1 + width) filtered scanlines of one-byte pixels, filter
    byte first -> the (height, width) uint8 image.

    Rows of None, Sub and Up go one at a time. From the first Average or
    Paeth row to the last, the rows go by one wavefront (w + n vector steps
    for n rows, whatever their filters)."""
    kinds = raw[:, 0]
    if kinds.size and int(kinds.max()) > 4:
        raise ValueError(f"PNG row filter {int(kinds.max())} is not one of "
                         "the standard's 0 to 4")
    data = raw[:, 1:]
    out = np.empty((height, width), np.uint8)
    slow = np.flatnonzero(kinds >= 3)
    first, last = ((int(slow[0]), int(slow[-1]) + 1) if slow.size
                   else (height, height))

    def rows(ys, prev):
        """None, Sub and Up rows, one at a time."""
        for y in ys:
            row = data[y]
            if kinds[y] == 1:
                row = np.cumsum(row, dtype=np.uint8)
            elif kinds[y] == 2:
                row = row + prev
            out[y] = row
            prev = out[y]
        return prev

    prev = rows(range(first), np.zeros(width, np.uint8))
    if first < last:
        _wavefront(data[first:last], kinds[first:last], prev,
                   out[first:last])
        prev = out[last - 1]
    rows(range(last, height), prev)
    return out


def unfilter_plain(raw: np.ndarray, height: int, width: int,
                   bpp: int) -> np.ndarray:
    """(height, 1 + width * bpp) filtered scanlines of ``bpp``-byte pixels
    -> (height, width, bpp) uint8, in numpy: each byte of a pixel is a
    lane that the filters treat as a one-byte image."""
    if bpp == 1:
        return _unfilter(raw, height, width)[:, :, None]
    lanes = raw[:, 1:].reshape(height, width, bpp)
    out = np.empty((height, width, bpp), np.uint8)
    for b in range(bpp):
        lane = np.empty((height, width + 1), np.uint8)
        lane[:, 0] = raw[:, 0]
        lane[:, 1:] = lanes[:, :, b]
        out[:, :, b] = _unfilter(lane, height, width)
    return out


def unfilter(raw: np.ndarray, height: int, width: int,
             bpp: int) -> np.ndarray:
    """:func:`unfilter_plain`'s result by ``csrc/png_unfilter.c``."""
    lib = native.load_library()
    raw = np.ascontiguousarray(raw, np.uint8)
    out = np.empty((height, width, bpp), np.uint8)
    row = lib.la_png_unfilter(raw.ctypes.data, height, width * bpp, bpp,
                              out.ctypes.data)
    if row:
        raise ValueError(f"PNG row filter {int(raw[row - 1, 0])} is not one "
                         "of the standard's 0 to 4")
    return out


def decode_png(data: bytes) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(image, palette (N, 3) uint8 or None) of a PNG file's bytes, the
    image as ``np.asarray(PIL.Image.open(...))`` gives it (module
    docstring)."""
    header, palette, idat = None, None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3).copy()
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    width, height, depth, colour, compression, filtering, interlace = header
    if colour not in _CHANNELS:
        raise ValueError(f"PNG colour type {colour} does not exist")
    allowed = (1, 2, 4, 8) if colour == PALETTE else (
        (1, 2, 4, 8, 16) if colour == GRAY else (8, 16))
    if depth not in allowed:
        raise ValueError(
            f"PNG bit depth {depth} is not valid for colour type {colour} "
            f"({_COLOUR_NAMES[colour]})")
    if depth < 8:
        raise ValueError(f"PNG bit depth {depth} is not read: only 8 and 16")
    if interlace not in (0, 1):
        raise ValueError(f"PNG interlaced by method {interlace}: only 0 "
                         "(none) and 1 (Adam7) exist")
    if compression != 0 or filtering != 0:
        raise ValueError(f"PNG compression {compression} / filter method "
                         f"{filtering} is not the standard's 0")
    if colour == PALETTE and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    bpp = _CHANNELS[colour] * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    passes = (_ADAM7 if interlace else ((0, 0, 1, 1),))
    sizes = [(-(-(height - y0) // dy), -(-(width - x0) // dx))
             for x0, y0, dx, dy in passes]
    need = sum(h * (1 + w * bpp) for h, w in sizes if h > 0 and w > 0)
    if raw.size != need:
        raise ValueError(f"PNG image data holds {raw.size} bytes, "
                         f"{need} expected")
    pixels = np.empty((height, width, bpp), np.uint8)
    pos = 0
    for (x0, y0, dx, dy), (h, w) in zip(passes, sizes):
        if h <= 0 or w <= 0:
            continue
        n = h * (1 + w * bpp)
        pixels[y0::dy, x0::dx] = unfilter(
            raw[pos:pos + n].reshape(h, 1 + w * bpp), h, w, bpp)
        pos += n
    if depth == 16:
        if colour == GRAY:
            return pixels.view(">u2")[:, :, 0].astype(np.uint16), None
        pixels = pixels[:, :, 0::2]         # the high byte of each sample
        if colour == GRAY_ALPHA:            # PIL reads it as RGBA
            pixels = pixels[:, :, [0, 0, 0, 1]]
    if _CHANNELS[colour] == 1:
        return pixels[:, :, 0].copy(), (palette if colour == PALETTE else None)
    return np.ascontiguousarray(pixels), None


def read_png(path: str) -> np.ndarray:
    """A PNG file's image, as :func:`decode_png` gives it."""
    with open(path, "rb") as f:
        return decode_png(f.read())[0]


def _filtered_rows(image: np.ndarray, bpp: int = 1) -> np.ndarray:
    """(5, H, W * bpp) uint8: every row under each of the five filters,
    ``bpp`` bytes a pixel."""
    x = image.reshape(image.shape[0], -1).astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])
    return ((x[None] - preds) & 255).astype(np.uint8)


def encode_png(image: np.ndarray, palette: Optional[np.ndarray] = None,
               filters: Union[None, str, int, np.ndarray] = None) -> bytes:
    """PNG bytes of a uint8 ``image``: (H, W) palette indices when a
    ``palette`` ((N, 3) uint8, N <= 256) is given, else grey levels;
    (H, W, 3) RGB. ``filters``: one filter (0 to 4) for every row, one a
    row, "adaptive" (each row the filter with the least sum of absolute
    signed bytes), or None for libpng's default: no filter for a palette
    image, "adaptive" otherwise. The data goes into one IDAT chunk."""
    image = np.asarray(image)
    rgb = image.ndim == 3 and image.shape[2] == 3 and palette is None
    if image.dtype != np.uint8 or not (image.ndim == 2 or rgb):
        raise ValueError(f"expected a (H, W) or (H, W, 3) uint8 array, got "
                         f"{image.dtype} {image.shape}")
    height, width = image.shape[:2]
    bpp = 3 if rgb else 1
    rows = _filtered_rows(image, bpp)
    if filters is None:
        filters = 0 if palette is not None else "adaptive"
    if isinstance(filters, str):
        if filters != "adaptive":
            raise ValueError(f"filters={filters!r}")
        cost = np.abs(rows.view(np.int8).astype(np.int32)).sum(axis=2)
        kinds = np.argmin(cost, axis=0)
    else:
        kinds = np.broadcast_to(np.asarray(filters, np.int64), (height,))
        if kinds.size and (kinds.min() < 0 or kinds.max() > 4):
            raise ValueError(f"row filters must be 0 to 4: {filters}")
    lines = np.empty((height, width * bpp + 1), np.uint8)
    lines[:, 0] = kinds
    lines[:, 1:] = rows[kinds, np.arange(height)]
    colour = RGB if rgb else GRAY if palette is None else PALETTE

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    parts = [SIGNATURE, chunk(b"IHDR", struct.pack(
        ">IIBBBBB", width, height, 8, colour, 0, 0, 0))]
    if palette is not None:
        palette = np.asarray(palette, np.uint8).reshape(-1, 3)
        if len(palette) > 256:
            raise ValueError(f"{len(palette)} palette entries; at most 256")
        parts.append(chunk(b"PLTE", palette.tobytes()))
    parts.append(chunk(b"IDAT", zlib.compress(lines.tobytes())))
    parts.append(chunk(b"IEND", b""))
    return b"".join(parts)


def write_png(path: str, image: np.ndarray,
              palette: Optional[np.ndarray] = None, **options) -> None:
    """Write :func:`encode_png`'s bytes to ``path``."""
    with open(path, "wb") as f:
        f.write(encode_png(image, palette, **options))


def voc_palette() -> np.ndarray:
    """PASCAL VOC's 256-entry colour map (the devkit's ``labelcolormap``:
    the bits of the index spread over the three channels)."""
    cmap = np.zeros((256, 3), np.uint8)
    for i in range(256):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap
