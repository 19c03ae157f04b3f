"""PNG reading and writing in numpy and the standard library's ``zlib``,
for the segmentation masks of PASCAL VOC (``SegmentationClass/*.png``):
the port's stand-in for PIL at ``labelanything_tpu/data/pascal.py``, as
``data/rle.py`` stands in for PIL's polygon fill.

Two kinds of image are read and written: 8-bit grayscale (colour type 0)
and 8-bit palette (colour type 3), not interlaced. :func:`read_png` returns
what ``np.asarray(PIL.Image.open(path))`` returns for them, a (H, W)
uint8 array: grey levels, or palette indices (not RGB). Any other colour
type, bit depth or interlace raises ``ValueError``.

Decoding undoes the five row filters of the PNG standard (section 9.2).
None, Sub and Up are whole-row operations. Average and Paeth predict each
byte from the byte to its left, so a row is a recurrence; a run of such
rows is decoded as a wavefront over anti-diagonals, each diagonal one vector
operation over the rows (a pixel depends on its left, upper and
upper-left neighbours, all on earlier diagonals).
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple, Union

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
GRAY, PALETTE = 0, 3
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
    """(height, 1 + width) filtered scanlines, filter byte first -> the
    (height, width) uint8 image (one byte a pixel).

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


def decode_png(data: bytes) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(image (H, W) uint8, palette (N, 3) uint8 or None) of a PNG file's
    bytes."""
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
    if colour not in (GRAY, PALETTE):
        raise ValueError(
            f"PNG colour type {colour} ({_COLOUR_NAMES.get(colour, '?')}) is "
            "not read: only 8-bit grayscale (0) and palette (3)")
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth} is not read: only 8")
    if interlace != 0:
        raise ValueError("interlaced (Adam7) PNG is not read")
    if compression != 0 or filtering != 0:
        raise ValueError(f"PNG compression {compression} / filter method "
                         f"{filtering} is not the standard's 0")
    if colour == PALETTE and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (width + 1):
        raise ValueError(f"PNG image data holds {raw.size} bytes, "
                         f"{height * (width + 1)} expected")
    image = _unfilter(raw.reshape(height, width + 1), height, width)
    return image, (palette if colour == PALETTE else None)


def read_png(path: str) -> np.ndarray:
    """The (H, W) uint8 grey levels or palette indices of a PNG file."""
    with open(path, "rb") as f:
        return decode_png(f.read())[0]


def _filtered_rows(image: np.ndarray) -> np.ndarray:
    """(5, H, W) uint8: every row under each of the five filters."""
    x = image.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])
    return ((x[None] - preds) & 255).astype(np.uint8)


def encode_png(image: np.ndarray, palette: Optional[np.ndarray] = None,
               filters: Union[None, str, int, np.ndarray] = None) -> bytes:
    """PNG bytes of a (H, W) uint8 ``image``: palette indices when a
    ``palette`` ((N, 3) uint8, N <= 256) is given, else grey levels.
    ``filters``: one filter (0 to 4) for every row, one a row, "adaptive"
    (each row the filter with the least sum of absolute signed bytes), or
    None for libpng's default: no filter for a palette image, "adaptive"
    for grey levels. The data goes into one IDAT chunk."""
    image = np.asarray(image)
    if image.ndim != 2 or image.dtype != np.uint8:
        raise ValueError(f"expected a (H, W) uint8 array, got "
                         f"{image.dtype} {image.shape}")
    height, width = image.shape
    rows = _filtered_rows(image)
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
    lines = np.empty((height, width + 1), np.uint8)
    lines[:, 0] = kinds
    lines[:, 1:] = rows[kinds, np.arange(height)]
    colour = GRAY if palette is None else PALETTE

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
