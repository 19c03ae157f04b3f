"""A TIFF reader in numpy and the standard library's ``zlib``: the port's
stand-in for PIL at the Brain MRI test set's ``.tif`` images and masks
(``labelanything_tpu/data/crossdomain.py``).

:func:`read_tiff` returns what ``np.asarray(PIL.Image.open(path))``
returns for the first image of the file: (H, W) uint8 for 8-bit grayscale
("L"; WhiteIsZero inverted, as PIL reads it), (H, W, 3) for RGB and
(H, W, 4) for RGB with an unassociated alpha ("RGBA"). Strips and tiles,
contiguous and planar samples; no compression, PackBits, LZW and Deflate,
the last two with or without the horizontal predictor. Anything else raises a
``ValueError`` that names its tag and value.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List

import numpy as np

SIGNATURES = (b"II*\x00", b"MM\x00*")

# tag numbers and names
WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC = 256, 257, 258, 259, 262
FILL_ORDER, STRIP_OFFSETS, SAMPLES, ROWS_PER_STRIP = 266, 273, 277, 278
STRIP_BYTES, PLANAR, PREDICTOR = 279, 284, 317
TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_BYTES = 322, 323, 324, 325
EXTRA_SAMPLES, SAMPLE_FORMAT = 338, 339

NONE, LZW, DEFLATE, DEFLATE_OLD, PACKBITS = 1, 5, 8, 32946, 32773
_TYPES = {1: "B", 2: "c", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h",
          9: "i", 10: "ii", 11: "f", 12: "d", 16: "Q"}


def _ifd(data: bytes) -> Dict[int, List[int]]:
    """The first image file directory: tag -> its values."""
    if data[:4] not in SIGNATURES:
        raise ValueError("not a TIFF file (bad signature)")
    bo = "<" if data[:2] == b"II" else ">"
    offset, = struct.unpack(bo + "I", data[4:8])
    count, = struct.unpack(bo + "H", data[offset:offset + 2])
    tags: Dict[int, List[int]] = {}
    for i in range(count):
        entry = data[offset + 2 + 12 * i:offset + 14 + 12 * i]
        tag, kind, n = struct.unpack(bo + "HHI", entry[:8])
        fmt = _TYPES.get(kind)
        if fmt is None:
            continue
        size = struct.calcsize(bo + fmt) * n
        raw = entry[8:8 + size] if size <= 4 else data[
            struct.unpack(bo + "I", entry[8:12])[0]:][:size]
        tags[tag] = list(struct.unpack(bo + fmt * n, raw))
    return tags


def _lzw(data: bytes, expected: int) -> bytes:
    """TIFF's LZW (MSB-first codes, the width growing one code early)."""
    out = bytearray()
    table: List[bytes] = []
    width, bitpos, nbits = 9, 0, len(data) * 8
    prev = None
    while bitpos + width <= nbits and len(out) < expected:
        i = bitpos >> 3
        chunk = int.from_bytes(data[i:i + 3].ljust(3, b"\0"), "big")
        code = (chunk >> (24 - (bitpos & 7) - width)) & ((1 << width) - 1)
        bitpos += width
        if code == 257:
            break
        if code == 256:
            table = [bytes([b]) for b in range(256)] + [b"", b""]
            width, prev = 9, None
            continue
        if not table:
            raise ValueError("TIFF: LZW data does not start with a clear "
                             "code (old-style LZW is not read)")
        if prev is None:
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            elif code == len(table):
                entry = prev + prev[:1]
                table.append(entry)
            else:
                raise ValueError("TIFF: corrupt LZW data")
            if len(table) + 1 >= (1 << width) and width < 12:
                width += 1
        out += entry
        prev = entry
    return bytes(out)


def _packbits(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i:i + 1] * (257 - h)
            i += 1
    return bytes(out)


def read_tiff(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_tiff(f.read())


def decode_tiff(data: bytes) -> np.ndarray:
    """The first image of a TIFF file's bytes (module docstring)."""
    tags = _ifd(data)

    def one(tag, default=None):
        v = tags.get(tag)
        if v is None:
            if default is None:
                raise ValueError(f"TIFF: required tag {tag} is missing")
            return default
        return v[0]

    width, height = one(WIDTH), one(LENGTH)
    spp = one(SAMPLES, 1)
    bits = tags.get(BITS, [1] * spp)
    if any(b != 8 for b in bits):
        raise ValueError(f"TIFF: BitsPerSample {bits} is not read: 8 only")
    compression = one(COMPRESSION, NONE)
    if compression not in (NONE, LZW, DEFLATE, DEFLATE_OLD, PACKBITS):
        raise ValueError(f"TIFF: Compression {compression} is not read "
                         "(none, PackBits, LZW and Deflate only)")
    photometric = one(PHOTOMETRIC)
    planar = one(PLANAR, 1)
    predictor = one(PREDICTOR, 1)
    if predictor not in (1, 2):
        raise ValueError(f"TIFF: Predictor {predictor} is not read "
                         "(none and horizontal only)")
    if one(FILL_ORDER, 1) != 1:
        raise ValueError("TIFF: FillOrder 2 is not read")
    if any(f != 1 for f in tags.get(SAMPLE_FORMAT, [1])):
        raise ValueError(f"TIFF: SampleFormat {tags[SAMPLE_FORMAT]} is not "
                         "read: unsigned integers only")
    extra = tags.get(EXTRA_SAMPLES, [])
    if photometric in (0, 1) and spp == 1:
        pass
    elif photometric == 2 and spp == 3:
        pass
    elif photometric == 2 and spp == 4 and extra == [2]:
        pass
    else:
        raise ValueError(
            f"TIFF: PhotometricInterpretation {photometric} with "
            f"SamplesPerPixel {spp} and ExtraSamples {extra} is not read "
            "(8-bit grayscale, RGB and RGB with unassociated alpha only)")
    if planar not in (1, 2):
        raise ValueError(f"TIFF: PlanarConfiguration {planar} is not read")

    def inflate(raw: bytes, expected: int) -> np.ndarray:
        if compression == NONE:
            out = raw
        elif compression == PACKBITS:
            out = _packbits(raw)
        elif compression == LZW:
            out = _lzw(raw, expected)
        else:
            out = zlib.decompress(raw)
        buf = np.frombuffer(out, np.uint8)
        if buf.size < expected:   # a short block: PIL fills with zeros
            buf = np.concatenate([buf, np.zeros(expected - buf.size,
                                                np.uint8)])
        return buf[:expected]

    def unpredict(block: np.ndarray) -> np.ndarray:
        """(rows, cols, samples): undo horizontal differencing (libtiff
        applies a predictor in its LZW and Deflate codecs only)."""
        if predictor == 2 and compression in (LZW, DEFLATE, DEFLATE_OLD):
            block = np.cumsum(block, axis=1, dtype=np.uint8)
        return block

    per_block = spp if planar == 1 else 1
    planes = 1 if planar == 1 else spp
    image = np.zeros((planes, height, width, per_block), np.uint8)
    if TILE_WIDTH in tags:
        tw, th = one(TILE_WIDTH), one(TILE_LENGTH)
        offsets, counts = tags[TILE_OFFSETS], tags[TILE_BYTES]
        across, down = -(-width // tw), -(-height // th)
        i = 0
        for p in range(planes):
            for ty in range(down):
                for tx in range(across):
                    raw = data[offsets[i]:offsets[i] + counts[i]]
                    block = unpredict(inflate(raw, tw * th * per_block)
                                      .reshape(th, tw, per_block))
                    y0, x0 = ty * th, tx * tw
                    h, w = min(th, height - y0), min(tw, width - x0)
                    image[p, y0:y0 + h, x0:x0 + w] = block[:h, :w]
                    i += 1
    else:
        rps = min(one(ROWS_PER_STRIP, height), height)
        offsets, counts = tags[STRIP_OFFSETS], tags[STRIP_BYTES]
        strips = -(-height // rps)
        for p in range(planes):
            for s in range(strips):
                i = p * strips + s
                rows = min(rps, height - s * rps)
                raw = data[offsets[i]:offsets[i] + counts[i]]
                image[p, s * rps:s * rps + rows] = unpredict(
                    inflate(raw, rows * width * per_block)
                    .reshape(rows, width, per_block))
    out = (image[0] if planar == 1
           else np.ascontiguousarray(image[:, :, :, 0].transpose(1, 2, 0)))
    if spp == 1:
        out = out[:, :, 0]
        if photometric == 0:
            out = 255 - out
    return np.ascontiguousarray(out)
