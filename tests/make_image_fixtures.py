"""Writes ``tests/fixtures/images/``: JPEG, TIFF and PNG files that the
port's decoders (``labelanything_tpu_torch/data/{jpeg,tiff,png}.py``) are
held to, and ``pil_decoded.json``, PIL's reading of each: the mode, the
shape and the SHA-256 of ``np.asarray(Image.open(path))`` and of its
``convert("RGB")``.

Most files are PIL's own (JPEG at COCO sizes and odd sizes, 4:4:4,
4:2:2 and 4:2:0, gray, progressive, restart markers, optimised tables,
CMYK with the Adobe marker; TIFF in every compression PIL writes; PNG
colour types). The layouts PIL does not write (JPEG at 4:4:0 or with
Adobe's RGB transform, tiled and planar TIFF, Adam7 and 16-bit colour PNG)
come from the small writers below, and PIL's decoding of them is the
record all the same.

    python tests/make_image_fixtures.py

It needs PIL; run it once where PIL is installed and commit the output.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np
from PIL import Image

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                   "images")


def scene(h: int, w: int, seed: int, channels: int = 3) -> np.ndarray:
    """A photo-like uint8 image: gradients, a few discs and mild noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    chans = []
    for c in range(channels):
        a, b = rng.uniform(-1, 1, 2)
        v = 128 + 90 * np.sin(a * xx / max(w, 1) * 6 + b * yy / max(h, 1) * 6
                              + c)
        for _ in range(4):
            cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), \
                rng.uniform(2, max(h, w) / 3 + 3)
            v = np.where((yy - cy) ** 2 + (xx - cx) ** 2 < r * r,
                         rng.uniform(0, 255), v)
        chans.append(v + rng.normal(0, 6, (h, w)))
    out = np.clip(np.stack(chans, -1), 0, 255).astype(np.uint8)
    return out[..., 0] if channels == 1 else out


# ---- a baseline JPEG writer for sampling layouts PIL does not write ---------- #

_ZZ = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12,
                19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35,
                42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62,
                63])
_Q = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60,
               55, 14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80,
               62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104,
               113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98,
               112, 100, 103, 99])
# JPEG Annex K.3: the typical luminance DC and AC tables
_DC_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
_DC_VALS = list(range(12))
_AC_BITS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
_AC_VALS = [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA]


def _codes(bits, vals):
    table, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            table[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return table


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def encode_baseline(planes, factors, adobe_transform=None) -> bytes:
    """A baseline JPEG of the component ``planes`` (each (H, W) uint8 at
    full size, already in the colour space to store), ``factors`` the (h,
    v) sampling factors; a component of lower factors is averaged down.
    One quantization table and the Annex K luminance Huffman tables for
    every component. Adobe's APP14 marker with ``adobe_transform`` when
    given, else JFIF's APP0."""
    height, width = planes[0].shape
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    n = np.arange(8)
    dct = np.sqrt(2 / 8) * np.cos((2 * n[None, :] + 1) * n[:, None]
                                  * np.pi / 16)
    dct[0] /= np.sqrt(2)
    blocks = []
    for plane, (h, v) in zip(planes, factors):
        fy, fx = vmax // v, hmax // h
        full_h, full_w = mcuy * vmax * 8, mcux * hmax * 8
        x = np.pad(plane.astype(np.float64),
                   ((0, full_h - height), (0, full_w - width)), mode="edge")
        x = x.reshape(full_h // fy, fy, full_w // fx, fx).mean(axis=(1, 3))
        b = x.reshape(x.shape[0] // 8, 8, x.shape[1] // 8, 8).transpose(
            0, 2, 1, 3) - 128
        coef = dct @ b @ dct.T
        blocks.append(np.round(coef.reshape(*coef.shape[:2], 64) / _Q)
                      .astype(np.int64)[..., _ZZ])
    dc, ac = _codes(_DC_BITS, _DC_VALS), _codes(_AC_BITS, _AC_VALS)
    bits, nbits, out = 0, 0, bytearray()

    def put(value: int, length: int) -> None:
        nonlocal bits, nbits
        bits = (bits << length) | (value & ((1 << length) - 1))
        nbits += length
        while nbits >= 8:
            byte = (bits >> (nbits - 8)) & 255
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
            nbits -= 8

    def magnitude(v: int):
        s = int(abs(v)).bit_length()
        return s, (v if v >= 0 else v + (1 << s) - 1)

    preds = [0] * len(planes)
    for my in range(mcuy):
        for mx in range(mcux):
            for c, (h, v) in enumerate(factors):
                for by in range(v):
                    for bx in range(h):
                        blk = blocks[c][my * v + by, mx * h + bx]
                        s, bitsv = magnitude(int(blk[0]) - preds[c])
                        preds[c] = int(blk[0])
                        put(*dc[s])
                        put(bitsv, s)
                        run = 0
                        for k in range(1, 64):
                            if blk[k] == 0:
                                run += 1
                                continue
                            while run > 15:
                                put(*ac[0xF0])
                                run -= 16
                            s, bitsv = magnitude(int(blk[k]))
                            put(*ac[(run << 4) | s])
                            put(bitsv, s)
                            run = 0
                        if run:
                            put(*ac[0x00])
    if nbits:
        put((1 << (8 - nbits)) - 1, 8 - nbits)
    head = b"\xff\xd8"
    if adobe_transform is None:
        head += _segment(0xFFE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    else:
        head += _segment(0xFFEE, b"Adobe\0\x64\0\0\0\0"
                         + bytes([adobe_transform]))
    head += _segment(0xFFDB, b"\0" + bytes(_Q[_ZZ].tolist()))
    head += _segment(0xFFC0, struct.pack(">BHHB", 8, height, width,
                                         len(planes)) + b"".join(
        bytes([c + 1, (h << 4) | v, 0]) for c, (h, v) in enumerate(factors)))
    head += _segment(0xFFC4, b"\x00" + bytes(_DC_BITS) + bytes(_DC_VALS))
    head += _segment(0xFFC4, b"\x10" + bytes(_AC_BITS) + bytes(_AC_VALS))
    head += _segment(0xFFDA, bytes([len(planes)]) + b"".join(
        bytes([c + 1, 0]) for c in range(len(planes))) + b"\x00\x3f\x00")
    return head + bytes(out) + b"\xff\xd9"


def ycbcr(rgb: np.ndarray):
    x = rgb.astype(np.float64)
    y = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    cb = 128 - 0.168736 * x[..., 0] - 0.331264 * x[..., 1] + 0.5 * x[..., 2]
    cr = 128 + 0.5 * x[..., 0] - 0.418688 * x[..., 1] - 0.081312 * x[..., 2]
    return [np.clip(np.round(c), 0, 255).astype(np.uint8) for c in (y, cb, cr)]


# ---- TIFF and PNG layouts PIL does not write ---------------------------------- #

def tiff_bytes(image: np.ndarray, tile=None, planar=False,
               deflate=False) -> bytes:
    """A little-endian TIFF of an (H, W, 3) uint8 image: tiles of ``tile``
    (th, tw) or one strip, samples contiguous or planar, raw or Deflate."""
    h, w, spp = image.shape
    th, tw = tile or (h, w)
    planes = ([image[..., c:c + 1] for c in range(spp)] if planar
              else [image])
    blocks = []
    for p in planes:
        for ty in range(-(-h // th)):
            for tx in range(-(-w // tw) if tile else 1):
                b = np.zeros((th, tw, p.shape[2]), np.uint8)
                part = p[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw]
                b[:part.shape[0], :part.shape[1]] = part
                raw = b.tobytes() if tile else part.tobytes()
                blocks.append(zlib.compress(raw) if deflate else raw)
    data = bytearray(b"II*\0" + struct.pack("<I", 0))
    offsets = []
    for b in blocks:
        offsets.append(len(data))
        data += b
    bps_off = len(data)
    data += struct.pack("<HHH", 8, 8, 8)
    offs_off = len(data)
    data += struct.pack(f"<{len(offsets)}I", *offsets)
    cnts_off = len(data)
    data += struct.pack(f"<{len(blocks)}I", *[len(b) for b in blocks])
    entries = [(256, 3, 1, w), (257, 3, 1, h), (258, 3, 3, bps_off),
               (259, 3, 1, 8 if deflate else 1), (262, 3, 1, 2),
               (277, 3, 1, spp), (284, 3, 1, 2 if planar else 1)]
    if tile:
        entries += [(322, 3, 1, tw), (323, 3, 1, th),
                    (324, 4, len(offsets), offs_off),
                    (325, 4, len(blocks), cnts_off)]
    else:
        entries += [(273, 4, len(offsets), offs_off), (278, 3, 1, h),
                    (279, 4, len(blocks), cnts_off)]
    entries.sort()
    ifd = len(data)
    data += struct.pack("<H", len(entries))
    for tag, kind, count, value in entries:
        if count == 1 and kind == 3:
            data += struct.pack("<HHIHH", tag, kind, count, value, 0)
        elif count == 1:
            data += struct.pack("<HHII", tag, kind, count, value)
        else:
            data += struct.pack("<HHII", tag, kind, count, value)
    data += struct.pack("<I", 0)
    data[4:8] = struct.pack("<I", ifd)
    return bytes(data)


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def png_bytes(image: np.ndarray, colour: int, depth: int = 8,
              interlace: bool = False, palette=None, seed: int = 0) -> bytes:
    """A PNG of ``image`` ((H, W) or (H, W, C), uint8 or big-endian uint16
    samples), each scanline under a filter drawn from ``seed``, Adam7
    when ``interlace``."""
    rng = np.random.default_rng(seed)
    h, w = image.shape[:2]
    px = image.reshape(h, w, -1)
    raw = px.astype(">u2").view(np.uint8) if depth == 16 else px
    raw = raw.reshape(h, w, -1)
    bpp = raw.shape[2]
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    body = bytearray()
    for x0, y0, dx, dy in passes:
        sub = raw[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = sub.reshape(sub.shape[0], -1).astype(np.int64)
        prev = np.zeros(rows.shape[1], np.int64)
        for row in rows:
            kind = int(rng.integers(0, 5))
            a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
            c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
            b = prev
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            paeth = np.where((pa <= pb) & (pa <= pc), a,
                             np.where(pb <= pc, b, c))
            pred = [np.zeros_like(row), a, b, (a + b) // 2, paeth][kind]
            body.append(kind)
            body += ((row - pred) % 256).astype(np.uint8).tobytes()
            prev = row

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    parts = [b"\x89PNG\r\n\x1a\n", chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, colour, 0, 0, int(interlace)))]
    if palette is not None:
        parts.append(chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    parts += [chunk(b"IDAT", zlib.compress(bytes(body))), chunk(b"IEND", b"")]
    return b"".join(parts)


def fixtures():
    """(file name, bytes) of every fixture."""
    files = []

    def pil(name, image, fmt, **kw):
        buf = io.BytesIO()
        image.save(buf, fmt, **kw)
        files.append((name, buf.getvalue()))

    rgb = lambda h, w, s: Image.fromarray(scene(h, w, s))  # noqa: E731
    pil("coco_portrait_427x640_420.jpg", rgb(640, 427, 1), "JPEG", quality=75)
    pil("coco_640x480_420.jpg", rgb(480, 640, 2), "JPEG", quality=90)
    pil("odd_33x17_444.jpg", rgb(17, 33, 3), "JPEG", quality=95,
        subsampling=0)
    pil("odd_45x31_422.jpg", rgb(31, 45, 4), "JPEG", quality=60,
        subsampling=1)
    pil("odd_37x29_420.jpg", rgb(29, 37, 5), "JPEG", quality=80,
        subsampling=2)
    pil("tiny_3x2_420.jpg", rgb(2, 3, 6), "JPEG", quality=85)
    pil("gray_50x70.jpg", Image.fromarray(scene(70, 50, 7, 1)), "JPEG",
        quality=85)
    pil("progressive_95x61_420.jpg", rgb(61, 95, 8), "JPEG", quality=88,
        progressive=True)
    pil("progressive_gray_41x23.jpg", Image.fromarray(scene(23, 41, 9, 1)),
        "JPEG", quality=70, progressive=True)
    pil("restart_75x41_420.jpg", rgb(41, 75, 10), "JPEG", quality=80,
        restart_marker_blocks=2)
    pil("restart_progressive_64x40_444.jpg", rgb(40, 64, 11), "JPEG",
        quality=92, subsampling=0, progressive=True, restart_marker_rows=1)
    pil("optimized_66x48_420.jpg", rgb(48, 66, 12), "JPEG", quality=75,
        optimize=True)
    pil("cmyk_adobe_40x30.jpg", Image.fromarray(scene(30, 40, 13, 4), "CMYK"),
        "JPEG", quality=90)
    for (h, w), seed in (((480, 640), 21), ((640, 427), 22)):
        # Kvasir-style masks for the COCO-sized images: polyp at 255
        yy, xx = np.mgrid[0:h, 0:w]
        rng = np.random.default_rng(seed)
        cy, cx = rng.uniform(0.3, 0.7, 2) * (h, w)
        blob = ((yy - cy) / (0.2 * h)) ** 2 + ((xx - cx) / (0.25 * w)) ** 2 < 1
        pil(f"mask_{w}x{h}.jpg", Image.fromarray(blob.astype(np.uint8) * 255),
            "JPEG", quality=90)
    y, cb, cr = ycbcr(scene(27, 35, 14))
    files.append(("sampling_440_35x27.jpg",
                  encode_baseline([y, cb, cr], [(1, 2), (1, 1), (1, 1)])))
    files.append(("sampling_h2v2_chroma_full_22x19.jpg",
                  encode_baseline([y[:19, :22], cb[:19, :22], cr[:19, :22]],
                                  [(2, 2), (2, 1), (1, 2)])))
    r = scene(16, 24, 15)
    files.append(("adobe_rgb_24x16.jpg", encode_baseline(
        [r[..., 0], r[..., 1], r[..., 2]], [(1, 1)] * 3, adobe_transform=0)))

    t = scene(36, 40, 16)
    for comp, pred in [(None, None), ("packbits", None), ("tiff_lzw", 2),
                       ("tiff_adobe_deflate", 2), ("tiff_lzw", None)]:
        kw = {} if comp is None else {"compression": comp}
        if pred:
            kw["tiffinfo"] = {317: pred}
        name = f"brain_{comp or 'raw'}{'_pred' if pred else ''}.tif"
        pil(name, Image.fromarray(t), "TIFF", **kw)
    pil("brain_mask_lzw.tif", Image.fromarray(
        (scene(36, 40, 17, 1) > 127).astype(np.uint8) * 255), "TIFF",
        compression="tiff_lzw")
    files.append(("tiled_planar_deflate.tif",
                  tiff_bytes(scene(37, 41, 18), tile=(16, 16), planar=True,
                             deflate=True)))
    files.append(("tiled_raw.tif", tiff_bytes(scene(30, 34, 19),
                                              tile=(16, 32))))

    p = scene(23, 29, 20)
    pil("rgb.png", Image.fromarray(p), "PNG")
    pil("rgba.png", Image.fromarray(np.dstack([p, p[..., 0]]), "RGBA"), "PNG")
    pil("gray_alpha.png", Image.fromarray(np.dstack([p[..., 1], p[..., 2]]),
                                          "LA"), "PNG")
    pil("gray16.png", Image.fromarray(p[..., 0].astype(np.uint16) * 257),
        "PNG")
    files.append(("rgb_adam7.png", png_bytes(p, 2, interlace=True, seed=1)))
    files.append(("rgb16.png", png_bytes(p.astype(np.uint16) * 251 + 7, 2,
                                         depth=16, seed=2)))
    files.append(("rgba16_adam7.png", png_bytes(
        np.dstack([p, p[..., :1]]).astype(np.uint16) * 257, 6, depth=16,
        interlace=True, seed=3)))
    files.append(("palette_adam7.png", png_bytes(
        p[..., 0] % 21, 3, interlace=True, seed=4,
        palette=np.arange(63).reshape(21, 3) * 4)))
    return files


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main() -> None:
    os.makedirs(OUT, exist_ok=True)
    record = {}
    for name, data in fixtures():
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        with Image.open(io.BytesIO(data)) as im:
            arr = np.asarray(im)
            rgb = np.asarray(im.convert("RGB"))
            record[name] = {"mode": im.mode, "shape": list(arr.shape),
                            "dtype": str(arr.dtype), "sha256": digest(arr),
                            "rgb_sha256": digest(rgb)}
    with open(os.path.join(OUT, "pil_decoded.json"), "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
    total = sum(os.path.getsize(os.path.join(OUT, n)) for n in os.listdir(OUT))
    print(f"{len(record)} fixtures, {total} bytes in {OUT}")


if __name__ == "__main__":
    main()
