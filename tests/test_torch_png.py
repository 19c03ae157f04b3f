"""The port's PNG reader and writer (``data/png.py``) against PIL, on the
CPU: 8-bit grayscale and palette files whose rows take each of the five
filters (written by a scalar encoder in this file, one byte at a time as
the PNG standard states the filters) and files that PIL writes, at odd
widths and several IDAT chunks, read bit for bit as
``np.asarray(Image.open(path))`` reads them; colour, grey + alpha and
16-bit files, plain and Adam7-interlaced, likewise; the C unfilter
against its numpy twin; the writer's files read back and read by PIL
alike; the kinds the reader refuses."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from labelanything_tpu_torch.data import png
from tests.torch_threads import one_torch_thread  # noqa: F401

SHAPES = [(1, 1), (1, 7), (5, 1), (13, 31), (40, 33), (64, 65)]


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _scalar_png(image: np.ndarray, kinds, palette=None,
                idat_size: int = 64) -> bytes:
    """A PNG file whose row ``y`` takes filter ``kinds[y]``, each byte
    filtered as the standard states it (section 9.2)."""
    h, w = image.shape
    raw = bytearray()
    for y in range(h):
        raw.append(int(kinds[y]))
        for x in range(w):
            v = int(image[y, x])
            a = int(image[y, x - 1]) if x else 0
            b = int(image[y - 1, x]) if y else 0
            c = int(image[y - 1, x - 1]) if x and y else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][int(kinds[y])]
            raw.append((v - pred) % 256)

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    body = zlib.compress(bytes(raw))
    out = [png.SIGNATURE, chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, 0 if palette is None else 3, 0, 0, 0))]
    if palette is not None:
        out.append(chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    out += [chunk(b"IDAT", body[i:i + idat_size])
            for i in range(0, len(body), idat_size)]
    out.append(chunk(b"IEND", b""))
    return b"".join(out)


def _pil_read(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im)


def _image(rng, h, w, kind):
    """Noise, or a mask of flat regions (VOC-like: classes 0 to 20, 255)."""
    if kind == "noise":
        return rng.integers(0, 256, (h, w), dtype=np.uint8)
    seg = np.zeros((h, w), np.uint8)
    for c in rng.integers(1, 21, 3):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        seg[y0:y0 + h // 2 + 1, x0:x0 + w // 2 + 1] = c
    seg[rng.random((h, w)) < 0.05] = 255
    return seg


@pytest.mark.parametrize("colour", ["gray", "palette"])
@pytest.mark.parametrize("rows", [0, 1, 2, 3, 4, "mixed"])
def test_reader_matches_pil_on_each_filter(colour, rows):
    """Every row under one filter (or a random filter a row), each shape,
    noise and flat masks: the port reads what PIL reads, and the array
    written."""
    rng = np.random.default_rng([colour == "palette", 5 if rows == "mixed"
                                 else rows])
    palette = png.voc_palette() if colour == "palette" else None
    idats = []
    for h, w in SHAPES:
        for kind in ("noise", "mask"):
            image = _image(rng, h, w, kind)
            kinds = (rng.integers(0, 5, h) if rows == "mixed"
                     else np.full(h, rows))
            data = _scalar_png(image, kinds, palette)
            idats.append(sum(k == b"IDAT" for k, _ in png._chunks(data)))
            got, got_palette = png.decode_png(data)
            ref = _pil_read(data)
            assert got.dtype == ref.dtype == np.uint8
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(got, image)
            if palette is not None:
                np.testing.assert_array_equal(got_palette, palette)
            else:
                assert got_palette is None
    assert max(idats) > 1  # the data split across several IDATs


@pytest.mark.parametrize("mode", ["L", "P"])
def test_reader_matches_pil_on_pil_files(mode, tmp_path):
    """Files that PIL writes (its own filter choice and chunking), read
    from disk by ``read_png``."""
    rng = np.random.default_rng(3)
    for i, (h, w) in enumerate(SHAPES + [(375, 500), (500, 375)]):
        image = _image(rng, h, w, "noise" if i % 2 else "mask")
        im = Image.fromarray(image, mode=mode)
        if mode == "P":
            im.putpalette(png.voc_palette().ravel().tolist())
        path = tmp_path / f"{i}.png"
        im.save(path)
        with Image.open(path) as ref:
            assert ref.mode == mode
            expected = np.asarray(ref)
        np.testing.assert_array_equal(png.read_png(str(path)), expected)
        np.testing.assert_array_equal(expected, image)


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "adaptive", "per_row"])
def test_writer_round_trip_and_pil_reads_it(filters, tmp_path):
    """The writer's files read back by the port and by PIL as the array
    written, grayscale and palette (split IDATs are the reader tests'
    files, written by ``_scalar_png``)."""
    rng = np.random.default_rng(7)
    for i, (h, w) in enumerate(SHAPES):
        image = _image(rng, h, w, "noise" if i % 2 else "mask")
        rows = rng.integers(0, 5, h) if filters == "per_row" else filters
        for palette in (None, png.voc_palette()):
            data = png.encode_png(image, palette, filters=rows)
            np.testing.assert_array_equal(png.decode_png(data)[0], image)
            with Image.open(io.BytesIO(data)) as im:
                assert im.mode == ("L" if palette is None else "P")
                np.testing.assert_array_equal(np.asarray(im), image)
                if palette is not None:
                    np.testing.assert_array_equal(
                        np.asarray(im.getpalette(), np.uint8).reshape(-1, 3),
                        palette)
    path = tmp_path / "mask.png"
    png.write_png(str(path), image, png.voc_palette(), filters=rows)
    np.testing.assert_array_equal(png.read_png(str(path)), image)


def test_adaptive_writer_takes_every_filter():
    """The adaptive rule (least sum of absolute signed bytes) picks more
    than one filter on a mask, so the round trip covers their mix."""
    rng = np.random.default_rng(11)
    data = png.encode_png(_image(rng, 64, 65, "mask"), filters="adaptive")
    raw = zlib.decompress(b"".join(
        p for k, p in png._chunks(data) if k == b"IDAT"))
    kinds = np.frombuffer(raw, np.uint8).reshape(64, 66)[:, 0]
    assert len(set(kinds.tolist())) >= 2


def _with_header(image: np.ndarray, depth: int, colour: int,
                 interlace: int = 0) -> bytes:
    """The writer's file of ``image`` with IHDR's bit depth, colour type
    and interlace bytes set, its CRC redone."""
    data = bytearray(png.encode_png(image))
    data[24], data[25], data[28] = depth, colour, interlace
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    return bytes(data)


@pytest.mark.parametrize("mode,match", [
    ("RGB", "colour type 2"), ("RGBA", "colour type 6"), ("LA", "colour type 4"),
    ("1", "bit depth 1"), ("I;16", "bit depth 16"), ("interlaced", "interlaced"),
    ("crc", "CRC"), ("signature", "signature")])
def test_reader_refuses_other_kinds(mode, match):
    """What the reader refuses: bit depths below 8 and the combinations
    the standard does not allow (RGB, RGBA and grey + alpha below 8 bits,
    16-bit palette images), an interlace method other than none and
    Adam7, a bad CRC or signature."""
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (9, 11), dtype=np.uint8)
    buf = io.BytesIO()
    if mode == "RGB":
        buf.write(_with_header(image, 4, 2))
    elif mode == "RGBA":
        buf.write(_with_header(image, 2, 6))
    elif mode == "LA":
        buf.write(_with_header(image, 1, 4))
    elif mode == "1":
        Image.fromarray(image > 127).save(buf, format="PNG")
    elif mode == "I;16":
        buf.write(_with_header(image, 16, 3))
    elif mode == "interlaced":
        buf.write(_with_header(image, 8, 0, interlace=2))
    elif mode == "crc":
        data = bytearray(png.encode_png(image))
        data[20] ^= 1
        buf.write(bytes(data))
    else:
        buf.write(b"GIF89a" + png.encode_png(image)[6:])
    with pytest.raises(ValueError, match=match):
        png.decode_png(buf.getvalue())


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "LA", "I;16"])
def test_reader_matches_pil_on_colour_files(mode, tmp_path):
    """Colour, grey + alpha and 16-bit grey files that PIL writes, read
    as ``np.asarray(Image.open(path))`` reads them."""
    rng = np.random.default_rng(len(mode))
    for i, (h, w) in enumerate(SHAPES + [(120, 97)]):
        if mode == "I;16":
            image = rng.integers(0, 65536, (h, w)).astype(np.uint16)
        else:
            image = _image(rng, h, w * len(mode), "noise" if i % 2
                           else "mask").reshape(h, w, len(mode))
        path = tmp_path / f"{i}.png"
        Image.fromarray(image).save(path)
        with Image.open(path) as ref:
            expected = np.asarray(ref)
        got = png.read_png(str(path))
        assert got.dtype == expected.dtype
        np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("colour,depth", [(0, 8), (0, 16), (2, 8), (2, 16),
                                          (3, 8), (4, 8), (4, 16), (6, 8),
                                          (6, 16)])
@pytest.mark.parametrize("interlace", [False, True])
def test_reader_matches_pil_on_every_layout(colour, depth, interlace):
    """Every colour type at 8 and 16 bits, plain and Adam7, each row under
    a seeded filter (``tests/make_image_fixtures.png_bytes``), at sizes
    where some Adam7 passes are empty."""
    from tests.make_image_fixtures import png_bytes

    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    rng = np.random.default_rng([colour, depth, interlace])
    for h, w in [(1, 1), (3, 2), (9, 13), (17, 8)]:
        top = 256 if depth == 8 else 65536
        image = rng.integers(0, 21 if colour == 3 else top,
                             (h, w, channels)).astype(
            np.uint8 if depth == 8 else np.uint16)
        data = png_bytes(image[..., 0] if channels == 1 else image, colour,
                         depth=depth, interlace=interlace, seed=h * w,
                         palette=(np.arange(63).reshape(21, 3) * 4
                                  if colour == 3 else None))
        with Image.open(io.BytesIO(data)) as ref:
            expected = np.asarray(ref)
        got = png.decode_png(data)[0]
        assert got.dtype == expected.dtype
        np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_c_unfilter_matches_the_numpy_twin(bpp):
    """``unfilter`` (C) against ``unfilter_plain`` (the numpy wavefront)
    on random scanlines, every row a random filter, at widths of one pixel
    and more; a filter byte past 4 is refused by both."""
    rng = np.random.default_rng(bpp)
    for h, w in [(1, 1), (3, 1), (1, 9), (17, 23), (40, 64)]:
        raw = rng.integers(0, 256, (h, 1 + w * bpp), dtype=np.uint8)
        raw[:, 0] = rng.integers(0, 5, h)
        np.testing.assert_array_equal(png.unfilter(raw, h, w, bpp),
                                      png.unfilter_plain(raw, h, w, bpp))
    raw[-1, 0] = 5
    for fn in (png.unfilter, png.unfilter_plain):
        with pytest.raises(ValueError, match="0 to 4"):
            fn(raw, h, w, bpp)


def test_writer_refuses_bad_input():
    with pytest.raises(ValueError, match="uint8"):
        png.encode_png(np.zeros((4, 4), np.int32))
    with pytest.raises(ValueError, match="0 to 4"):
        png.encode_png(np.zeros((4, 4), np.uint8), filters=5)
    with pytest.raises(ValueError, match="256"):
        png.encode_png(np.zeros((4, 4), np.uint8), np.zeros((300, 3)))


def test_voc_palette_is_the_devkit_map():
    """The devkit's first entries (background black, aeroplane dark red,
    ...) and the void colour at 255."""
    cmap = png.voc_palette()
    assert cmap[:4].tolist() == [[0, 0, 0], [128, 0, 0], [0, 128, 0],
                                 [128, 128, 0]]
    assert cmap[15].tolist() == [192, 128, 128]
    assert cmap[255].tolist() == [224, 224, 192]
