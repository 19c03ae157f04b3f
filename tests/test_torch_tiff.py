"""The port's TIFF reader (``data/tiff.py``) against PIL, on the CPU: the
committed fixtures against PIL's recorded SHA-256, files that PIL writes
from seeded images in every compression it writes (with and without the
horizontal predictor, gray, RGB and RGBA, several strips), the tiled and
planar layouts of ``tests/make_image_fixtures.py`` read by PIL and by the
port alike, and the refusals by tag."""

import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image

from labelanything_tpu_torch.data import tiff
from tests.make_image_fixtures import tiff_bytes
from tests.torch_threads import one_torch_thread  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "images")
RECORD = json.load(open(os.path.join(FIXTURES, "pil_decoded.json")))


def digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(n for n in RECORD
                                        if n.endswith(".tif")))
def test_fixture_matches_pil_record(name):
    out = tiff.read_tiff(os.path.join(FIXTURES, name))
    assert list(out.shape) == RECORD[name]["shape"]
    assert digest(out) == RECORD[name]["sha256"]


@pytest.mark.parametrize("compression", [None, "packbits", "tiff_lzw",
                                         "tiff_adobe_deflate"])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_reader_matches_pil_on_pil_files(compression, mode):
    rng = np.random.default_rng([len(mode), len(compression or "")])
    channels = len(mode)
    for h, w, predictor in [(1, 1, None), (7, 13, 2), (45, 31, None),
                            (64, 70, 2)]:
        smooth = np.cumsum(rng.integers(0, 9, (h, w, channels)), axis=1)
        image = (smooth % 256).astype(np.uint8)
        if channels == 1:
            image = image[..., 0]
        kw = {} if compression is None else {"compression": compression}
        if predictor:
            kw["tiffinfo"] = {317: predictor}
        buf = io.BytesIO()
        Image.fromarray(image, mode).save(buf, "TIFF", **kw)
        with Image.open(io.BytesIO(buf.getvalue())) as im:
            ref = np.asarray(im)
        np.testing.assert_array_equal(tiff.decode_tiff(buf.getvalue()), ref)


@pytest.mark.parametrize("tile,planar,deflate", [
    ((16, 16), False, False), ((16, 32), True, True), (None, True, False)])
def test_tiles_and_planes_match_pil(tile, planar, deflate):
    image = np.random.default_rng(3).integers(0, 256, (37, 41, 3),
                                              dtype=np.uint8)
    data = tiff_bytes(image, tile=tile, planar=planar, deflate=deflate)
    with Image.open(io.BytesIO(data)) as im:
        ref = np.asarray(im)
    np.testing.assert_array_equal(ref, image)
    np.testing.assert_array_equal(tiff.decode_tiff(data), ref)


def _with_tag(data: bytes, tag: int, value: int) -> bytes:
    """The file with the SHORT or LONG value of ``tag`` replaced."""
    data = bytearray(data)
    ifd, = struct.unpack("<I", data[4:8])
    count, = struct.unpack("<H", data[ifd:ifd + 2])
    for i in range(count):
        at = ifd + 2 + 12 * i
        t, kind = struct.unpack("<HH", data[at:at + 4])
        if t == tag:
            data[at + 8:at + 12] = struct.pack(
                "<HH" if kind == 3 else "<I", *((value, 0) if kind == 3
                                                else (value,)))
            return bytes(data)
    raise KeyError(tag)


@pytest.mark.parametrize("tag,value,match", [
    (259, 7, "Compression 7"), (262, 3, "PhotometricInterpretation 3"),
    (317, 3, "Predictor 3"), (266, 2, "FillOrder"),
    (284, 3, "PlanarConfiguration 3")])
def test_refusals_name_the_tag(tag, value, match):
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 5, 3), np.uint8)).save(
        buf, "TIFF", tiffinfo={317: 1, 266: 1})
    with pytest.raises(ValueError, match=match):
        tiff.decode_tiff(_with_tag(buf.getvalue(), tag, value))


def test_sixteen_bit_and_signature_refused():
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 5), np.uint16)).save(buf, "TIFF")
    with pytest.raises(ValueError, match="BitsPerSample"):
        tiff.decode_tiff(buf.getvalue())
    with pytest.raises(ValueError, match="signature"):
        tiff.decode_tiff(b"GIF89a" + buf.getvalue()[6:])
