"""The port's JPEG decoders (``data/jpeg.py``: the C decoder on the path
and its numpy twin) against PIL, on the CPU: every committed fixture
against PIL's recorded SHA-256 (``tests/fixtures/images/pil_decoded.json``,
written by ``tests/make_image_fixtures.py``), files that PIL encodes from
seeded numpy images in each layout PIL writes, bit for bit; the features
that are refused, by name; a failed build that raises instead of falling
back to the twin; threads decoding at once."""

import hashlib
import io
import json
import os
import threading

import numpy as np
import pytest
from PIL import Image

from labelanything_tpu_torch.data import jpeg, native, png, transforms
from tests.torch_threads import one_torch_thread  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "images")
RECORD = json.load(open(os.path.join(FIXTURES, "pil_decoded.json")))
JPEGS = sorted(n for n in RECORD if n.endswith(".jpg"))


def digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("name", JPEGS)
def test_fixture_matches_pil_record(name):
    """Both decoders give PIL's bytes for the fixture, and PIL here still
    gives the recorded ones."""
    data = open(os.path.join(FIXTURES, name), "rb").read()
    rec = RECORD[name]
    with Image.open(io.BytesIO(data)) as im:
        assert digest(np.asarray(im)) == rec["sha256"]
    for decode in (jpeg.decode_jpeg, jpeg.decode_jpeg_plain):
        out = decode(data)
        assert list(out.shape) == rec["shape"] and out.dtype == np.uint8
        assert jpeg.MODES[1 if out.ndim == 2 else out.shape[2]] == rec["mode"]
        assert digest(out) == rec["sha256"], decode.__name__


def _scene(rng, h, w, channels):
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + yy) * 7 % 256, (xx * yy) % 256][:channels], -1)
    noisy = base + rng.integers(-50, 50, base.shape)
    out = np.clip(noisy, 0, 255).astype(np.uint8)
    return out[..., 0] if channels == 1 else out


ENCODINGS = [
    ("RGB", dict(quality=75)),
    ("RGB", dict(quality=97, subsampling=0)),
    ("RGB", dict(quality=40, subsampling=1)),
    ("RGB", dict(quality=90, subsampling=2, progressive=True)),
    ("RGB", dict(quality=80, optimize=True, subsampling=1)),
    ("RGB", dict(quality=85, restart_marker_blocks=3)),
    ("RGB", dict(quality=85, restart_marker_rows=1, progressive=True,
                 subsampling=0)),
    ("RGB", dict(quality=3)),
    ("RGB", dict(quality=100, subsampling=2)),
    ("L", dict(quality=75)),
    ("L", dict(quality=60, progressive=True, restart_marker_blocks=5)),
    ("CMYK", dict(quality=90)),
    ("CMYK", dict(quality=70, progressive=True)),
]


@pytest.mark.parametrize("mode,options", ENCODINGS,
                         ids=[f"{m}-{'-'.join(f'{k}{v}' for k, v in o.items())}"
                              for m, o in ENCODINGS])
def test_decoders_match_pil_on_seeded_images(mode, options):
    """Seeded images at odd, tiny and MCU-aligned sizes, encoded by PIL
    with ``options``: both decoders give ``np.asarray`` of PIL's decoding
    bit for bit."""
    rng = np.random.default_rng(ENCODINGS.index((mode, options)))
    channels = {"L": 1, "RGB": 3, "CMYK": 4}[mode]
    for h, w in [(1, 1), (2, 9), (9, 2), (17, 33), (16, 16), (40, 23)]:
        buf = io.BytesIO()
        Image.fromarray(_scene(rng, h, w, channels), mode).save(
            buf, "JPEG", **options)
        data = buf.getvalue()
        with Image.open(io.BytesIO(data)) as im:
            ref = np.asarray(im)
        np.testing.assert_array_equal(jpeg.decode_jpeg(data), ref)
        np.testing.assert_array_equal(jpeg.decode_jpeg_plain(data), ref)


def _patched(data: bytes, old: bytes, new: bytes) -> bytes:
    i = data.index(old)
    return data[:i] + new + data[i + len(old):]


def _sample_jpeg(**options) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(_scene(np.random.default_rng(0), 16, 16, 3)).save(
        buf, "JPEG", **options)
    return buf.getvalue()


@pytest.mark.parametrize("case,match", [
    ("arithmetic", "arithmetic coding"), ("lossless", "lossless"),
    ("hierarchical", "hierarchical"), ("12-bit", "12-bit"),
    ("dnl", "DNL"), ("two-components", "2 components"),
    ("sampling", "sampling factors"), ("signature", "SOI")])
def test_unsupported_features_raise_by_name(case, match):
    data = _sample_jpeg()
    sof = data.index(b"\xff\xc0")
    if case == "arithmetic":
        data = _patched(data, b"\xff\xc0", b"\xff\xc9")
    elif case == "lossless":
        data = _patched(data, b"\xff\xc0", b"\xff\xc3")
    elif case == "hierarchical":
        data = _patched(data, b"\xff\xc0", b"\xff\xc5")
    elif case == "12-bit":
        data = data[:sof + 4] + b"\x0c" + data[sof + 5:]
    elif case == "dnl":
        data = data[:sof + 5] + b"\x00\x00" + data[sof + 7:]
    elif case == "two-components":
        data = data[:sof + 9] + b"\x02" + data[sof + 10:]
    elif case == "sampling":
        # luma 4x1 against chroma 1x1: a ratio of 4
        data = data[:sof + 11] + b"\x41" + data[sof + 12:]
    else:
        data = b"\x00\x00" + data[2:]
    for decode in (jpeg.decode_jpeg, jpeg.decode_jpeg_plain):
        with pytest.raises(ValueError, match=match):
            decode(data)


def test_failed_build_raises_and_never_falls_back(monkeypatch, tmp_path):
    """With no compiler the calls into the host library (the JPEG decoder,
    the PNG unfilter, the resample) raise RuntimeError; none hands its
    work to the plain version."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "host")
    monkeypatch.setenv("CC", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(jpeg, "decode_jpeg_plain",
                        lambda data: pytest.fail("fell back to the twin"))
    monkeypatch.setattr(transforms, "resize_uint8_plain",
                        lambda *a: pytest.fail("fell back to the twin"))
    with pytest.raises(RuntimeError, match="could not be built"):
        jpeg.decode_jpeg(_sample_jpeg())
    monkeypatch.setattr(png, "unfilter_plain",
                        lambda *a: pytest.fail("fell back to the twin"))
    with pytest.raises(RuntimeError, match="could not be built"):
        transforms.resize_uint8(np.zeros((4, 6, 3), np.uint8), (8, 9))
    with pytest.raises(RuntimeError, match="could not be built"):
        png.decode_png(png.encode_png(np.zeros((4, 6), np.uint8)))


def test_threads_decode_at_once():
    """Eight threads decoding different files through the one library
    give each file's own result."""
    datas = [_sample_jpeg(quality=q, progressive=bool(q % 2))
             for q in range(60, 68)]
    expected = [jpeg.decode_jpeg(d) for d in datas]
    results = [None] * len(datas)

    def work(i):
        for _ in range(20):
            results[i] = jpeg.decode_jpeg(datas[i])

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(datas))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for got, want in zip(results, expected):
        np.testing.assert_array_equal(got, want)
