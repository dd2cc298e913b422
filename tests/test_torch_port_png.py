"""The port's PNG codec (sr3_tpu_torch/utils/png.py) and the image I/O that
falls back to it (sr3_tpu_torch/utils/metrics.py) against Pillow and cv2.

PNG is lossless, so every route must give the same pixels: every committed
fixture PNG (16^2 to 512^2) decodes equal to Pillow's; PNGs whose rows this
test filters itself, one per filter type and color type, decode equal to
Pillow's; the codec's own writes decode equal through Pillow and cv2; and
without cv2 and Pillow the image I/O reads and writes PNG and refuses what
the codec cannot read, naming it.
"""

import glob
import io
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

import sr3_tpu_torch.utils.metrics as Metrics
from sr3_tpu_torch.utils import png

REPO = os.path.join(os.path.dirname(__file__), "..")
FIXTURES = sorted(glob.glob(os.path.join(REPO, "dataset", "fixtures_*", "*",
                                         "*.png")))


def _pillow(src):
    with Image.open(src) as img:
        return np.asarray(img.convert("RGB"))


def test_fixture_pngs_decode_as_pillow():
    """The three routes of Metrics.load_img: the codec, Pillow, cv2."""
    sides = set()
    for path in FIXTURES:
        got = png.to_rgb(png.decode(path))
        assert np.array_equal(got, _pillow(path)), path
        assert np.array_equal(got, Metrics.load_img(path)), path  # cv2
        sides.add(got.shape[0])
    assert {16, 128, 512} <= sides


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_rows(img, kinds):
    """Scanlines of ``img`` (H, W, C) uint8, row y filtered by kinds[y],
    byte by byte as the PNG specification defines the filters."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(int)
    out = bytearray()
    for y in range(h):
        out.append(kinds[y])
        for x in range(w * c):
            a = rows[y, x - c] if x >= c else 0
            b = rows[y - 1, x] if y else 0
            cc = rows[y - 1, x - c] if y and x >= c else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, cc))[kinds[y]]
            out.append((rows[y, x] - pred) % 256)
    return bytes(out)


def _png(img, color, kinds, interlace=0):
    h, w, _ = img.shape

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0,
                                          interlace))
            + chunk(b"IDAT", zlib.compress(_filter_rows(img, kinds)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("color", [0, 2, 4, 6])
def test_every_filter_and_color_type_decodes_as_pillow(kind, color):
    h, w, c = 13, 11, png.CHANNELS[color]
    img = np.random.default_rng(c).integers(0, 256, (h, w, c), np.uint8)
    kinds = [y % 5 for y in range(h)] if kind == "mixed" else [kind] * h
    data = _png(img, color, kinds)
    got = png.decode(data)
    assert got.dtype == np.uint8 and np.array_equal(got, img)
    with Image.open(io.BytesIO(data)) as ref:
        assert np.array_equal(png.to_rgb(got), np.asarray(ref.convert("RGB")))


def test_writes_decode_through_pillow_and_cv2(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (37, 20, 3), np.uint8)
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(png.encode(img))
    assert np.array_equal(_pillow(path), img)
    assert np.array_equal(cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB),
                          img)
    assert np.array_equal(png.decode(path), img)


@pytest.fixture()
def no_libraries(monkeypatch):
    """The card's machine: neither cv2 nor Pillow."""
    monkeypatch.setattr(Metrics, "_cv2", lambda: None)
    monkeypatch.setattr(Metrics, "_pil_image", lambda: None)


def test_image_io_without_cv2_or_pillow(tmp_path, no_libraries):
    img = np.random.default_rng(1).integers(0, 256, (16, 24, 3), np.uint8)
    path = str(tmp_path / "a.png")
    Metrics.save_img(img, path)
    assert np.array_equal(_pillow(path), img)
    assert np.array_equal(Metrics.load_img(path), img)
    assert np.array_equal(Metrics.load_img(path, first="pil"), img)
    data = Metrics.encode_png(img)
    assert np.array_equal(Metrics.load_img(data), img)
    with pytest.raises(ValueError, match="PNG only"):
        Metrics.save_img(img, str(tmp_path / "a.jpg"))


def test_what_the_codec_cannot_read_raises(tmp_path, no_libraries):
    img = np.random.default_rng(2).integers(0, 256, (8, 8, 3), np.uint8)
    jpg, deep, laced, pal = (str(tmp_path / n) for n in
                             ("a.jpg", "b.png", "c.png", "d.png"))
    Image.fromarray(img).save(jpg)
    Image.fromarray(img[..., 0].astype(np.uint16) * 257).save(deep)
    with open(laced, "wb") as f:  # Pillow writes no Adam7
        f.write(_png(img, 2, [0] * 8, interlace=1))
    Image.fromarray(img).convert("P").save(pal)
    for path, what in ((jpg, "JPEG"), (deep, "16-bit"), (laced, "interlaced"),
                       (pal, "palette")):
        with pytest.raises(ValueError, match=what):
            Metrics.load_img(path)
