"""The port's own PNG codec, in numpy and the standard library's zlib.

The card's machine has neither cv2 nor Pillow, so the port reads and writes
PNG through this codec where both are missing (``utils/metrics.py``
``load_img`` / ``save_img`` / ``encode_png``; the dataset and ``prepare``
decode through ``load_img``):

- ``decode``: 8-bit, non-interlaced PNG of color type gray (0), RGB (2),
  gray + alpha (4) or RGBA (6), every row filter (None, Sub, Up, Average,
  Paeth), from a path or from bytes -> uint8 (H, W, C) with C the color
  type's channels. Anything else (16-bit or sub-byte depths, a palette,
  Adam7 interlace) raises ``ValueError`` naming what is missing.
- ``to_rgb``: gray replicated to three channels, alpha dropped (what
  Pillow's ``convert("RGB")`` and cv2's ``IMREAD_COLOR`` give).
- ``encode``: uint8 RGB (H, W, 3) -> PNG bytes, filter 0 on every row.

PNG is lossless: any conforming decoder gives the same pixels.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def is_png(data):
    return bytes(data[:8]) == SIGNATURE


def _chunks(data):
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n


def _paeth(a, b, c):
    """The Paeth predictor of left, up and up-left (int16 arrays)."""
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


# each filter's prediction from left, up and up-left
PREDICT = {0: lambda a, b, c: 0, 1: lambda a, b, c: a,
           2: lambda a, b, c: b, 3: lambda a, b, c: (a + b) >> 1, 4: _paeth}


def _unfilter(raw, h, w, bpp):
    """Undo the per-row filters of the decompressed scanlines.

    A pixel's prediction reads the reconstructed pixels to its left, above
    and above-left, so every pixel of one anti-diagonal (x + y = t) can be
    reconstructed at once from the diagonals before it: H + W - 1 steps,
    each over all rows, each row by its own filter. The pixels are held
    sheared, one diagonal to a row (``d[t + 2, y + 1]`` is pixel
    ``(y, t - y)``; the cells outside the image are the zeros the filters
    read past its edges), so each step reads and writes contiguous slices.
    Where every row has filter 0 the scanlines are the pixels, with no
    step."""
    rows = np.frombuffer(raw, np.uint8)
    stride = w * bpp
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG image data holds {rows.size} bytes, want "
                         f"{h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    kinds = rows[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG filter type {kinds.max()}, not 0-4")
    if not kinds.any():  # filter 0 on every row (what ``encode`` writes)
        return rows[:, 1:].reshape(h, w, bpp).copy()
    ys, xs = np.indices((h, w))
    line = np.zeros((h + w - 1, h, bpp), np.int16)
    line[ys + xs, ys] = rows[:, 1:].reshape(h, w, bpp)
    d = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    # the most common filter predicts every row, and the rows of each other
    # filter are put right where a step holds any (``seen`` counts them)
    count = np.bincount(kinds, minlength=5)
    main = int(count.argmax())
    others = [(k, (kinds == k)[:, None],
               np.concatenate([[0], np.cumsum(kinds == k)]).tolist())
              for k in range(5) if count[k] and k != main]
    for t in range(h + w - 1):
        y0, y1 = max(0, t - w + 1), min(h, t + 1)
        a, b, c = d[t + 1, y0 + 1:y1 + 1], d[t + 1, y0:y1], d[t, y0:y1]
        pred = PREDICT[main](a, b, c)
        for k, mask, seen in others:
            if seen[y1] > seen[y0]:
                pred = np.where(mask[y0:y1], PREDICT[k](a, b, c), pred)
        d[t + 2, y0 + 1:y1 + 1] = (line[t, y0:y1] + pred) & 0xFF
    return d[ys + xs + 2, ys + 1].astype(np.uint8)


def decode(src):
    """PNG from a path or bytes -> uint8 (H, W, C) array, C = 1, 2, 3 or 4
    by color type (gray, gray + alpha, RGB, RGBA)."""
    if isinstance(src, (bytes, bytearray, memoryview)):
        data = bytes(src)
    else:
        with open(src, "rb") as f:
            data = f.read()
    if not is_png(data):
        raise ValueError("not a PNG file (signature mismatch); the port's "
                         "codec reads PNG only: install cv2 or Pillow for "
                         "other formats such as JPEG")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8:
        raise ValueError(f"{depth}-bit PNG: the port's codec reads 8-bit "
                         "PNG only (install cv2 or Pillow)")
    if color not in CHANNELS:
        raise ValueError(f"PNG color type {color} (palette): the port's "
                         "codec reads gray, gray + alpha, RGB and RGBA only "
                         "(install cv2 or Pillow)")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG: the port's codec reads "
                         "non-interlaced PNG only (install cv2 or Pillow)")
    c = CHANNELS[color]
    return _unfilter(zlib.decompress(b"".join(idat)), h, w, c)


def to_rgb(img):
    """(H, W, C) uint8 -> (H, W, 3): gray replicated, alpha dropped."""
    if img.shape[2] in (1, 2):
        return np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode(img):
    """uint8 RGB (H, W, 3) -> PNG bytes (filter 0 on every row)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode takes uint8 (H, W, 3), got {img.dtype} "
                         f"{img.shape}")
    h, w, _ = img.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = img.reshape(h, 3 * w)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))
