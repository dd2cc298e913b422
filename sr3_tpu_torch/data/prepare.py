"""Offline dataset preparation, and the resize the cascade conditions with.

The port's own copy of ``sr3_tpu/data/prepare.py``. Each source image
becomes an (lr, hr, sr) triplet -- sr is lr resized up to hr's size with
the same filter -- written as PNG directories ``lr_{l}/ hr_{r}/ sr_{l}_{r}/``
or one LMDB with keys ``lr_{l}_{idx:05d}`` / ``hr_{r}_{idx:05d}`` /
``sr_{l}_{r}_{idx:05d}`` and a ``length`` entry.

The resize is a numpy implementation of Pillow's separable resampling of
8-bit images (``Image.resize`` with BILINEAR, BICUBIC or LANCZOS), bit for
bit: per output pixel a window of input pixels around the center
``(i + 0.5) * scale`` with the filter's support stretched by ``scale`` when
downscaling, weights normalised by their sum, then rounded to 22-bit
fixed point (half away from zero); each pass sums integer products plus
the rounding term ``1 << 21`` and clips to 0..255, the horizontal pass
first. Arrays are uint8 HWC. Files are decoded and encoded through
``utils/metrics.py`` (Pillow, else cv2, else the port's PNG codec), so
``prepare`` runs on a machine without Pillow for PNG sources, and the
cascade (``training/cascade.py``) resizes without it.

Usage:
  python -m sr3_tpu_torch.data.prepare --path <src> --out <dst>
         --size 16,128 [--n_worker 8] [--resample bicubic] [--lmdb]
"""

from __future__ import annotations

import argparse
import functools
import math
import multiprocessing
import os
from glob import glob

import numpy as np

from sr3_tpu_torch.utils.metrics import encode_png, load_img, save_img

# Pillow's filter codes (Image.Resampling)
LANCZOS, BILINEAR, BICUBIC = 1, 2, 3
RESAMPLE = {"bilinear": BILINEAR, "bicubic": BICUBIC, "lanczos": LANCZOS}
PRECISION_BITS = 32 - 8 - 2


def _bilinear(x):
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x, a=-0.5):
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _sinc(x):
    with np.errstate(invalid="ignore", divide="ignore"):
        px = x * math.pi
        return np.where(x == 0.0, 1.0, np.sin(px) / px)


def _lanczos(x):
    return np.where((-3.0 <= x) & (x < 3.0), _sinc(x) * _sinc(x / 3), 0.0)


# code: (filter, support)
_FILTERS = {BILINEAR: (_bilinear, 1.0), BICUBIC: (_bicubic, 2.0),
            LANCZOS: (_lanczos, 3.0)}


def _coefficients(in_size, out_size, code):
    """(first input index, 22-bit fixed-point weights) of each output pixel
    of one axis: (out,) and (out, ksize) int64, zero past each window."""
    if code not in _FILTERS:
        raise ValueError(f"resample must be one of Pillow's codes "
                         f"{sorted(_FILTERS)} ({RESAMPLE}), got {code!r}")
    fn, support = _FILTERS[code]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) cast truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    taps = np.arange(ksize)
    x = taps[None, :] + xmin[:, None]
    w = fn((x - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros((out_size, 1))
    for t in taps:  # in window order, as Pillow sums them
        ww[:, 0] += w[:, t]
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    fixed = w * (1 << PRECISION_BITS)
    fixed = np.where(w < 0, np.trunc(-0.5 + fixed), np.trunc(0.5 + fixed))
    return xmin, fixed.astype(np.int64)


def _resample_axis(img, out_size, axis, code):
    """One 8-bit pass of Pillow's resampling along ``axis`` of a uint8
    array: integer sums of the window, the rounding term, clip to 0..255."""
    in_size = img.shape[axis]
    xmin, k = _coefficients(in_size, out_size, code)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1),
                  np.int64)
    extra = (1,) * (src.ndim - 1)
    for t in range(k.shape[1]):
        idx = np.minimum(xmin + t, in_size - 1)
        acc += src[idx] * k[:, t].reshape((out_size,) + extra)
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize(img, size, resample=BICUBIC):
    """uint8 (H, W[, C]) array -> (h, w[, C]) with ``size`` = (w, h), as
    Pillow's ``Image.resize(size, resample)``: the horizontal pass, then
    the vertical one, each only when its size changes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"resize takes uint8 images, got {img.dtype}")
    w, h = size
    if (img.shape[1], img.shape[0]) == (w, h):
        return img.copy()
    if img.shape[1] != w:
        img = _resample_axis(img, w, 1, resample)
    if img.shape[0] != h:
        img = _resample_axis(img, h, 0, resample)
    return img


def resize_and_convert(img, size, resample=BICUBIC):
    """Aspect-preserving resize of the shorter edge to ``size``, then a
    center crop to size x size (torchvision resize / center_crop semantics,
    as the reference's prepare_data.py); like the reference, a no-op when
    the width already matches. ``img``: uint8 HWC array."""
    img = np.asarray(img)
    if img.shape[1] != size:
        h, w = img.shape[:2]
        if w <= h:
            nw, nh = size, int(size * h / w)
        else:
            nw, nh = int(size * w / h), size
        img = resize(img, (nw, nh), resample)
        h, w = img.shape[:2]
        left = int(round((w - size) / 2.0))
        top = int(round((h - size) / 2.0))
        img = img[top:top + size, left:left + size]
    return img


def resize_multiple(img, sizes=(16, 128), resample=BICUBIC):
    """LR at sizes[0], HR at sizes[1], SR = LR resized up to sizes[1] with
    the same filter (reference prepare_data.py:30-39)."""
    lr = resize_and_convert(img, sizes[0], resample)
    hr = resize_and_convert(img, sizes[1], resample)
    sr = resize_and_convert(lr, sizes[1], resample)
    return lr, hr, sr


def _process_one(file, sizes, resample):
    """Key each triplet by the source filename stem."""
    img = load_img(file, first="pil")
    stem = os.path.splitext(os.path.basename(file))[0]
    return stem, resize_multiple(img, sizes=sizes, resample=resample)


def prepare(img_path, out_path, n_worker=1, sizes=(16, 128),
            resample=BICUBIC, lmdb_save=False):
    files = sorted(
        f for ext in ("*.jpg", "*.jpeg", "*.png", "*.bmp", "*.ppm")
        for f in glob(os.path.join(img_path, "**", ext), recursive=True)
    )
    if not files:
        raise SystemExit(f"no images found under {img_path}")

    l, r = sizes
    if lmdb_save:
        import lmdb

        env = lmdb.open(out_path, map_size=1024 ** 4, readahead=False)
    else:
        env = None
        os.makedirs(f"{out_path}/lr_{l}", exist_ok=True)
        os.makedirs(f"{out_path}/hr_{r}", exist_ok=True)
        os.makedirs(f"{out_path}/sr_{l}_{r}", exist_ok=True)

    worker = functools.partial(_process_one, sizes=sizes, resample=resample)
    if n_worker > 1:
        with multiprocessing.get_context("spawn").Pool(n_worker) as pool:
            results = pool.map(worker, files)
    else:
        results = [worker(f) for f in files]

    total = 0
    for stem, (lr_img, hr_img, sr_img) in sorted(results, key=lambda r: r[0]):
        key = stem.zfill(5)
        if env is None:
            save_img(lr_img, f"{out_path}/lr_{l}/{key}.png")
            save_img(hr_img, f"{out_path}/hr_{r}/{key}.png")
            save_img(sr_img, f"{out_path}/sr_{l}_{r}/{key}.png")
        else:
            with env.begin(write=True) as txn:
                for tag, im in ((f"lr_{l}_{key}", lr_img),
                                (f"hr_{r}_{key}", hr_img),
                                (f"sr_{l}_{r}_{key}", sr_img)):
                    txn.put(tag.encode(), encode_png(im))
        total += 1
        if env is not None:
            with env.begin(write=True) as txn:
                txn.put(b"length", str(total).encode())
    print(f"prepared {total} triplets -> {out_path}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--path", "-p", type=str, required=True)
    parser.add_argument("--out", "-o", type=str, required=True)
    parser.add_argument("--size", "-s", type=str, default="16,128")
    parser.add_argument("--n_worker", "-n", type=int, default=1)
    parser.add_argument("--resample", "-r", type=str, default="bicubic",
                        choices=sorted(RESAMPLE))
    parser.add_argument("--lmdb", "-l", action="store_true")
    args = parser.parse_args(argv)

    sizes = tuple(int(s.strip()) for s in args.size.split(","))
    prepare(args.path, args.out, n_worker=args.n_worker, sizes=sizes,
            resample=RESAMPLE[args.resample], lmdb_save=args.lmdb)


if __name__ == "__main__":
    main()
