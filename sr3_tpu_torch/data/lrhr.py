"""Paired LR / SR / HR dataset over image directories or LMDB.

The port's own copy of the JAX package's ``LRHRDataset``
(``sr3_tpu/data/lrhr.py``), on its numpy path (the JAX package's native
decoder is not used):

- img mode: sorted recursive walks of ``{root}/sr_{l}_{r}``,
  ``{root}/hr_{r}`` and ``{root}/lr_{l}``;
- lmdb mode: keys ``hr_{r}_{idx:05d}`` / ``sr_{l}_{r}_{idx:05d}`` /
  ``lr_{l}_{idx:05d}``, the length from the ``length`` key, an invalid index
  replaced by a random one;
- ``data_len`` truncation, the ``need_LR`` switch, items as NHWC float32 in
  [-1, 1], and a RAM cache of decoded uint8 images (``cache``; on by default
  when the dataset fits 512 MB).

Pillow (and lmdb) are imported where images are opened, so the module
imports on a machine without them.
"""

from __future__ import annotations

import os
import random
from io import BytesIO

import numpy as np

from sr3_tpu_torch.data.transforms import transform_augment

IMG_EXTENSIONS = (
    ".jpg", ".JPG", ".jpeg", ".JPEG", ".png", ".PNG",
    ".ppm", ".PPM", ".bmp", ".BMP",
)


def get_paths_from_images(path):
    """Sorted recursive listing of the image files under ``path``."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"{path} is not a valid directory")
    images = []
    for dirpath, _, fnames in sorted(os.walk(path)):
        for fname in sorted(fnames):
            if fname.endswith(IMG_EXTENSIONS):
                images.append(os.path.join(dirpath, fname))
    if not images:
        raise FileNotFoundError(f"{path} has no valid image file")
    return sorted(images)


class LRHRDataset:
    """Map-style dataset; ``__getitem__`` returns a dict of HWC float32
    arrays in [-1, 1] plus 'Index'. In the train split all images of a
    sample are flipped horizontally together with probability 1/2."""

    CACHE_AUTO_BYTES = 512 * 1024 * 1024

    def __init__(self, dataroot, datatype, l_resolution=16, r_resolution=128,
                 split="train", data_len=-1, need_LR=False, min_max=(-1, 1),
                 cache=None):
        self.datatype = datatype
        self.l_res = l_resolution
        self.r_res = r_resolution
        self.data_len = data_len
        self.need_LR = need_LR
        self.split = split
        self.min_max = min_max
        self._cache = None

        if datatype == "lmdb":
            import lmdb

            self.env = lmdb.open(dataroot, readonly=True, lock=False,
                                 readahead=False, meminit=False)
            with self.env.begin(write=False) as txn:
                self.dataset_len = int(txn.get(b"length"))
        elif datatype == "img":
            self.sr_path = get_paths_from_images(
                f"{dataroot}/sr_{l_resolution}_{r_resolution}")
            self.hr_path = get_paths_from_images(
                f"{dataroot}/hr_{r_resolution}")
            if need_LR:
                self.lr_path = get_paths_from_images(
                    f"{dataroot}/lr_{l_resolution}")
            self.dataset_len = len(self.hr_path)
        else:
            raise NotImplementedError(
                f"data_type [{datatype}] is not recognized.")
        self.data_len = (self.dataset_len if self.data_len <= 0
                         else min(self.data_len, self.dataset_len))

        item_bytes = 3 * (2 * r_resolution ** 2
                          + (l_resolution ** 2 if need_LR else 0))
        auto = self.data_len * item_bytes <= self.CACHE_AUTO_BYTES
        if cache if cache is not None else auto:
            self._cache = {}

    def __len__(self):
        return self.data_len

    def _decoded(self, index):
        """uint8 HWC arrays {HR, SR, [LR]} of one sample, via the cache."""
        if self._cache is not None and index in self._cache:
            return self._cache[index]
        img_hr, img_sr, img_lr = self._open(index)
        out = {"HR": np.asarray(img_hr.convert("RGB"), dtype=np.uint8),
               "SR": np.asarray(img_sr.convert("RGB"), dtype=np.uint8)}
        if self.need_LR:
            out["LR"] = np.asarray(img_lr.convert("RGB"), dtype=np.uint8)
        if self._cache is not None:
            self._cache[index] = out
        return out

    def _read_lmdb(self, index):
        from PIL import Image

        with self.env.begin(write=False) as txn:
            def fetch(idx):
                hr = txn.get(f"hr_{self.r_res}_{str(idx).zfill(5)}".encode())
                sr = txn.get(f"sr_{self.l_res}_{self.r_res}_"
                             f"{str(idx).zfill(5)}".encode())
                lr = (txn.get(f"lr_{self.l_res}_{str(idx).zfill(5)}".encode())
                      if self.need_LR else None)
                return hr, sr, lr

            hr, sr, lr = fetch(index)
            while hr is None or sr is None:  # an invalid index: resample
                hr, sr, lr = fetch(random.randint(0, self.data_len - 1))
        return (Image.open(BytesIO(hr)), Image.open(BytesIO(sr)),
                Image.open(BytesIO(lr)) if self.need_LR else None)

    def _open(self, index):
        if self.datatype == "lmdb":
            return self._read_lmdb(index)
        from PIL import Image

        return (Image.open(self.hr_path[index]), Image.open(self.sr_path[index]),
                Image.open(self.lr_path[index]) if self.need_LR else None)

    def __getitem__(self, index):
        dec = self._decoded(index)
        keys = ["LR", "SR", "HR"] if self.need_LR else ["SR", "HR"]
        arrays = transform_augment([dec[k] for k in keys], split=self.split,
                                   min_max=self.min_max)
        out = dict(zip(keys, arrays))
        out["Index"] = index
        return out
