"""Image transforms of the port's dataset.

The port's own copy of the conversion helpers of the JAX package's
``sr3_tpu/data/transforms.py``: uint8 HWC -> float32 [0, 1], the paired
random horizontal flip of the train split, and the rescale to [-1, 1].
"""

from __future__ import annotations

import random

import numpy as np


def transform2numpy(img):
    """Image or array -> float32 HWC in [0, 1]; 2-D promoted to one
    channel, channels past 3 cropped."""
    img = np.array(img).astype(np.float32) / 255.0
    if img.ndim == 2:
        img = np.expand_dims(img, axis=2)
    if img.shape[2] > 3:
        img = img[:, :, :3]
    return img


def rescale(img, min_max=(0, 1)):
    """[0, 1] -> [min_max]."""
    return img * (min_max[1] - min_max[0]) + min_max[0]


def transform_augment(img_list, split="val", min_max=(0, 1)):
    """Convert, flip the whole list horizontally together with probability
    1/2 in the train split (one ``random.random()`` draw), rescale: float32
    HWC arrays."""
    imgs = [transform2numpy(img) for img in img_list]
    if split == "train" and random.random() < 0.5:
        imgs = [img[:, ::-1, :].copy() for img in imgs]
    return [rescale(img, min_max) for img in imgs]
