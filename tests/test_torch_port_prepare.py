"""The port's resize (sr3_tpu_torch/data/prepare.py, numpy) against Pillow
12.1's Image.resize and the JAX package's prepare tool.

Exact: every output byte equal, on seeded uint8 images, for bilinear,
bicubic and lanczos up and down, square and not; resize_and_convert and
resize_multiple against the JAX package's (Pillow) functions; the CLI's PNG
directories against the JAX package's prepare on the same sources.
"""

import os

import numpy as np
import pytest
from PIL import Image

from sr3_tpu.data import prepare as jax_prepare
from sr3_tpu_torch.data import prepare

FILTERS = [("bilinear", Image.BILINEAR), ("bicubic", Image.BICUBIC),
           ("lanczos", Image.LANCZOS)]
# (H, W) -> (h, w): the cascade's and the datasets' ups, and downs
SIZES = [((16, 16), (128, 128)), ((64, 64), (512, 512)),
         ((128, 128), (1024, 1024)), ((1024, 1024), (16, 16)),
         ((300, 200), (100, 150)), ((37, 53), (91, 19))]


def _image(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("name,code", FILTERS)
@pytest.mark.parametrize("src,dst", SIZES)
def test_resize_equals_pillow(name, code, src, dst):
    img = _image(sum(src) + sum(dst), *src)
    got = prepare.resize(img, dst[::-1], prepare.RESAMPLE[name])
    want = np.asarray(Image.fromarray(img).resize(dst[::-1], code))
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() == 0, (diff.max(), int((diff > 0).sum()))
    assert prepare.RESAMPLE[name] == int(code)  # Pillow's own codes


@pytest.mark.parametrize("name,code", FILTERS)
@pytest.mark.parametrize("shape,size", [((80, 120), 16), ((120, 80), 64),
                                        ((70, 70), 32), ((50, 16), 16)])
def test_resize_and_convert_equals_the_jax_packages(name, code, shape, size):
    """Shorter edge to ``size`` and a centre crop (a non-square downscale and
    upscale), and the no-op when the width already matches."""
    img = _image(shape[0] * shape[1], *shape)
    got = prepare.resize_and_convert(img, size, prepare.RESAMPLE[name])
    want = np.asarray(jax_prepare.resize_and_convert(Image.fromarray(img),
                                                     size, code))
    assert got.shape == want.shape and np.array_equal(got, want)


def test_resize_multiple_equals_the_jax_packages():
    img = _image(5, 96, 144)
    got = prepare.resize_multiple(img, (16, 64))
    want = jax_prepare.resize_multiple(Image.fromarray(img), (16, 64))
    for g, w in zip(got, want):
        assert np.array_equal(g, np.asarray(w))


def test_resize_refuses_other_dtypes_and_filters():
    with pytest.raises(TypeError):
        prepare.resize(np.zeros((4, 4, 3), np.float32), (8, 8))
    with pytest.raises(ValueError):
        prepare.resize(np.zeros((4, 4, 3), np.uint8), (8, 8), 4)  # box


def test_cli_writes_the_jax_packages_triplets(tmp_path):
    src = tmp_path / "src"
    os.makedirs(src)
    for i in range(3):
        Image.fromarray(_image(10 + i, 70, 90)).save(src / f"{i}.png")
    prepare.main(["-p", str(src), "-o", str(tmp_path / "port"), "-s", "16,32"])
    jax_prepare.prepare(str(src), str(tmp_path / "jax"), sizes=(16, 32))
    for sub in ("lr_16", "hr_32", "sr_16_32"):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert sorted(os.listdir(tmp_path / "port" / sub)) == names
        assert len(names) == 3
        for n in names:
            a = np.asarray(Image.open(tmp_path / "port" / sub / n))
            b = np.asarray(Image.open(tmp_path / "jax" / sub / n))
            assert np.array_equal(a, b), (sub, n)
