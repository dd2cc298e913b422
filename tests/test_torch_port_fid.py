"""The port's FID (sr3_tpu_torch/utils/fid.py, sr3_tpu_torch/fid_eval.py)
against the JAX package's (sr3_tpu/utils/fid.py, tools/fid_eval.py).

The distance math is the same float64 numpy (1e-12 relative); the proxy
extractor's kernels are the JAX extractor's for the same seed and width
from the port's numpy copy of jax.random (1e-6 of max|k|), and its features
on odd and even image sides within 1e-5 relative; the two drivers score the
same results directory within 1e-4 and print the same --features-npz lines.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sr3_tpu.utils import fid as jfid
from sr3_tpu_torch import fid_eval
from sr3_tpu_torch.utils import fid as pfid

_spec = importlib.util.spec_from_file_location(
    "tools_fid_eval",
    os.path.join(os.path.dirname(__file__), "..", "tools", "fid_eval.py"))
jax_fid_eval = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_fid_eval)


def _feats(seed, n, d):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)) @ rng.standard_normal((d, d)) * 0.3 \
        + rng.standard_normal(d)


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)


def test_distance_math_equals_the_jax_packages():
    a, b = _feats(0, 64, 12), _feats(1, 80, 12)
    for got, want in zip(pfid.activation_statistics(a),
                         jfid.activation_statistics(a)):
        assert _close(got, want, 1e-12)
    assert _close(pfid.fid_from_features(a, b),
                  jfid.fid_from_features(a, b), 1e-12)
    stats = (*jfid.activation_statistics(a), *jfid.activation_statistics(b))
    assert _close(pfid.frechet_distance(*stats),
                  jfid.frechet_distance(*stats), 1e-12)
    logits = np.random.default_rng(2).standard_normal((50, 10)) * 3
    for splits in (1, 5, 10):
        assert _close(pfid.inception_score(logits, splits),
                      jfid.inception_score(logits, splits), 1e-12)
    with pytest.raises(ValueError):
        pfid.activation_statistics(a[:1])


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("width", [64, 192])
def test_extractor_kernels_equal_the_jax_draws(seed, width):
    want = [np.asarray(k) for k in
            jfid.RandomFeatureExtractor(seed=seed, width=width)._kernels]
    got = pfid.jax_extractor_kernels(seed, width)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max()
    # the module holds them as OIHW
    ext = pfid.RandomFeatureExtractor(seed=seed, width=width, device="cpu")
    assert torch.equal(ext.weights[0],
                       torch.from_numpy(got[0].transpose(3, 2, 0, 1)))


def test_prng_split_is_bit_equal():
    import jax

    for seed in (0, 7, 2**31 - 1):
        key = jax.random.PRNGKey(seed)
        assert np.array_equal(np.asarray(key), pfid.prng_key(seed))
        assert np.array_equal(np.asarray(jax.random.split(key, 4)),
                              pfid.split(pfid.prng_key(seed), 4))


@pytest.mark.parametrize("h,w", [(33, 33), (40, 24)])
def test_features_equal_the_jax_extractors(h, w):
    images = np.random.default_rng(h * w).integers(0, 256, (5, h, w, 3),
                                                   dtype=np.uint8)
    jext = jfid.RandomFeatureExtractor(seed=3, width=32)
    want = jext(images, batch_size=4)
    got = pfid.RandomFeatureExtractor(seed=3, width=32, device="cpu")(
        images, batch_size=4)
    assert got.shape == want.shape == (5, 64)
    assert _close(got, want, 1e-5)
    # the JAX kernels carried across give the same features
    carried = pfid.kernels_from_jax([np.asarray(k) for k in jext._kernels],
                                    device="cpu")
    assert carried.width == 32
    assert _close(carried(images), want, 1e-5)
    x = jnp.asarray(images.astype(np.float32) / 127.5 - 1.0)
    assert _close(np.asarray(jext._forward(x)), want, 1e-6)


def _results_dir(root, n=40, size=32):
    rng = np.random.default_rng(11)
    os.makedirs(root)
    for i in range(n):
        hr = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        # a contrast change and noise: a fake set far from the real one
        noise = rng.integers(-40, 41, hr.shape)
        sr = np.clip(hr // 2 + 60 + noise, 0, 255).astype(np.uint8)
        Image.fromarray(hr).save(os.path.join(root, f"0_{i}_hr.png"))
        Image.fromarray(sr).save(os.path.join(root, f"0_{i}_sr.png"))
    return root


def _recorded(module, monkeypatch):
    """Record the unrounded scores of ``module.fid_from_features``."""
    scores, fn = [], module.fid_from_features
    monkeypatch.setattr(module, "fid_from_features",
                        lambda a, b: scores.append(fn(a, b)) or scores[-1])
    return scores


def test_fid_eval_scores_as_tools_fid_eval(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("SR3_PLATFORM", "cpu")
    root = _results_dir(str(tmp_path / "results"))
    argv = ["-p", root, "--seed", "5", "--width", "16", "--batch", "16"]
    want, got = _recorded(jfid, monkeypatch), _recorded(pfid, monkeypatch)
    jax_fid_eval.main(argv)
    want_out = capsys.readouterr().out
    fid_eval.main(argv)
    got_out = capsys.readouterr().out
    assert len(want) == len(got) == 1 and want[0] > 0.1
    assert abs(got[0] - want[0]) <= 1e-4 * want[0], (got, want)
    assert got_out == want_out
    assert got_out.startswith("# proxy-FID (seed 5, width 16, 40 real / 40 "
                              "fake): ")

    rng = np.random.default_rng(4)
    npz = str(tmp_path / "feats.npz")
    np.savez(npz, real=_feats(5, 60, 8), fake=_feats(6, 50, 8),
             logits=rng.standard_normal((50, 10)))
    jax_fid_eval.main(["--features-npz", npz])
    want = capsys.readouterr().out
    fid_eval.main(["--features-npz", npz])
    assert capsys.readouterr().out == want
    assert "# FID (provided features)" in want and "# IS:" in want


def test_fid_eval_needs_images_and_torchvision(tmp_path, monkeypatch):
    monkeypatch.setenv("SR3_PLATFORM", "cpu")
    root = _results_dir(str(tmp_path / "results"), n=2, size=16)
    with pytest.raises(ImportError, match="torchvision"):
        fid_eval.main(["-p", root, "--extractor", "inception"])
    with pytest.raises(SystemExit):
        fid_eval.main(["-p", str(tmp_path)])
