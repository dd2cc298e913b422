"""FID and Inception Score of the port.

The port's own copy of the JAX package's ``sr3_tpu/utils/fid.py``:

- the distance math (``activation_statistics``, ``frechet_distance``,
  ``fid_from_features``, ``inception_score``) is the same float64 numpy,
  with ``scipy.linalg.sqrtm`` and the eigenvalue identity where scipy is
  missing;
- ``RandomFeatureExtractor`` is the seeded, untrained proxy-FID backbone as
  an ``nn.Module`` on the device (four stride-2 3x3 convs, each followed
  by GELU, then mean and standard-deviation pooling to (N, 2 * width)),
  float32. Its weights are the JAX extractor's for the same ``seed`` and
  ``width``: ``jax.random.split`` and ``jax.random.normal`` are copied into
  numpy below (threefry2x32 in JAX's partitionable mode, the mantissa bit
  trick of ``jax.random.uniform`` on (nextafter(-1, 0), 1), then sqrt(2)
  times XLA's float32 ``ErfInv`` polynomial), so a proxy-FID from either
  package can be compared. ``kernels_from_jax`` carries kernels across
  directly;
- ``InceptionV3FeatureExtractor``: torchvision's InceptionV3 pooled
  features (2048-d) and logits, torchvision imported where it is built.

Proxy-FID scores are comparable only across runs with the same seed and
width, not with published Inception-FID numbers.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sr3_tpu_torch.utils.runtime import resolve_device


# ---------------------------------------------------------------- distance

def activation_statistics(feats):
    """(N, D) features -> (mu (D,), sigma (D, D)) of the fitted Gaussian."""
    feats = np.asarray(feats, np.float64)
    if feats.ndim != 2 or feats.shape[0] < 2:
        raise ValueError(f"need (N>=2, D) features, got {feats.shape}")
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, np.atleast_2d(sigma)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
    """||mu1-mu2||^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)).

    sqrtm via scipy when available; else the eigenvalue identity
    Tr(sqrt(s1 s2)) = sum sqrt(eig(s1 s2)) (valid for PSD s1, s2). sqrtm is
    called without ``disp``, which SciPy 1.18 removed (the JAX package
    passes ``disp=False``; the root it returns is the same).
    """
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    s1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    s2 = np.atleast_2d(np.asarray(sigma2, np.float64))
    diff = mu1 - mu2

    try:
        from scipy import linalg

        covmean = linalg.sqrtm(s1 @ s2)
        if not np.isfinite(covmean).all():
            offset = np.eye(s1.shape[0]) * eps
            covmean = linalg.sqrtm((s1 + offset) @ (s2 + offset))
        tr_covmean = np.trace(covmean.real)
    except ImportError:
        eigvals = np.linalg.eigvals(s1 @ s2)
        tr_covmean = np.sqrt(np.clip(eigvals.real, 0.0, None)).sum()

    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2.0 * tr_covmean)


def fid_from_features(feats_a, feats_b):
    """FID between two (N, D) feature sets."""
    return frechet_distance(*activation_statistics(feats_a),
                            *activation_statistics(feats_b))


def inception_score(logits, splits=10):
    """(mean, std) of exp(E_x KL(p(y|x) || p(y))) over ``splits`` chunks of
    (N, C) classifier logits."""
    logits = np.asarray(logits, np.float64)
    if logits.ndim != 2:
        raise ValueError(f"need (N, C) logits, got {logits.shape}")
    logp = logits - logits.max(axis=1, keepdims=True)
    logp = logp - np.log(np.exp(logp).sum(axis=1, keepdims=True))
    p = np.exp(logp)

    n = logits.shape[0]
    splits = max(1, min(splits, n))
    scores = []
    for chunk in np.array_split(np.arange(n), splits):
        pc = p[chunk]
        marginal = pc.mean(axis=0, keepdims=True)
        kl = (pc * (np.log(pc + 1e-16) - np.log(marginal + 1e-16))).sum(1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores)), float(np.std(scores))


# ------------------------------------------ jax.random's draws, in numpy

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) of ``key`` (two uint32)
    over the counter words ``x0``, ``x1`` (uint32 arrays), as
    ``jax.random``'s ``threefry2x32_p``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _counters(n):
    """High and low 32-bit words of the flat indices 0..n-1 (JAX's
    ``iota_2x32_shape``)."""
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), i.astype(np.uint32)


def prng_key(seed):
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: (0, seed)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def split(key, num):
    """``jax.random.split(key, num)`` in partitionable mode: key i is the
    cipher of the counter i."""
    bits = threefry2x32(key, *_counters(num))
    return np.stack(bits, axis=1)


def _erf_inv32(x):
    """XLA's float32 ErfInv (M. Giles' single-precision polynomials)."""
    lo = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
          0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
          1.50140941)
    hi = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
          0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
          2.83297682)
    f32 = np.float32
    x = np.asarray(x, f32)
    w = -np.log1p(-x * x)
    small = w < f32(5.0)
    w = np.where(small, w - f32(2.5), np.sqrt(w) - f32(3.0)).astype(f32)
    p = np.where(small, f32(lo[0]), f32(hi[0])).astype(f32)
    for a, b in zip(lo[1:], hi[1:]):
        p = (np.where(small, f32(a), f32(b)) + p * w).astype(f32)
    out = p * x
    return np.where(np.abs(x) == f32(1), x * np.finfo(f32).max, out)


def normal(key, shape):
    """``jax.random.normal(key, shape, float32)`` in partitionable mode."""
    n = int(np.prod(shape))
    b0, b1 = threefry2x32(key, *_counters(n))
    bits = b0 ^ b1
    f32 = np.float32
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(f32) \
        - f32(1.0)
    lo = np.nextafter(f32(-1.0), f32(0.0))
    u = np.maximum(lo, floats * (f32(1.0) - lo) + lo).astype(f32)
    return (f32(np.sqrt(2)) * _erf_inv32(u)).reshape(shape)


def jax_extractor_kernels(seed, width):
    """The four HWIO kernels of the JAX ``RandomFeatureExtractor(seed,
    width)``: split the key into 4, a normal draw each, times
    sqrt(2 / (9 cin))."""
    keys = split(prng_key(seed), 4)
    chans = [3, width // 4, width // 2, width, width]
    return [normal(k, (3, 3, cin, cout))
            * np.float32(np.sqrt(2.0 / (9 * cin)))
            for k, cin, cout in zip(keys, chans[:-1], chans[1:])]


# --------------------------------------------------------------- extractor

def _pad_same(x, k=3, s=2):
    """XLA's "SAME" padding of an NCHW map for a k-wide window at stride s:
    the total pad split with the smaller half first (0 before and 1 after on
    an even side at k 3, s 2; 1 and 1 on an odd one)."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class RandomFeatureExtractor(nn.Module):
    """Seeded untrained conv feature extractor (the proxy-FID backbone).

    Four stride-2 3x3 convs, each followed by tanh-approximated GELU, then
    per-channel mean and population standard deviation (+1e-6 under the
    root) -> (N, 2 * width) float32 features. Its kernels are the JAX
    extractor's for the same (seed, width), or ``kernels`` (HWIO numpy
    arrays, e.g. from ``kernels_from_jax``). Runs on ``device`` (default:
    the card, or the CPU under ``SR3_PLATFORM=cpu``)."""

    def __init__(self, seed=0, width=192, device=None, kernels=None):
        super().__init__()
        self.seed, self.width = int(seed), int(width)
        self.device = torch.device(device) if device is not None \
            else resolve_device()
        if kernels is None:
            kernels = jax_extractor_kernels(self.seed, self.width)
        self.weights = nn.ParameterList(
            nn.Parameter(torch.from_numpy(
                np.ascontiguousarray(np.asarray(k, np.float32)
                                     .transpose(3, 2, 0, 1))),
                requires_grad=False)
            for k in kernels)
        self.to(self.device)

    def forward(self, x):
        """(N, 3, H, W) float32 in [-1, 1] -> (N, 2 * width)."""
        for w in self.weights:
            x = F.gelu(F.conv2d(_pad_same(x), w, stride=2),
                       approximate="tanh")
        mean = x.mean(dim=(2, 3))
        std = torch.sqrt(x.var(dim=(2, 3), unbiased=False) + 1e-6)
        return torch.cat([mean, std], dim=1)

    @torch.no_grad()
    def __call__(self, images_uint8, batch_size=64):
        """uint8 HWC images (list or (N, H, W, 3) array) -> (N, 2 * width)
        float32 numpy features."""
        arr = np.asarray(images_uint8)
        if arr.ndim == 3:
            arr = arr[None]
        out = []
        for i in range(0, len(arr), batch_size):
            x = torch.from_numpy(np.ascontiguousarray(arr[i:i + batch_size]))
            x = x.to(self.device).permute(0, 3, 1, 2).float() / 127.5 - 1.0
            out.append(self.forward(x).cpu().numpy())
        return np.concatenate(out, axis=0)


def kernels_from_jax(kernels, seed=0, device=None):
    """A ``RandomFeatureExtractor`` holding the given HWIO kernels (numpy
    arrays, e.g. the JAX extractor's ``_kernels``); its width is the last
    kernel's output channels."""
    kernels = [np.asarray(k, np.float32) for k in kernels]
    return RandomFeatureExtractor(seed=seed, width=kernels[-1].shape[-1],
                                  device=device, kernels=kernels)


class InceptionV3FeatureExtractor:
    """Canonical-scale FID extractor: torchvision InceptionV3 pooled
    features (2048-d) and class logits for IS, on ``device`` (default: the
    card, or the CPU under ``SR3_PLATFORM=cpu``).

    Weights, in order: ``weights=`` path (or ``SR3_INCEPTION_WEIGHTS``), a
    local torchvision ``inception_v3`` state_dict; torchvision's pretrained
    download where the machine has egress; else random init with a loud
    warning (scores then run-local, not on the published scale).
    ``weights=False`` asks for random init."""

    def __init__(self, weights=None, device=None):
        import logging
        import os

        from torchvision.models import inception_v3

        self.device = torch.device(device) if device is not None \
            else resolve_device()
        if weights is not False:
            weights = weights or os.environ.get("SR3_INCEPTION_WEIGHTS")
        net = inception_v3(weights=None, aux_logits=True, init_weights=False)
        self.canonical = False
        if weights is False:
            pass
        elif weights:
            net.load_state_dict(torch.load(weights, map_location="cpu"))
            self.canonical = True
        else:
            try:
                from torchvision.models import Inception_V3_Weights

                net = inception_v3(
                    weights=Inception_V3_Weights.IMAGENET1K_V1)
                self.canonical = True
            except Exception:
                logging.getLogger("base").warning(
                    "InceptionV3 weights unavailable (no local path, no "
                    "egress) — running with RANDOM init: FID/IS are NOT on "
                    "the published scale. Provide SR3_INCEPTION_WEIGHTS.")
        net.eval().to(self.device)
        self._net = net
        self._feats = None
        # the pooled features right before the classifier head
        net.avgpool.register_forward_hook(
            lambda m, i, o: setattr(self, "_feats", o))

    def _preprocess(self, arr):
        x = torch.from_numpy(
            np.ascontiguousarray(arr.transpose(0, 3, 1, 2))).float() / 255.0
        x = F.interpolate(x, size=(299, 299), mode="bilinear",
                          align_corners=False)
        mean = torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1)
        std = torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1)
        return ((x - mean) / std).to(self.device)

    def _run(self, images_uint8, batch_size):
        arr = np.asarray(images_uint8)
        if arr.ndim == 3:
            arr = arr[None]
        feats, logits = [], []
        with torch.no_grad():
            for i in range(0, len(arr), batch_size):
                out = self._net(self._preprocess(arr[i:i + batch_size]))
                logits.append(out.cpu().numpy())
                feats.append(torch.flatten(self._feats, 1).cpu().numpy())
        return np.concatenate(feats, 0), np.concatenate(logits, 0)

    def __call__(self, images_uint8, batch_size=32):
        """uint8 HWC images -> (N, 2048) pooled features."""
        return self._run(images_uint8, batch_size)[0]

    def features_and_logits(self, images_uint8, batch_size=32):
        """-> ((N, 2048) features, (N, 1000) logits) in one pass; the
        logits feed ``inception_score``."""
        return self._run(images_uint8, batch_size)
