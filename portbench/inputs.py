"""What the benchmark makes from ``--seed`` and hands to both sides: the
network's weights, the condition images of a chain, and the resident
training set. The same seed gives the same inputs."""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from portbench.reference.unet import build


def sub_seed(seed, tag):
    """A 63-bit seed for the stream ``tag`` of a run's ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def weight_shapes(opt):
    """(name, shape) of every parameter of the config's network, in the
    published state dict's names and order."""
    return [(n, tuple(p.shape))
            for n, p in build(opt, "meta").named_parameters()]


def make_weights(opt, seed, device):
    """Random float32 weights from one draw on ``device``: conv and linear
    weights N(0, 1 / fan_in), GroupNorm scales 1 + N(0, 0.1^2), biases and
    GroupNorm shifts N(0, 0.05^2). Returns {name: tensor}, views of one
    buffer."""
    shapes = weight_shapes(opt)
    total = sum(int(np.prod(s)) for _, s in shapes)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for name, shape in shapes:
        n = int(np.prod(shape))
        w = flat[off:off + n].view(shape)
        off += n
        if len(shape) >= 2:
            w.mul_(1.0 / np.sqrt(n // shape[0]))
        elif name.endswith("weight"):
            w.mul_(0.1).add_(1.0)
        else:
            w.mul_(0.05)
        out[name] = w
    return out


@torch.no_grad()
def load_weights(module, weights):
    """Copy ``weights`` into ``module``'s parameters of the same names;
    the two name sets and every shape must match."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        missing = sorted(set(weights) ^ set(params))[:5]
        raise ValueError(f"parameter names differ from the benchmark's "
                         f"weights: {missing}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise ValueError(f"{name}: shape {tuple(p.shape)}, the "
                             f"benchmark's {tuple(weights[name].shape)}")
        p.copy_(weights[name])


def condition_images(opt, batch, seed, device):
    """(batch, 3, H, W) float32 condition images in [-1, 1], channels-last:
    random low-resolution images upsampled bicubically, as an upsampled
    LR input is."""
    ds = opt["datasets"]["val"]
    size = opt["model"]["diffusion"]["image_size"]
    low = int(ds["l_resolution"])
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "cond"))
    lr = torch.rand((batch, 3, low, low), generator=g, device=device) * 2 - 1
    up = torch.nn.functional.interpolate(lr, size=(size, size),
                                         mode="bicubic", align_corners=False)
    return up.clamp(-1, 1).contiguous(memory_format=torch.channels_last)


def resident_arrays(opt, n, seed, device):
    """The resident training set: ``n`` pairs of uint8 (H, W, 3) images,
    made on ``device`` and returned as host arrays (what the program's
    ``load_device_dataset`` takes). Each HR image has a brightness, a
    contrast and a colour cast of its own over a smooth field (a random
    image at the LR size, repeated up) with fine detail, as photographs
    differ one from another; SR is its LR block means repeated back to H
    (a nearest upsample of the LR image)."""
    ds = opt["datasets"]["train"]
    size, low = int(ds["r_resolution"]), int(ds["l_resolution"])
    f = size // low
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "resident"))

    def draw(*shape):
        return torch.randn(shape, generator=g, device=device)

    one = (n, 1, 1, 1, 1)
    mean = 127.5 + 50 * draw(*one, 1).clamp(-1.75, 1.75) + 15 * draw(*one, 3)
    contrast = 15 + 55 * torch.rand(one + (1,), generator=g, device=device)
    hr = 0.5 * draw(n, low, f, low, f, 3) + draw(n, low, 1, low, 1, 3)
    hr = (hr * contrast + mean).clamp(0, 255)
    lr = hr.mean(dim=(2, 4), keepdim=True).round()
    sr = lr.expand(n, low, f, low, f, 3)
    return {k: v.round().to(torch.uint8).reshape(n, size, size, 3).cpu()
            .numpy() for k, v in (("HR", hr), ("SR", sr))}
