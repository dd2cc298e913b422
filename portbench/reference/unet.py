"""The SR3 UNet in plain PyTorch: the benchmark's reference network.

Written from the published SR3 architecture (Saharia et al. 2021; the
layer names of Janspiry's Image-Super-Resolution-via-Iterative-Refinement
``model/sr3_modules/unet.py``), independent of the port: no kernel, no
cache, no batching trick. Every activation is float32 and NCHW. The
operands of each convolution, linear layer and attention product pass
through a ``Precision``, which is the identity for the reference and
rounds to float8 for the control that stands in for the program.

- noise level: sinusoidal encoding of the continuous sqrt-gamma, then
  Linear -> SiLU -> Linear (``noise_level_mlp.{1,3}``);
- ResnetBlock: block1 = GroupNorm -> SiLU -> conv3x3; the level's
  projection (``noise_func.noise_func.0``) added to block1's output; block2
  = GroupNorm -> SiLU -> dropout -> conv3x3; plus the input (through a 1x1
  conv where the widths differ);
- SelfAttention: GroupNorm, one 1x1 conv to q, k, v (in that channel
  order), single-head softmax(q k^T / sqrt(C)) v, 1x1 conv, residual;
- Downsample: conv3x3 stride 2; Upsample: nearest x2, then conv3x3.

Dropout masks come from a ``masks(shape)`` callable that the caller
passes, one call per dropout site in forward order; without it dropout
is off (sampling).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Precision:
    """Rounding of the operands of every product: ``float32`` (none),
    ``bfloat16``, or ``float8`` (e4m3, one scale a tensor from its
    largest magnitude). Gradients pass through the rounding unchanged."""

    NAMES = ("float32", "bfloat16", "float8")

    def __init__(self, name="float32"):
        if name not in self.NAMES:
            raise ValueError(f"precision must be one of {self.NAMES}, got "
                             f"{name!r}")
        self.name = name

    def __call__(self, t):
        if self.name == "float32" or t.device.type == "meta":
            return t
        with torch.no_grad():
            if self.name == "bfloat16":
                q = t.to(torch.bfloat16).float()
            else:
                scale = t.abs().amax().float().clamp_min(1e-30) / 448.0
                q = (t / scale).to(torch.float8_e4m3fn).float() * scale
        # the rounded value forward, the identity backward
        return t + (q - t).detach() if t.requires_grad else q


FP32 = Precision("float32")


def noise_level_encoding(level, dim):
    """(b,) noise level -> (b, dim): [sin | cos] of level * 1e4^(-i/(dim/2))."""
    half = dim // 2
    freq = torch.exp(-math.log(1e4) * torch.arange(
        half, dtype=torch.float32, device=level.device) / half)
    arg = level.reshape(-1, 1).float() * freq[None]
    return torch.cat([torch.sin(arg), torch.cos(arg)], dim=1)


def conv(layer, x, prec, stride=1, padding=None):
    k = layer.weight.shape[-1]
    bias = layer.bias
    return F.conv2d(prec(x), prec(layer.weight), bias, stride=stride,
                    padding=k // 2 if padding is None else padding)


def linear(layer, x, prec):
    return F.linear(prec(x), prec(layer.weight), layer.bias)


class Block(nn.Module):
    """GroupNorm -> SiLU -> (dropout) -> conv3x3; ``block.0`` is the norm
    and ``block.3`` the conv, as in the published state dict."""

    def __init__(self, dim, dim_out, groups, dropout=0.0):
        super().__init__()
        self.groups = groups
        self.dropout = dropout
        self.block = nn.Sequential(nn.GroupNorm(groups, dim), nn.SiLU(),
                                   nn.Identity(),
                                   nn.Conv2d(dim, dim_out, 3, padding=1))

    def forward(self, x, prec, masks=None):
        norm = self.block[0]
        h = F.silu(F.group_norm(x, self.groups, norm.weight, norm.bias,
                                eps=1e-5))
        if masks is not None and self.dropout > 0:
            keep = 1.0 - self.dropout
            h = torch.where(masks(tuple(h.shape)), h / keep,
                            torch.zeros((), device=h.device))
        return conv(self.block[3], h, prec)


class FeatureWiseAffine(nn.Module):
    def __init__(self, dim, dim_out):
        super().__init__()
        self.noise_func = nn.Sequential(nn.Linear(dim, dim_out))


class ResnetBlock(nn.Module):
    def __init__(self, dim, dim_out, emb_dim, groups, dropout):
        super().__init__()
        self.noise_func = FeatureWiseAffine(emb_dim, dim_out)
        self.block1 = Block(dim, dim_out, groups)
        self.block2 = Block(dim_out, dim_out, groups, dropout)
        self.res_conv = (nn.Conv2d(dim, dim_out, 1) if dim != dim_out
                         else None)

    def forward(self, x, emb, prec, masks=None):
        h = self.block1(x, prec)
        shift = linear(self.noise_func.noise_func[0], emb, prec)
        h = self.block2(h + shift[:, :, None, None], prec, masks)
        skip = x if self.res_conv is None else conv(self.res_conv, x, prec)
        return h + skip


class SelfAttention(nn.Module):
    def __init__(self, dim, groups):
        super().__init__()
        self.groups = groups
        self.norm = nn.GroupNorm(groups, dim)
        self.qkv = nn.Conv2d(dim, dim * 3, 1, bias=False)
        self.out = nn.Conv2d(dim, dim, 1)

    def forward(self, x, prec):
        b, c, h, w = x.shape
        n = F.group_norm(x, self.groups, self.norm.weight, self.norm.bias,
                         eps=1e-5)
        qkv = conv(self.qkv, n, prec).reshape(b, 3, c, h * w)
        q, k, v = (qkv[:, i].transpose(1, 2) for i in range(3))  # (b, hw, c)
        scores = torch.matmul(prec(q), prec(k).transpose(1, 2)) / math.sqrt(c)
        probs = torch.softmax(scores, dim=-1)
        o = torch.matmul(prec(probs), prec(v))
        o = o.transpose(1, 2).reshape(b, c, h, w)
        return x + conv(self.out, o, prec)


class ResnetBlocWithAttn(nn.Module):
    def __init__(self, dim, dim_out, emb_dim, groups, dropout, with_attn):
        super().__init__()
        self.res_block = ResnetBlock(dim, dim_out, emb_dim, groups, dropout)
        self.attn = SelfAttention(dim_out, groups) if with_attn else None

    def forward(self, x, emb, prec, masks=None):
        x = self.res_block(x, emb, prec, masks)
        return x if self.attn is None else self.attn(x, prec)


class Downsample(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, 2, 1)

    def forward(self, x, prec):
        return conv(self.conv, x, prec, stride=2, padding=1)


class Upsample(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, x, prec):
        return conv(self.conv, F.interpolate(x, scale_factor=2,
                                             mode="nearest"), prec)


class UNet(nn.Module):
    """forward(x (b, in_channel, H, W), level (b,)) -> eps (b, out_channel,
    H, W), float32."""

    def __init__(self, in_channel, out_channel, inner_channel, norm_groups,
                 channel_mults, attn_res, res_blocks, dropout, image_size):
        super().__init__()
        ic = inner_channel
        self.noise_level_mlp = nn.Sequential(
            nn.Identity(), nn.Linear(ic, ic * 4), nn.SiLU(),
            nn.Linear(ic * 4, ic))
        self.inner_channel = ic

        def block(dim, dim_out, res):
            return ResnetBlocWithAttn(dim, dim_out, ic, norm_groups, dropout,
                                      res in attn_res)

        res, pre = image_size, ic
        skips = [pre]
        downs = [nn.Conv2d(in_channel, ic, 3, padding=1)]
        for i, mult in enumerate(channel_mults):
            for _ in range(res_blocks):
                downs.append(block(pre, ic * mult, res))
                pre = ic * mult
                skips.append(pre)
            if i < len(channel_mults) - 1:
                downs.append(Downsample(pre))
                skips.append(pre)
                res //= 2
        self.downs = nn.ModuleList(downs)
        self.mid = nn.ModuleList([
            ResnetBlocWithAttn(pre, pre, ic, norm_groups, dropout, True),
            ResnetBlocWithAttn(pre, pre, ic, norm_groups, dropout, False)])
        ups = []
        for i, mult in reversed(list(enumerate(channel_mults))):
            for _ in range(res_blocks + 1):
                ups.append(block(pre + skips.pop(), ic * mult, res))
                pre = ic * mult
            if i > 0:
                ups.append(Upsample(pre))
                res *= 2
        self.ups = nn.ModuleList(ups)
        self.final_conv = Block(pre, out_channel, norm_groups)

    def forward(self, x, level, prec=FP32, masks=None):
        mlp = self.noise_level_mlp
        e = noise_level_encoding(level, self.inner_channel)
        emb = linear(mlp[3], F.silu(linear(mlp[1], e, prec)), prec)
        x = conv(self.downs[0], x.float(), prec)
        feats = [x]
        for layer in self.downs[1:]:
            x = (layer(x, emb, prec, masks)
                 if isinstance(layer, ResnetBlocWithAttn) else layer(x, prec))
            feats.append(x)
        for layer in self.mid:
            x = layer(x, emb, prec, masks)
        for layer in self.ups:
            if isinstance(layer, ResnetBlocWithAttn):
                x = layer(torch.cat([x, feats.pop()], 1), emb, prec, masks)
            else:
                x = layer(x, prec)
        return self.final_conv(x, prec)


def build(opt, device="cpu"):
    """The reference UNet of a config dict (``model.unet``,
    ``model.diffusion.image_size``), parameters uninitialised (float32)."""
    model = opt["model"]
    if model.get("which_model_G", "sr3") != "sr3":
        raise ValueError("the reference UNet is the sr3 network")
    u = model["unet"]
    with torch.device(device):
        return UNet(u["in_channel"], u["out_channel"], u["inner_channel"],
                    u.get("norm_groups") or 32,
                    tuple(u["channel_multiplier"]), tuple(u["attn_res"] or ()),
                    u["res_blocks"], u.get("dropout") or 0.0,
                    model["diffusion"]["image_size"]).requires_grad_(False)
