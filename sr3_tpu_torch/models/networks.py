"""Network factory: config dict -> GaussianDiffusion over a UNet.

Counterpart of ``sr3_tpu/models/networks.py`` (``define_G``,
``count_params``; ``resolve_dtype`` lives in ``utils/runtime.py``).
``model.which_model_G`` ('sr3' or 'ddpm') is the ``cond_mode`` of both.
The UNet is built with a seeded init on the CPU, then moved to the device
in ``torch.channels_last`` memory with float32 parameters. The init follows
the JAX package's: with ``phase == "train"`` every Conv2d and Linear weight
is orthogonal with gain 1 (flax's ``orthogonal()``), otherwise
lecun-normal (flax's default ``lecun_normal``: a normal truncated at two
standard deviations, scaled to std 1/sqrt(fan_in)); every bias is zero and
GroupNorm keeps scale 1, bias 0. ``unet.remat``
turns on activation checkpointing of the UNet's blocks. ``unet.use_flash``
is ignored: it picks between the JAX package's materialized and flash
attention on a TPU, and the port runs its flash kernels at every length.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from sr3_tpu_torch.models.diffusion import GaussianDiffusion
from sr3_tpu_torch.models.unet import UNet
from sr3_tpu_torch.utils.runtime import resolve_device, resolve_dtype


def define_G(opt, device=None, seed=0) -> GaussianDiffusion:
    model_opt = opt["model"]
    cond_mode = model_opt["which_model_G"]  # 'sr3' | 'ddpm'
    unet_opt = model_opt["unet"]
    diff_opt = model_opt["diffusion"]
    device = torch.device(device) if device is not None else resolve_device()
    norm_groups = unet_opt.get("norm_groups") or 32

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        unet = UNet(
            in_channel=unet_opt["in_channel"],
            out_channel=unet_opt["out_channel"],
            inner_channel=unet_opt["inner_channel"],
            norm_groups=norm_groups,
            channel_mults=tuple(unet_opt["channel_multiplier"]),
            attn_res=tuple(unet_opt["attn_res"] or ()),
            res_blocks=unet_opt["res_blocks"],
            dropout=unet_opt.get("dropout", 0.0) or 0.0,
            image_size=diff_opt["image_size"],
            dtype=resolve_dtype(model_opt.get("dtype"), device),
            remat=bool(unet_opt.get("remat", False)),
            cond_mode=cond_mode,
        )
        init_weights(unet, "orthogonal" if opt.get("phase") == "train"
                     else "default")
    unet = unet.to(device=device, memory_format=torch.channels_last).eval()
    return GaussianDiffusion(
        unet,
        image_size=diff_opt["image_size"],
        channels=diff_opt.get("channels", 3) or 3,
        loss_type=diff_opt.get("loss_type", "l1") or "l1",
        conditional=diff_opt["conditional"],
        cond_mode=cond_mode,
    )


# std of a standard normal truncated at +-2 (flax's variance_scaling)
_TRUNC_STD = 0.87962566103423978


def init_weights(net, init_type):
    """Every Conv2d and Linear of ``net``: the weight orthogonal (gain 1) for
    ``init_type == "orthogonal"``, else lecun-normal; the bias zero. Draws
    from torch's default generator, in module order."""
    for m in net.modules():
        if not isinstance(m, (nn.Conv2d, nn.Linear)):
            continue
        with torch.no_grad():
            if init_type == "orthogonal":
                nn.init.orthogonal_(m.weight, gain=1.0)
            else:
                fan_in = m.weight[0].numel()  # in * kh * kw, or in
                std = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                      b=2 * std)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


def count_params(model) -> int:
    return sum(p.numel() for p in model.parameters())
