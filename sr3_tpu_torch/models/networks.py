"""Network factory: config dict -> GaussianDiffusion over a UNet.

Counterpart of ``sr3_tpu/models/networks.py`` (``define_G``,
``count_params``; ``resolve_dtype`` lives in ``utils/runtime.py``). The UNet
is built with a seeded init on the CPU, then moved to the device in
``torch.channels_last`` memory with float32 parameters. ``unet.remat``
turns on activation checkpointing of the UNet's blocks. ``unet.use_flash``
is ignored: it picks between the JAX package's materialized and flash
attention on a TPU, and the port runs its flash kernels at every length.
"""

from __future__ import annotations

import torch

from sr3_tpu_torch.models.diffusion import GaussianDiffusion
from sr3_tpu_torch.models.unet import UNet
from sr3_tpu_torch.utils.runtime import resolve_device, resolve_dtype


def define_G(opt, device=None, seed=0) -> GaussianDiffusion:
    model_opt = opt["model"]
    cond_mode = model_opt["which_model_G"]
    if cond_mode != "sr3":
        raise NotImplementedError(f"which_model_G {cond_mode!r} is not ported yet")
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
        )
    unet = unet.to(device=device, memory_format=torch.channels_last).eval()
    return GaussianDiffusion(
        unet,
        image_size=diff_opt["image_size"],
        channels=diff_opt.get("channels", 3) or 3,
        loss_type=diff_opt.get("loss_type", "l1") or "l1",
        conditional=diff_opt["conditional"],
        cond_mode=cond_mode,
    )


def count_params(model) -> int:
    return sum(p.numel() for p in model.parameters())
