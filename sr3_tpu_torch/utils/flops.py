"""Counted model FLOPs of the port's UNet, for MFU.

``torch.utils.flop_counter.FlopCounterMode`` counts the convolutions,
linear layers and attention products of the plain composition (the plain
versions of K1, K2 and K4 swapped into ``models/unet.py``, as the parity
checks swap them) on the meta device, at batch 1 and float32: the work of
the model, whatever kernel computes it, so a kernel change cannot move the
count. Elementwise work (GroupNorm, SiLU, the chain's posterior, Adam) is
not counted. A train step counts ``p_losses`` and its backward with remat
off: the recompute is the implementation's, not the model's.

MFU = counted FLOPs / wall time / ``PEAK_BF16_FLOPS``.
"""

from __future__ import annotations

import contextlib
import copy

import torch
from torch.utils.flop_counter import FlopCounterMode

# one NVIDIA H100 SXM, dense bf16 tensor cores (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12


@contextlib.contextmanager
def plain_ops():
    """The plain versions of the kernels' wrappers swapped into the UNet
    module for the duration."""
    from sr3_tpu_torch.models import unet
    from sr3_tpu_torch.ops import attention, conv_fused, groupnorm

    plain = {"gn_silu_conv3x3": conv_fused.gn_silu_conv3x3_plain,
             "group_norm": groupnorm.group_norm_plain,
             "attention": attention.attention_plain}
    saved = {k: getattr(unet, k) for k in plain}
    try:
        for k, f in plain.items():
            setattr(unet, k, f)
        yield
    finally:
        for k, f in saved.items():
            setattr(unet, k, f)


def _meta_diffusion(opt):
    """``opt``'s GaussianDiffusion built on the meta device, float32, remat
    off."""
    from sr3_tpu_torch.models.networks import define_G

    opt = copy.deepcopy(opt)
    opt["model"]["dtype"] = "float32"
    with torch.device("meta"):
        diffusion = define_G(opt, device="meta")
    diffusion.denoise_fn.remat = False
    return diffusion


def forward_flops(opt):
    """FLOPs of one UNet forward of ``opt``'s model for one image: the work
    of one reverse-chain step."""
    diffusion = _meta_diffusion(opt)
    net = diffusion.denoise_fn.eval()
    size = diffusion.image_size
    x = torch.zeros(1, net.in_channel, size, size, device="meta")
    with plain_ops(), torch.no_grad(), FlopCounterMode(display=False) as fc:
        net(x, torch.zeros(1, device="meta"))
    return fc.get_total_flops()


def train_step_flops(opt):
    """FLOPs of ``p_losses`` (dropout on) and its backward for one image."""
    from sr3_tpu_torch.models.schedule import make_schedule

    diffusion = _meta_diffusion(opt)
    net = diffusion.denoise_fn.train()
    size = diffusion.image_size
    sched = make_schedule(opt["model"]["beta_schedule"]["train"], "meta")
    keys = ("HR", "SR") if diffusion.conditional else ("HR",)
    batch = {k: torch.zeros(1, diffusion.channels, size, size, device="meta")
             .contiguous(memory_format=torch.channels_last) for k in keys}
    with plain_ops(), FlopCounterMode(display=False) as fc:
        diffusion.p_losses(net, sched, batch).backward()
    return fc.get_total_flops()


def mfu(flops, seconds, device):
    """``flops`` done in ``seconds`` as a share of the card's bf16 peak;
    None off a CUDA device (no device share comes from a CPU run)."""
    if torch.device(device).type != "cuda" or not flops:
        return None
    return flops / seconds / PEAK_BF16_FLOPS
