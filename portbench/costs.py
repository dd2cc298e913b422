"""The yardstick's arithmetic: the card's peaks, the model's counted
FLOPs, and kernel K1's least time from its shapes.

FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode`` over
the reference network (``reference/unet.py``) on the meta device at batch
1: convolutions, linear layers and attention products; elementwise work
is not counted. A chain step counts one forward; a train step the loss's
forward and its backward, without any recompute.

K1 is the port's fused GroupNorm -> SiLU -> conv3x3 (its statistics launch
and its conv launch). Its least time at one call is the larger of its
bytes over the card's bandwidth and its operations over the bf16 peak:
each input read once (x, the conv weight and bias, the GroupNorm affine,
the level's shift, the residual) and the output written once, activations
and weights in bfloat16, vectors in float32.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.unet import Block, ResnetBlock, build

# published dense peaks (NVIDIA's H100 SXM data sheet), by the name
# torch.cuda.get_device_name() gives
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "bytes_per_s": 3.35e12},
}


def peaks_of(device_name):
    """The card's peaks, or None for a card the table does not hold."""
    return PEAKS.get(device_name)


def _meta_inputs(opt, batch):
    u, size = opt["model"]["unet"], opt["model"]["diffusion"]["image_size"]
    return (torch.zeros(batch, u["in_channel"], size, size, device="meta"),
            torch.zeros(batch, device="meta"))


def forward_flops(opt):
    """Counted FLOPs of one forward of one image."""
    net = build(opt, "meta")
    with FlopCounterMode(display=False) as fc:
        net(*_meta_inputs(opt, 1))
    return fc.get_total_flops()


def train_step_flops(opt):
    """Counted FLOPs of the loss and its backward for one image."""
    net = build(opt, "meta").requires_grad_(True)
    x, level = _meta_inputs(opt, 1)
    keep = lambda shape: torch.ones(shape, dtype=torch.bool, device="meta")
    with FlopCounterMode(display=False) as fc:
        pred = net(x, level, masks=keep)
        (pred - torch.zeros_like(pred)).abs().sum().backward()
    return fc.get_total_flops()


def k1_sites(opt, batch, training):
    """Every K1 call of one step of ``batch`` images: dicts of b, cin, h,
    w, cout and whether the call adds the level's shift and a residual.
    In training the dropout Blocks run no K1 (GroupNorm, dropout and a
    plain conv instead), and with remat every block's calls run again in
    the backward's recompute (the final Block's once)."""
    net = build(opt, "meta")
    u = opt["model"]["unet"]
    dropout = (u.get("dropout") or 0.0) > 0
    replay = 2 if training and u.get("remat") else 1
    second = {id(m.block2) for m in net.modules()
              if isinstance(m, ResnetBlock)}
    sites = []

    def hook(module, inputs, output):
        b, cin, h, w = inputs[0].shape
        inner = id(module) in second
        if training and inner and dropout:
            return
        site = {"b": b, "cin": cin, "h": h, "w": w, "cout": output.shape[1],
                "shift": inner, "residual": inner}
        sites.extend([site] * (1 if module is net.final_conv else replay))

    for m in net.modules():
        if isinstance(m, Block):
            m.register_forward_hook(hook)
    net(*_meta_inputs(opt, batch))
    return sites


def k1_bytes_and_flops(site):
    b, cin, h, w, cout = (site[k] for k in ("b", "cin", "h", "w", "cout"))
    act, vec = 2, 4
    nbytes = (b * cin * h * w * act + cout * cin * 9 * act + cout * vec
              + 2 * cin * vec + b * cout * h * w * act)
    if site["shift"]:
        nbytes += b * cin * vec
    if site["residual"]:
        nbytes += b * cout * h * w * act
    return nbytes, 2 * b * h * w * cout * cin * 9


def k1_least_seconds(sites, peaks):
    """The sum over ``sites`` of each call's least time on the card."""
    total = 0.0
    for site in sites:
        nbytes, flops = k1_bytes_and_flops(site)
        total += max(nbytes / peaks["bytes_per_s"],
                     flops / peaks["bf16_flops"])
    return total
