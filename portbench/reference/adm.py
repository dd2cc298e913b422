"""guided-diffusion's ADM super-resolution model and its respaced,
learned-variance ancestral step in plain PyTorch: the benchmark's reference
for the ``adm_sample`` cells.

Written from the published ADM (Dhariwal & Nichol 2021, arXiv:2105.05233;
openai/guided-diffusion ``unet.py`` ``SuperResModel``, ``UNetModel``,
``ResBlock`` with ``use_scale_shift_norm`` and ``resblock_updown``,
``AttentionBlock`` with ``QKVAttentionLegacy``; ``respace.py``
``space_timesteps`` and ``SpacedDiffusion``; ``gaussian_diffusion.py``
``p_mean_variance`` with ``LEARNED_RANGE`` and ``p_sample``), under the
published state dict's names, independent of the port: no kernel, no
fusion. Every activation is float32 and NCHW, TF32 is off, and the
operands of each convolution, linear layer and attention product pass
through a ``Precision`` (``reference/unet.py``): the identity for the
reference, float8 for the control.

Also: the FLOPs of one forward (``forward_flops``, FlopCounterMode on the
meta device) and the calls of the port's fused GroupNorm -> SiLU ->
conv3x3 kernel a forward makes (``k1_sites``, in ``costs.k1_sites``'s dict
format): every ResBlock's ``out_layers``, every ``in_layers`` but those of
the resampling ResBlocks, and the head.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.diffusion import betas as beta_schedule
from portbench.reference.unet import FP32

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def timestep_embedding(t, dim):
    """(b,) timesteps -> (b, dim) [cos | sin] of t * 1e4^(-i / (dim / 2))."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.reshape(-1).float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=1)


def conv(layer, x, prec):
    k = layer.weight.shape[-1]
    op = F.conv1d if layer.weight.dim() == 3 else F.conv2d
    return op(prec(x), prec(layer.weight), layer.bias, padding=k // 2)


def linear(layer, x, prec):
    return F.linear(prec(x), prec(layer.weight), layer.bias)


def norm(layer, x):
    return F.group_norm(x, layer.num_groups, layer.weight, layer.bias,
                        eps=layer.eps)


class ResBlock(nn.Module):
    """in_layers (GroupNorm, SiLU, conv3x3; resampling between SiLU and the
    conv in an up / down block, and on x), emb_layers (SiLU, Linear to the
    scale and the shift), out_layers (GroupNorm, * (1 + scale) + shift,
    SiLU, dropout, conv3x3), skip_connection."""

    def __init__(self, ch, emb, out=None, up=False, down=False):
        super().__init__()
        out = out or ch
        self.up, self.down = up, down
        self.in_layers = nn.Sequential(nn.GroupNorm(32, ch), nn.SiLU(),
                                       nn.Conv2d(ch, out, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb, 2 * out))
        self.out_layers = nn.Sequential(nn.GroupNorm(32, out), nn.SiLU(),
                                        nn.Dropout(0.0),
                                        nn.Conv2d(out, out, 3, padding=1))
        self.skip_connection = (nn.Identity() if out == ch
                                else nn.Conv2d(ch, out, 1))

    def resample(self, x):
        if self.up:
            return F.interpolate(x, scale_factor=2, mode="nearest")
        return F.avg_pool2d(x, 2) if self.down else x

    def forward(self, x, emb, prec):
        h = F.silu(norm(self.in_layers[0], x))
        h = conv(self.in_layers[2], self.resample(h), prec)
        x = self.resample(x)
        scale, shift = linear(self.emb_layers[1], F.silu(emb),
                              prec).chunk(2, dim=1)
        h = norm(self.out_layers[0], h) * (1 + scale[:, :, None, None]) \
            + shift[:, :, None, None]
        h = conv(self.out_layers[3], F.silu(h), prec)
        skip = (x if isinstance(self.skip_connection, nn.Identity)
                else conv(self.skip_connection, x, prec))
        return skip + h


class AttentionBlock(nn.Module):
    """GroupNorm, qkv (a 1-D conv; per head [q | k | v] of head_dim each),
    softmax(q k^T / sqrt(head_dim)) v a head, proj_out, the residual."""

    def __init__(self, ch, heads):
        super().__init__()
        self.heads = heads
        self.norm = nn.GroupNorm(32, ch)
        self.qkv = nn.Conv1d(ch, 3 * ch, 1)
        self.proj_out = nn.Conv1d(ch, ch, 1)

    def forward(self, x, emb, prec):
        b, c, h, w = x.shape
        flat = x.reshape(b, c, h * w)
        qkv = conv(self.qkv, norm(self.norm, flat), prec)
        d = c // self.heads
        q, k, v = qkv.reshape(b * self.heads, 3 * d, h * w).split(d, dim=1)
        scores = torch.einsum("bct,bcs->bts", prec(q), prec(k)) / math.sqrt(d)
        probs = torch.softmax(scores, dim=-1)
        a = torch.einsum("bts,bcs->bct", prec(probs), prec(v))
        out = conv(self.proj_out, a.reshape(b, c, h * w), prec)
        return (flat + out).reshape(b, c, h, w)


class Seq(nn.Sequential):
    def forward(self, x, emb, prec):
        for layer in self:
            x = (conv(layer, x, prec) if isinstance(layer, nn.Conv2d)
                 else layer(x, emb, prec))
        return x


class SuperResUNet(nn.Module):
    """forward(x (b, 3, H, W), t (b,) original timesteps, low_res (b, 3,
    h, w), y (b,) labels or None) -> (b, out, H, W): the noise estimate,
    then v where the variance is learned."""

    def __init__(self, size, in_ch, mc, out_ch, n_res, attn_ds, mult,
                 n_classes, head_ch):
        super().__init__()
        emb = 4 * mc
        self.mc = mc
        self.time_embed = nn.Sequential(nn.Linear(mc, emb), nn.SiLU(),
                                        nn.Linear(emb, emb))
        self.label_emb = nn.Embedding(n_classes, emb) if n_classes else None
        ch = mc * mult[0]
        blocks, chans, ds = [Seq(nn.Conv2d(in_ch, ch, 3, padding=1))], [ch], 1
        for level, m in enumerate(mult):
            for _ in range(n_res):
                layers = [ResBlock(ch, emb, mc * m)]
                ch = mc * m
                if ds in attn_ds:
                    layers.append(AttentionBlock(ch, ch // head_ch))
                blocks.append(Seq(*layers))
                chans.append(ch)
            if level < len(mult) - 1:
                blocks.append(Seq(ResBlock(ch, emb, down=True)))
                chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)
        self.middle_block = Seq(ResBlock(ch, emb),
                                AttentionBlock(ch, ch // head_ch),
                                ResBlock(ch, emb))
        blocks = []
        for level, m in list(enumerate(mult))[::-1]:
            for i in range(n_res + 1):
                layers = [ResBlock(ch + chans.pop(), emb, mc * m)]
                ch = mc * m
                if ds in attn_ds:
                    layers.append(AttentionBlock(ch, ch // head_ch))
                if level and i == n_res:
                    layers.append(ResBlock(ch, emb, up=True))
                    ds //= 2
                blocks.append(Seq(*layers))
        self.output_blocks = nn.ModuleList(blocks)
        self.out = nn.Sequential(nn.GroupNorm(32, ch), nn.SiLU(),
                                 nn.Conv2d(mc * mult[0], out_ch, 3,
                                           padding=1))

    def forward(self, x, t, low_res, y=None, prec=FP32):
        up = F.interpolate(low_res.float(), size=tuple(x.shape[2:]),
                           mode="bilinear", align_corners=False)
        h = torch.cat([x.float(), up], dim=1)
        te = self.time_embed
        emb = linear(te[2], F.silu(linear(
            te[0], timestep_embedding(t, self.mc), prec)), prec)
        if self.label_emb is not None:
            emb = emb + self.label_emb.weight[y]
        hs = []
        for block in self.input_blocks:
            h = block(h, emb, prec)
            hs.append(h)
        h = self.middle_block(h, emb, prec)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb, prec)
        return conv(self.out[2], F.silu(norm(self.out[0], h)), prec)


def build(opt, device="cpu"):
    """The reference network of a config dict (``model.unet`` with
    guided-diffusion's flags, ``attn_res`` as map sizes;
    ``model.diffusion.image_size``), parameters uninitialised (float32)."""
    model = opt["model"]
    if model.get("which_model_G") != "adm":
        raise ValueError("the ADM reference takes which_model_G 'adm'")
    u, size = model["unet"], model["diffusion"]["image_size"]
    with torch.device(device):
        return SuperResUNet(
            size, u["in_channel"], u["inner_channel"], u["out_channel"],
            u["res_blocks"], tuple(size // r for r in u["attn_res"]),
            tuple(u["channel_multiplier"]), u.get("num_classes"),
            u["num_head_channels"]).requires_grad_(False)


def space_timesteps(num_timesteps, count):
    """The kept timesteps of ``space_timesteps(num_timesteps, str(count))``
    (one section): round(i * (T - 1) / (count - 1)), the stride added up."""
    stride = (num_timesteps - 1) / (count - 1) if count > 1 else 1
    cur, kept = 0.0, []
    for _ in range(count):
        kept.append(round(cur))
        cur += stride
    return sorted(set(kept))


class Schedule:
    """The respaced schedule's tables (float64 numpy cast to float32 on
    ``device``): betas 1 - abar_k / abar_prev over the kept steps, their
    posterior, log beta and the learned range's lower end, log of the
    posterior variance with step 0's taken from step 1 (guided-diffusion's
    ``posterior_log_variance_clipped``), and ``timestep_map``."""

    def __init__(self, opt, device):
        full = beta_schedule(opt)
        kept = space_timesteps(len(full), int(opt["timestep_respacing"]))
        abar_full = np.cumprod(1.0 - full)[kept]
        b = 1.0 - abar_full / np.append(1.0, abar_full[:-1])
        a = np.cumprod(1.0 - b)
        a_prev = np.append(1.0, a[:-1])
        var = b * (1.0 - a_prev) / (1.0 - a)
        tables = {
            "sqrt_recip": np.sqrt(1.0 / a),
            "sqrt_recipm1": np.sqrt(1.0 / a - 1.0),
            "coef1": b * np.sqrt(a_prev) / (1.0 - a),
            "coef2": (1.0 - a_prev) * np.sqrt(1.0 - b) / (1.0 - a),
            "min_log": np.log(np.append(var[1], var[1:])),
            "max_log": np.log(b),
        }
        for k, v in tables.items():
            setattr(self, k, torch.from_numpy(v.astype(np.float32)).to(device))
        self.timestep_map = torch.tensor(kept, dtype=torch.long,
                                         device=device)
        self.T = len(b)


def chain_out(unet, sched, low_res, labels, x, t, prec):
    """The network's output (eps, then v) at respaced step ``t``."""
    ts = sched.timestep_map[t].expand(x.shape[0])
    return unet(x, ts, low_res, labels, prec)


def chain_step(sched, x, t, out, noise):
    """x_{t-1} from x_t and the network's output (eps and v): the clipped
    x0, the posterior mean, and the learned-range variance; ``noise`` is
    unused at t = 0."""
    c = x.shape[1]
    eps, v = out[:, :c], out[:, c:]
    x0 = (sched.sqrt_recip[t] * x - sched.sqrt_recipm1[t] * eps).clamp(-1, 1)
    mean = sched.coef1[t] * x0 + sched.coef2[t] * x
    if t == 0:
        return mean
    frac = (v + 1) / 2
    log_var = frac * sched.max_log[t] + (1 - frac) * sched.min_log[t]
    return mean + torch.exp(0.5 * log_var) * noise


def _meta_inputs(opt, batch):
    model = opt["model"]
    size = model["diffusion"]["image_size"]
    low = opt["datasets"]["val"]["l_resolution"]
    y = (torch.zeros(batch, dtype=torch.long, device="meta")
         if model["unet"].get("num_classes") else None)
    return (torch.zeros(batch, 3, size, size, device="meta"),
            torch.zeros(batch, device="meta"),
            torch.zeros(batch, 3, low, low, device="meta"), y)


def forward_flops(opt):
    """Counted FLOPs of one forward of one image (convolutions, linear
    layers, attention products)."""
    net = build(opt, "meta")
    with FlopCounterMode(display=False) as fc:
        net(*_meta_inputs(opt, 1))
    return fc.get_total_flops()


def k1_sites(opt, batch):
    """The fused-kernel calls of one forward of ``batch`` images, in the
    dict format of ``costs.k1_sites`` (b, cin, h, w, cout, ``shift``,
    ``residual``): each ResBlock's ``in_layers`` but a resampling one's, its
    ``out_layers`` (with the skip as its residual; its per-(b, c) scale and
    shift are the ``shift`` the cost model reads as one vector, and
    ``post`` marks them), then the head."""
    net = build(opt, "meta")
    sites = []

    def site(shape, cout, post):
        b, cin, h, w = shape
        sites.append({"b": b, "cin": cin, "h": h, "w": w, "cout": cout,
                      "shift": post, "residual": post, "post": post})

    def hook(block, args, output):
        if not (block.up or block.down):
            site(args[0].shape, output.shape[1], False)
        site(output.shape, output.shape[1], True)

    for m in net.modules():
        if isinstance(m, ResBlock):
            m.register_forward_hook(hook)
    inputs = _meta_inputs(opt, batch)
    net(*inputs)
    size = inputs[0].shape[2]
    site((batch, net.out[0].num_channels, size, size),
         net.out[2].out_channels, False)
    return sites
