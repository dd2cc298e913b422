"""guided-diffusion's ADM UNet as a super-resolution model (torch.nn,
channels_last).

The network of Dhariwal & Nichol, *Diffusion Models Beat GANs on Image
Synthesis* (arXiv:2105.05233), as openai/guided-diffusion builds it for its
upsamplers (``script_util.sr_create_model`` -> ``unet.SuperResModel``): the
low-resolution image is upsampled bilinearly to the state's size and
concatenated after it; the network is conditioned on the integer timestep
and a class label; it outputs the noise estimate and, with ``learn_sigma``,
the variance's interpolation value v beside it. Parameter names follow
guided-diffusion's state dict (``time_embed.{0,2}``, ``label_emb``,
``input_blocks.N.M``, ``middle_block``, ``output_blocks``, ``out.{0,2}``;
in a ResBlock ``in_layers.{0,2}``, ``emb_layers.1``, ``out_layers.{0,3}``,
``skip_connection``; in an AttentionBlock ``norm``, ``qkv``, ``proj_out``,
the last two 1-D convs of weight (out, in, 1)), so its checkpoints load
with ``strict=True``.

- embedding: ``time_embed(tau(t)) + label_emb(y)``, tau(t) = [cos(t f) |
  sin(t f)], f_i = 10000^(-i/half); the whole embedding and every
  ResBlock's ``emb_layers`` in float32, as guided-diffusion keeps its
  linear layers in float32 under fp16;
- ResBlock (scale-shift): ``in_layers`` = GroupNorm -> SiLU -> conv3x3
  (kernel K1); (s, b) = ``emb_layers``(emb), scale first; ``out_layers`` =
  SiLU(GroupNorm(h) * (1 + s) + b) -> dropout -> conv3x3, plus the skip (the
  identity, or a 1x1 conv where the widths differ): K1 with the scale-shift
  after the norm (``post_scale`` / ``post_shift``) and the skip as its
  residual. A down / up ResBlock (``resblock_updown``) resamples inside:
  GroupNorm+SiLU (K2, or the statistics route on maps of 256^2 and up),
  avg-pool 2 or nearest x2, then a plain conv3x3, and the same resampling of
  x on the skip;
- AttentionBlock: GroupNorm (K2), a 1x1 conv to q, k, v laid out per head
  as [q | k | v] (guided-diffusion's ``QKVAttentionLegacy``), softmax(q k /
  sqrt(d)) v with the heads folded into the batch (kernel K4), a 1x1 conv,
  the residual;
- head: GroupNorm -> SiLU -> conv3x3 (K1).

The compute dtype is the module's ``dtype`` (bf16 on CUDA): activations
and convolutions in it, GroupNorm statistics and softmax in float32.
Spans (``utils/profiler.py``, recorded only under a profiler):
``unet.attention`` around each AttentionBlock (attrs ``heads``,
``tokens``), ``unet.resample`` around each down / up ResBlock. Counters:
``block.scale_shift``, the ResBlocks whose ``out_layers`` run in K1 (on
CUDA every one does). Training is not ported: a ResBlock in training mode
with dropout raises.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from sr3_tpu_torch.ops.attention import attention
from sr3_tpu_torch.ops.conv_fused import gn_silu_conv3x3
from sr3_tpu_torch.ops.groupnorm import group_norm
from sr3_tpu_torch.utils.profiler import Counter, span

CL = torch.channels_last
scale_shift_blocks = Counter("block.scale_shift")


def timestep_embedding(t, dim, max_period=10000):
    """(b,) timesteps -> (b, dim) float32 [cos | sin] of t * max_period^(-i /
    (dim / 2)), guided-diffusion's ``timestep_embedding``."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.reshape(-1).float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _conv(conv, x):
    """A Conv2d in x's dtype, output in channels_last memory."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    y = F.conv2d(x, conv.weight.to(x.dtype), bias, stride=conv.stride,
                 padding=conv.padding)
    return y.contiguous(memory_format=CL)


def _linear32(lin, x):
    """A Linear in float32 (its weight upcast where it is stored lower)."""
    return F.linear(x.float(), lin.weight.float(), lin.bias.float())


def _tokens_linear(conv1d, tokens):
    """A 1-D conv of kernel 1 over (b, n, c) tokens, in their dtype."""
    return F.linear(tokens, conv1d.weight[:, :, 0].to(tokens.dtype),
                    conv1d.bias.to(tokens.dtype))


class ResBlock(nn.Module):
    """guided-diffusion's ResBlock with ``use_scale_shift_norm`` (see the
    module docstring); ``up`` / ``down`` resample inside the block."""

    def __init__(self, channels, emb_channels, dropout_rate,
                 out_channels=None, up=False, down=False, groups=32):
        super().__init__()
        out = out_channels or channels
        self.groups, self.dropout = groups, dropout_rate
        self.up, self.down = up, down
        self.in_layers = nn.Sequential(nn.GroupNorm(groups, channels),
                                       nn.SiLU(),
                                       nn.Conv2d(channels, out, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(),
                                        nn.Linear(emb_channels, 2 * out))
        self.out_layers = nn.Sequential(
            nn.GroupNorm(groups, out), nn.SiLU(), nn.Dropout(dropout_rate),
            nn.Conv2d(out, out, 3, padding=1))
        self.skip_connection = (nn.Identity() if out == channels
                                else nn.Conv2d(channels, out, 1))

    def _resample(self, x):
        if self.down:
            return F.avg_pool2d(x, 2).contiguous(memory_format=CL)
        return F.interpolate(x, scale_factor=2, mode="nearest").contiguous(
            memory_format=CL)

    def forward(self, x, emb):
        if self.training and self.dropout:
            raise NotImplementedError("ADM training is not ported: a "
                                      "ResBlock takes no dropout")
        if not (self.up or self.down):
            return self._forward(x, emb)
        with span("unet.resample", x, kind="up" if self.up else "down"):
            return self._forward(x, emb)

    def _forward(self, x, emb):
        norm, conv = self.in_layers[0], self.in_layers[2]
        if self.up or self.down:
            h = group_norm(x, norm.weight, norm.bias, self.groups, swish=True)
            h = _conv(conv, self._resample(h))
            x = self._resample(x)
        else:
            h = gn_silu_conv3x3(x, norm.weight, norm.bias, conv.weight,
                                conv.bias, self.groups)
        scale, shift = _linear32(self.emb_layers[1], F.silu(emb)).chunk(2, 1)
        skip = (x if isinstance(self.skip_connection, nn.Identity)
                else _conv(self.skip_connection, x))
        norm, conv = self.out_layers[0], self.out_layers[3]
        scale_shift_blocks.n += 1
        return gn_silu_conv3x3(h, norm.weight, norm.bias, conv.weight,
                               conv.bias, self.groups, post_scale=scale,
                               post_shift=shift, residual=skip)


class AttentionBlock(nn.Module):
    """Multi-head self-attention over the map's pixels with residual;
    ``qkv``'s output channels are [q | k | v] per head, head by head."""

    def __init__(self, channels, num_heads, groups=32):
        super().__init__()
        if channels % num_heads:
            raise ValueError(f"{channels} channels in {num_heads} heads")
        self.groups, self.num_heads = groups, num_heads
        self.norm = nn.GroupNorm(groups, channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)

    def forward(self, x, emb=None):
        b, c, h, w = x.shape
        n, heads = h * w, self.num_heads
        d = c // heads
        with span("unet.attention", x, heads=heads, tokens=n):
            hn = group_norm(x, self.norm.weight, self.norm.bias, self.groups,
                            swish=False)
            tokens = hn.permute(0, 2, 3, 1).reshape(b, n, c)
            qkv = _tokens_linear(self.qkv, tokens).reshape(b, n, heads, 3, d)
            q, k, v = (qkv[:, :, :, i].transpose(1, 2).contiguous()
                       .view(b * heads, n, d) for i in range(3))
            o = attention(q, k, v, 1.0 / math.sqrt(d))  # float32
            o = o.reshape(b, heads, n, d).permute(0, 2, 1, 3).reshape(b, n, c)
            out = _tokens_linear(self.proj_out, o.to(x.dtype))
            out = x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return out.contiguous(memory_format=CL)


class EmbedSequential(nn.Sequential):
    """guided-diffusion's ``TimestepEmbedSequential``: layers in order, the
    embedding passed to those that take it."""

    def forward(self, x, emb):
        for layer in self:
            if isinstance(layer, nn.Conv2d):
                x = _conv(layer, x)
            else:
                x = layer(x, emb)
        return x


class ADMUNet(nn.Module):
    """forward(x (b, channels, H, W) state, timesteps (b,), low_res (b,
    channels, h, w), y (b,) class labels or None) ->
    (b, out_channels, H, W) float32, channels_last."""

    def __init__(self, image_size, in_channels, model_channels, out_channels,
                 num_res_blocks, attention_resolutions, dropout=0.0,
                 channel_mult=(1, 2, 4, 8), num_classes=None, num_heads=1,
                 num_head_channels=-1, norm_groups=32, dtype=torch.float32):
        super().__init__()
        self.image_size = image_size
        self.in_channels = in_channels
        self.model_channels = model_channels
        self.num_classes = num_classes
        self.groups = norm_groups
        self.dtype = dtype
        ted = model_channels * 4
        g = norm_groups

        def heads(ch):
            return ch // num_head_channels if num_head_channels > 0 \
                else num_heads

        self.time_embed = nn.Sequential(nn.Linear(model_channels, ted),
                                        nn.SiLU(), nn.Linear(ted, ted))
        self.label_emb = (nn.Embedding(num_classes, ted) if num_classes
                          else None)
        ch = input_ch = int(channel_mult[0] * model_channels)
        blocks = [EmbedSequential(nn.Conv2d(in_channels, ch, 3, padding=1))]
        chans, ds = [ch], 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock(ch, ted, dropout,
                                   int(mult * model_channels), groups=g)]
                ch = int(mult * model_channels)
                if ds in attention_resolutions:
                    layers.append(AttentionBlock(ch, heads(ch), g))
                blocks.append(EmbedSequential(*layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                blocks.append(EmbedSequential(
                    ResBlock(ch, ted, dropout, ch, down=True, groups=g)))
                chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)
        self.middle_block = EmbedSequential(
            ResBlock(ch, ted, dropout, groups=g),
            AttentionBlock(ch, heads(ch), g),
            ResBlock(ch, ted, dropout, groups=g))
        blocks = []
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [ResBlock(ch + chans.pop(), ted, dropout,
                                   int(model_channels * mult), groups=g)]
                ch = int(model_channels * mult)
                if ds in attention_resolutions:
                    layers.append(AttentionBlock(ch, heads(ch), g))
                if level and i == num_res_blocks:
                    layers.append(ResBlock(ch, ted, dropout, ch, up=True,
                                           groups=g))
                    ds //= 2
                blocks.append(EmbedSequential(*layers))
        self.output_blocks = nn.ModuleList(blocks)
        self.out = nn.Sequential(nn.GroupNorm(g, ch), nn.SiLU(),
                                 nn.Conv2d(input_ch, out_channels, 3,
                                           padding=1))

    def set_parallel(self, mesh):
        """The ADM runs on one device: a mesh of more than one rank on an
        axis raises."""
        if mesh is not None and any(a.size > 1 for a in
                                    (mesh.data, mesh.model, mesh.space)):
            raise NotImplementedError("the ADM UNet runs on one device")
        return []

    def forward(self, x, timesteps, low_res, y=None):
        if (y is None) != (self.label_emb is None):
            raise ValueError("class labels must be given exactly when the "
                             "network has a label embedding")
        up = F.interpolate(low_res.float(), size=tuple(x.shape[2:]),
                           mode="bilinear", align_corners=False)
        h = torch.cat([x.float(), up], 1)
        if h.shape[1] != self.in_channels:
            raise ValueError(f"expected {self.in_channels} input channels "
                             f"with the upsampled condition, got "
                             f"{h.shape[1]}")
        h = h.to(self.dtype).contiguous(memory_format=CL)
        te = self.time_embed
        emb = _linear32(te[2], F.silu(_linear32(
            te[0], timestep_embedding(timesteps, self.model_channels))))
        if self.label_emb is not None:
            emb = emb + F.embedding(y, self.label_emb.weight.float())
        hs = []
        for module in self.input_blocks:
            h = module(h, emb)
            hs.append(h)
        h = self.middle_block(h, emb)
        for module in self.output_blocks:
            h = torch.cat([h, hs.pop()], 1).contiguous(memory_format=CL)
            h = module(h, emb)
        norm, conv = self.out[0], self.out[2]
        return gn_silu_conv3x3(h, norm.weight, norm.bias, conv.weight,
                               conv.bias, self.groups).float()


def adm_from_opt(model_opt, dtype):
    """The ADM of a config's ``model`` group: ``unet`` holds
    guided-diffusion's flags (``in_channel`` the first conv's input
    channels, state and condition together; ``inner_channel``,
    ``channel_multiplier``, ``res_blocks``, ``attn_res`` as map sizes,
    ``num_head_channels``, ``num_classes``, ``dropout``, ``learn_sigma``,
    ``use_scale_shift_norm`` and ``resblock_updown``, which must be true)."""
    u = model_opt["unet"]
    size = model_opt["diffusion"]["image_size"]
    for flag in ("use_scale_shift_norm", "resblock_updown"):
        if not u.get(flag, True):
            raise NotImplementedError(f"the port's ADM takes {flag} true")
    channels = model_opt["diffusion"].get("channels", 3) or 3
    out = u["out_channel"]
    if out != channels * (2 if u.get("learn_sigma") else 1):
        raise ValueError(f"out_channel {out} for {channels} channels and "
                         f"learn_sigma {u.get('learn_sigma')}")
    return ADMUNet(
        image_size=size, in_channels=u["in_channel"],
        model_channels=u["inner_channel"], out_channels=out,
        num_res_blocks=u["res_blocks"],
        attention_resolutions=tuple(size // r for r in u["attn_res"] or ()),
        dropout=u.get("dropout") or 0.0,
        channel_mult=tuple(u["channel_multiplier"]),
        num_classes=u.get("num_classes"),
        num_heads=u.get("num_heads", 1),
        num_head_channels=u.get("num_head_channels", -1),
        norm_groups=u.get("norm_groups") or 32, dtype=dtype)
