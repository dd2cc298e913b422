"""Epsilon-prediction UNet (torch.nn, channels_last).

Counterpart of ``sr3_tpu/models/unet.py``, with its ``cond_mode`` switch:

- ``'sr3'``: continuous noise-level input (sqrt-gamma), additive FiLM
  injected between the two Blocks of each ResnetBlock;
- ``'ddpm'``: float timestep input, the embedding through SiLU (in float32)
  and a Linear per ResnetBlock, added at the same place.

Both run the same positional encoding in float32, single-head attention,
and no affine FiLM variant (the JAX package's network factory never turns it
on). Module names follow the reference state_dict that
``sr3_tpu_torch.utils.torch_compat.build_key_map`` enumerates (``downs.{i}``,
``mid.{i}``, ``ups.{i}``, ``final_conv``; ``noise_level_mlp.{1,3}`` and
``noise_func.noise_func.0`` in sr3 mode, ``time_mlp.{1,3}`` and ``mlp.1`` in
ddpm mode), so reference ``.pth`` files and exported JAX weights load with
``strict=True``.

Tensors are logical NCHW in ``torch.channels_last`` memory (physically NHWC,
like the JAX package). The compute dtype is the input's: ``UNet.forward``
casts to ``UNet.dtype`` once and every layer keeps it; parameters are cast
to it where they are used (no-ops when the caller pre-cast them). Every
Block runs kernel K1 and every SelfAttention kernels K2 and K4 (K5 and K6
in the backward); in training a Block with dropout runs K2, the dropout and
a plain conv instead, as the JAX package's Block does. The stem, down/up-
sample convs, 1x1 convs and Linear layers are plain torch, as the JAX
package leaves them to XLA. The dropout draws come from the generator passed
to ``UNet.forward``, the role of ``rngs={"dropout": ...}`` in JAX. GroupNorm
on maps of 256^2 and more takes the statistics route (kernel K3, see
``ops/groupnorm.py``).

With ``remat`` (the JAX package's ``nn.remat`` around every
``ResnetBlocWithAttn``), a forward under autograd keeps only each block's
inputs and recomputes its activations in the backward
(``torch.utils.checkpoint``, non-reentrant). The recompute replays the
block's dropout draws: it runs on a copy of the generator taken at the
block's start, so it draws the same masks and leaves the generator where
the first forward left it. The kernels launch again in the recompute, and
their counters count it, as do the counters of Blocks by route
(``block.fused``: K1; ``block.split``: GroupNorm, dropout and a plain conv;
``utils/profiler.py``).

``UNet.set_parallel(mesh)`` lays the network out on a mesh
(``sr3_tpu_torch/parallel``): on the model axis every conv / linear /
GroupNorm whose output channels the axis divides keeps its slice and
gathers its output (``sharding_rules.py``); on the space axis every level
whose height the axis divides into shards of 2+ rows runs H-sharded
(``spatial.py``): K1 through its halo entry, the dropout Blocks' and
attention's GroupNorm on all-reduced K3 statistics, the plain 3x3 convs
with halo rows, attention (K4-K6) on the gathered tokens; other levels run
whole. The forward still takes and returns the whole map on every rank.
"""


from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from sr3_tpu_torch.ops.attention import attention
from sr3_tpu_torch.ops.conv_fused import (gn_silu_conv3x3,
                                          gn_silu_conv3x3_space)
from sr3_tpu_torch.ops.dropout import dropout
from sr3_tpu_torch.ops.groupnorm import group_norm, group_norm_space
from sr3_tpu_torch.parallel import sharding_rules as tp
from sr3_tpu_torch.parallel import spatial
from sr3_tpu_torch.utils.profiler import Counter

CL = torch.channels_last
# Blocks run through K1, and through GroupNorm -> dropout -> conv
fused_blocks = Counter("block.fused")
split_blocks = Counter("block.split")


def positional_encoding(cond, dim):
    """(b,) noise level or timestep -> (b, dim) [sin || cos] in float32,
    freq_i = 1e4^(-i/(dim/2))."""
    count = dim // 2
    cond = cond.reshape(-1).float()
    step = torch.arange(count, dtype=torch.float32, device=cond.device) / count
    enc = cond[:, None] * torch.exp(-math.log(1e4) * step[None, :])
    return torch.cat([torch.sin(enc), torch.cos(enc)], dim=-1)


def _conv(conv, x, space=None):
    """nn.Conv2d applied in x's dtype, output in channels_last memory. A 3x3
    conv of an H-shard (``space``: the space axis) takes its halo rows
    (``spatial.halo_conv2d``); a conv sharded over ``model`` computes its
    output channels and gathers them (``parallel/sharding_rules.py``)."""
    axis = getattr(conv, "tp", None)
    x = tp.copy_in(x, axis)
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    if space is not None and conv.kernel_size == (3, 3):
        y = spatial.halo_conv2d(x, conv.weight.to(x.dtype), bias, space,
                                stride=conv.stride[0])
    else:
        y = F.conv2d(x, conv.weight.to(x.dtype), bias, stride=conv.stride,
                     padding=conv.padding)
    y = y.contiguous(memory_format=CL)
    return y if axis is None else tp.gather_channels(y, axis)


def _linear(lin, x):
    axis = getattr(lin, "tp", None)
    y = F.linear(tp.copy_in(x, axis), lin.weight.to(x.dtype),
                 lin.bias.to(x.dtype))
    return y if axis is None else tp.gather_channels(y, axis, -1)


def _affine(norm):
    """A GroupNorm's (weight, bias), whole (gathered when sharded)."""
    return tp.gather_param(norm.weight, norm), tp.gather_param(norm.bias, norm)


class PositionalEncoding(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.dim = dim

    def forward(self, noise_level):
        return positional_encoding(noise_level, self.dim)


class FeatureWiseAffine(nn.Module):
    """Noise-level embedding -> per-(batch, channel) additive FiLM, the
    pre-bias of block2 (reference name noise_func.noise_func.0)."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.noise_func = nn.Sequential(nn.Linear(in_channels, out_channels))

    def forward(self, emb):
        return _linear(self.noise_func[0], emb)


class Block(nn.Module):
    """GroupNorm -> SiLU -> Dropout -> Conv3x3. The Sequential holds the
    parameters under the reference names (norm at .block.0, conv at
    .block.3); forward runs the fused op (kernel K1), with the ResnetBlock's
    conditioning as its pre-affine and the skip as its residual. With
    dropout active (training) it runs the pre-affine in x's dtype, GroupNorm
    +SiLU (kernel K2), dropout, then a plain conv3x3 + bias and the
    residual."""

    space = None  # the space axis when this Block's level is H-sharded

    def __init__(self, dim, dim_out, groups=32, dropout=0.0):
        super().__init__()
        self.groups = groups
        self.dropout = dropout
        self.block = nn.Sequential(
            nn.GroupNorm(groups, dim), nn.SiLU(),
            nn.Dropout(dropout) if dropout else nn.Identity(),
            nn.Conv2d(dim, dim_out, 3, padding=1),
        )

    def forward(self, x, pre_bias=None, residual=None, generator=None):
        norm, conv = self.block[0], self.block[3]
        gw, gb = _affine(norm)
        if not (self.training and self.dropout):
            fused_blocks.n += 1
            axis = getattr(conv, "tp", None)
            if axis is not None:
                # the output channel slice of the sharded weight, from the
                # whole input, then gathered
                x, gw, gb, pre_bias = (tp.copy_in(t, axis)
                                       for t in (x, gw, gb, pre_bias))
                if residual is not None:
                    residual = tp.slice_channels(tp.copy_in(residual, axis),
                                                 axis)
            if self.space is not None:
                y = gn_silu_conv3x3_space(
                    x, gw, gb, conv.weight, conv.bias, self.groups,
                    self.space, pre_bias=pre_bias, residual=residual)
            else:
                y = gn_silu_conv3x3(
                    x, gw, gb, conv.weight, conv.bias, self.groups,
                    pre_bias=pre_bias, residual=residual)
            return y if axis is None else tp.gather_channels(y, axis)
        split_blocks.n += 1
        if pre_bias is not None:
            x = x + pre_bias[:, :, None, None].to(x.dtype)
        x = x.contiguous(memory_format=CL)
        rows = None
        if self.space is not None:
            h = group_norm_space(x, gw, gb, self.groups, self.space,
                                 swish=True)
            h_full = x.shape[2] * self.space.size
            rows = (spatial.row_slice(h_full, self.space), h_full)
        else:
            h = group_norm(x, gw, gb, self.groups, swish=True)
        y = _conv(conv, dropout(h, self.dropout, generator, rows),
                  space=self.space)
        return y if residual is None else y + residual.to(y.dtype)


class ResnetBlock(nn.Module):
    """block1, the conditioning projection (sr3: ``noise_func``; ddpm:
    ``mlp`` = SiLU on the float32 embedding, then Linear), block2 with that
    projection as its pre-bias and the (1x1-projected) input as its
    residual."""

    def __init__(self, dim, dim_out, noise_level_emb_dim=None, dropout=0.0,
                 norm_groups=32, cond_mode="sr3"):
        super().__init__()
        self.cond_mode = cond_mode
        if cond_mode == "ddpm":
            self.mlp = nn.Sequential(nn.SiLU(),
                                     nn.Linear(noise_level_emb_dim, dim_out))
        else:
            self.noise_func = FeatureWiseAffine(noise_level_emb_dim, dim_out)
        self.block1 = Block(dim, dim_out, groups=norm_groups)
        self.block2 = Block(dim_out, dim_out, groups=norm_groups,
                            dropout=dropout)
        self.res_conv = (nn.Conv2d(dim, dim_out, 1) if dim != dim_out
                         else nn.Identity())

    def forward(self, x, emb, generator=None):
        h = self.block1(x)
        if self.cond_mode == "ddpm":
            pre_bias = _linear(self.mlp[1], F.silu(emb.float()).to(emb.dtype))
        else:
            pre_bias = self.noise_func(emb)
        skip = (_conv(self.res_conv, x)
                if isinstance(self.res_conv, nn.Conv2d) else x)
        return self.block2(h, pre_bias=pre_bias, residual=skip,
                           generator=generator)


class SelfAttention(nn.Module):
    """Single-head spatial self-attention with residual, softmax scale
    1/sqrt(C); qkv's output channels are (q, k, v) in that order."""

    space = None  # the space axis when this level is H-sharded

    def __init__(self, in_channel, norm_groups=32):
        super().__init__()
        self.groups = norm_groups
        self.norm = nn.GroupNorm(norm_groups, in_channel)
        self.qkv = nn.Conv2d(in_channel, in_channel * 3, 1, bias=False)
        self.out = nn.Conv2d(in_channel, in_channel, 1)

    def forward(self, x):
        gw, gb = _affine(self.norm)
        if self.space is not None:  # attention over the gathered tokens
            n = group_norm_space(x, gw, gb, self.groups, self.space,
                                 swish=False)
            n = spatial.gather_rows(n, self.space)
        else:
            n = group_norm(x, gw, gb, self.groups, swish=False)
        b, c, h, w = n.shape
        qkv = _conv(self.qkv, n)  # (b, 3c, h, w), physically (b, h, w, 3c)
        qkv = qkv.permute(0, 2, 3, 1).reshape(b, h * w, 3, c)
        q, k, v = (qkv[:, :, i].contiguous() for i in range(3))
        out = attention(q, k, v, 1.0 / math.sqrt(c))  # (b, hw, c) float32
        out = out.reshape(b, h, w, c).permute(0, 3, 1, 2)  # channels_last
        if self.space is not None:  # this rank's rows
            out = spatial.slice_rows(out, self.space)
        return x + _conv(self.out, out.to(x.dtype))


class ResnetBlocWithAttn(nn.Module):
    def __init__(self, dim, dim_out, *, noise_level_emb_dim=None,
                 norm_groups=32, dropout=0.0, with_attn=False,
                 cond_mode="sr3"):
        super().__init__()
        self.res_block = ResnetBlock(
            dim, dim_out, noise_level_emb_dim, norm_groups=norm_groups,
            dropout=dropout, cond_mode=cond_mode)
        self.attn = (SelfAttention(dim_out, norm_groups=norm_groups)
                     if with_attn else None)

    def forward(self, x, emb, generator=None):
        x = self.res_block(x, emb, generator)
        return self.attn(x) if self.attn is not None else x


def remat_block(layer, x, emb, generator=None):
    """``layer(x, emb, generator)`` under activation checkpointing. The
    first forward draws from ``generator``; the recompute in the backward
    draws from a copy of it taken before the first forward, so it replays
    the same dropout masks and the caller's generator advances once."""
    if generator is None:
        return checkpoint(layer, x, emb, None, use_reentrant=False)
    start = generator.get_state()
    replay = False

    def run(x, emb):
        nonlocal replay
        g = generator
        if replay:  # the recompute: the first forward's draws again
            g = torch.Generator(device=generator.device)
            g.set_state(start)
        replay = True
        return layer(x, emb, g)

    return checkpoint(run, x, emb, use_reentrant=False)


class Downsample(nn.Module):
    """conv3x3 stride 2, padding 1."""

    space = None  # the space axis when its input is H-sharded

    def __init__(self, dim):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, 2, 1)

    def forward(self, x):
        return _conv(self.conv, x, space=self.space)


class Upsample(nn.Module):
    """Nearest x2, then conv3x3."""

    space = None  # the space axis when its input is H-sharded
    space_out = None  # ... when its output is

    def __init__(self, dim):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        x = x.contiguous(memory_format=CL)
        if self.space_out is not None and self.space is None:
            x = spatial.slice_rows(x, self.space_out)
        return _conv(self.conv, x, space=self.space_out)


class UNet(nn.Module):
    """The denoiser backbone. forward(x (b, in_channel, h, w), condition
    (b,): the sqrt-gamma noise level (sr3) or the float timestep (ddpm),
    dropout generator) -> eps (b, out_channel, h, w) float32,
    channels_last. Dropout is active in training mode only; ``remat``
    recomputes each ResnetBlocWithAttn in the backward."""

    def __init__(self, in_channel=6, out_channel=3, inner_channel=32,
                 norm_groups=32, channel_mults=(1, 2, 4, 8, 8), attn_res=(8,),
                 res_blocks=3, dropout=0.0, image_size=128,
                 dtype=torch.float32, remat=False, cond_mode="sr3"):
        super().__init__()
        if cond_mode not in ("sr3", "ddpm"):
            raise ValueError(f"cond_mode must be 'sr3' or 'ddpm', got "
                             f"{cond_mode!r}")
        self.cond_mode = cond_mode
        self.remat = remat
        self.in_channel = in_channel
        self.inner_channel = inner_channel
        self.channel_mults = tuple(channel_mults)
        self.attn_res = tuple(attn_res or ())
        self.res_blocks = res_blocks
        self.image_size = image_size
        self.dtype = dtype

        ic = inner_channel
        cond_mlp = nn.Sequential(
            PositionalEncoding(ic), nn.Linear(ic, ic * 4), nn.SiLU(),
            nn.Linear(ic * 4, ic))
        if cond_mode == "ddpm":
            self.time_mlp = cond_mlp
        else:
            self.noise_level_mlp = cond_mlp
        rba = lambda dim, dim_out, with_attn: ResnetBlocWithAttn(
            dim, dim_out, noise_level_emb_dim=ic, norm_groups=norm_groups,
            dropout=dropout, with_attn=with_attn, cond_mode=cond_mode)

        num_mults = len(self.channel_mults)
        pre_channel = ic
        feat_channels = [pre_channel]
        now_res = image_size
        downs = [nn.Conv2d(in_channel, ic, 3, padding=1)]
        for ind in range(num_mults):
            is_last = ind == num_mults - 1
            use_attn = now_res in self.attn_res
            channel_mult = ic * self.channel_mults[ind]
            for _ in range(res_blocks):
                downs.append(rba(pre_channel, channel_mult, use_attn))
                feat_channels.append(channel_mult)
                pre_channel = channel_mult
            if not is_last:
                downs.append(Downsample(pre_channel))
                feat_channels.append(pre_channel)
                now_res //= 2
        self.downs = nn.ModuleList(downs)
        self.mid = nn.ModuleList([rba(pre_channel, pre_channel, True),
                                  rba(pre_channel, pre_channel, False)])
        ups = []
        for ind in reversed(range(num_mults)):
            is_last = ind < 1
            use_attn = now_res in self.attn_res
            channel_mult = ic * self.channel_mults[ind]
            for _ in range(res_blocks + 1):
                ups.append(rba(pre_channel + feat_channels.pop(),
                               channel_mult, use_attn))
                pre_channel = channel_mult
            if not is_last:
                ups.append(Upsample(pre_channel))
                now_res *= 2
        self.ups = nn.ModuleList(ups)
        self.final_conv = Block(pre_channel, out_channel, groups=norm_groups)

    # ---------------------------------------------------------- parallel

    space = None  # the mesh's space axis (set_parallel)
    stem_space = None  # the space axis when the image level is H-sharded

    def set_parallel(self, mesh):
        """Lay the UNet out on ``mesh``: shard the parameters over its model
        axis (``parallel/sharding_rules.py``) and mark every layer of a
        level that its space axis shards (``spatial.sharded``). Returns the
        names of the sharded parameters."""
        names = []
        if mesh is not None and mesh.model.size > 1:
            names = tp.shard_params(self, mesh.model)
        axis = mesh.space if mesh is not None and mesh.space.size > 1 \
            else None
        if axis is None:
            return names
        self.space = axis
        on = lambda res: axis if spatial.sharded(res, axis) else None
        res = self.image_size
        self.stem_space = on(res)
        for layer in list(self.downs[1:]) + list(self.mid) + list(self.ups):
            if isinstance(layer, ResnetBlocWithAttn):
                for m in layer.modules():
                    if isinstance(m, (Block, SelfAttention)):
                        m.space = on(res)
            elif isinstance(layer, Downsample):
                # a stride-2 halo conv needs an even shard height
                layer.space = on(res) if (res // axis.size) % 2 == 0 \
                    else None
                res //= 2
            else:
                layer.space, layer.space_out = on(res), on(res * 2)
                res *= 2
        self.final_conv.space = on(res)
        return names

    def _layout(self, x, res, want):
        """x (of a level of full height res) H-sharded when ``want`` is an
        axis, whole when it is None."""
        if self.space is None:
            return x
        is_sharded = x.shape[2] != res
        if want is not None and not is_sharded:
            return spatial.slice_rows(x, self.space)
        if want is None and is_sharded:
            return spatial.gather_rows(x, self.space)
        return x

    # ----------------------------------------------------------- forward

    def forward(self, x, noise_level, generator=None):
        if x.shape[1] != self.in_channel:
            raise ValueError(f"expected {self.in_channel} input channels "
                             f"(NCHW), got {tuple(x.shape)}")
        mlp = (self.time_mlp if self.cond_mode == "ddpm"
               else self.noise_level_mlp)
        e = mlp[0](noise_level).to(self.dtype)
        emb = _linear(mlp[3], F.silu(_linear(mlp[1], e)))

        rba = (functools.partial(remat_block, generator=generator)
               if self.remat and torch.is_grad_enabled()
               else lambda layer, x, emb: layer(x, emb, generator))
        res = x.shape[2]
        if self.space is not None and res != self.image_size:
            raise ValueError(f"the space layout was planned for "
                             f"{self.image_size}^2 maps, got {res} rows")
        x = self._layout(x.to(self.dtype).contiguous(memory_format=CL), res,
                         self.stem_space)
        x = _conv(self.downs[0], x, space=self.stem_space)
        feats = [x]
        for layer in self.downs[1:]:
            if isinstance(layer, ResnetBlocWithAttn):
                x = rba(layer, self._layout(x, res, layer.res_block.block1
                                            .space), emb)
            else:
                x = layer(self._layout(x, res, layer.space))
                res //= 2
            feats.append(x)
        for layer in self.mid:
            x = rba(layer, self._layout(x, res, layer.res_block.block1.space),
                    emb)
        for layer in self.ups:
            if isinstance(layer, ResnetBlocWithAttn):
                want = layer.res_block.block1.space
                x = torch.cat([self._layout(x, res, want),
                               self._layout(feats.pop(), res, want)], dim=1)
                x = rba(layer, x.contiguous(memory_format=CL), emb)
            else:
                x = layer(self._layout(x, res, layer.space))
                res *= 2
        out = self.final_conv(self._layout(x, res, self.final_conv.space))
        out = out.float()
        if self.space is None:
            return out
        if out.shape[2] != res:  # every rank's rows, whole on every rank
            return spatial.gather_output(out, self.space)
        return spatial.replicated_output(out, self.space)
