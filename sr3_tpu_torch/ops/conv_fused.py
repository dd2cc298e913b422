"""Fused GroupNorm -> SiLU -> conv3x3 (kernel K1, ``csrc/conv_fused.cu``).

Counterpart of ``sr3_tpu/ops/conv_fused.py``. ``gn_silu_conv3x3_plain`` is
the plain PyTorch version of the XLA spec ``gn_silu_conv3x3_xla`` (plus the
residual add of the dispatcher): optional per-(batch, channel) pre-affine
``a*x + b`` in x's dtype, one-pass float32 GroupNorm, SiLU, cast to x's
dtype, conv3x3 with padding 1 and bias, then the residual.
``gn_silu_conv3x3`` runs it for a CPU tensor and launches the Hopper kernel
for a CUDA tensor. It is differentiable: as ``_fused_fwd_bwd`` does, the
backward recomputes the plain version under autograd (the residual's
gradient is the output gradient). Activations are logical NCHW in
``torch.channels_last`` memory; the conv weight is torch's (Cout, Cin, 3,
3), also channels_last (physically (Cout, 3, 3, Cin), the layout the kernel
reads).

On an H-shard of a map sharded over the mesh's space axis
(``parallel/spatial.py``), ``gn_silu_conv3x3_space`` takes the whole map's
statistics (K3 on the shard, all-reduced) and the neighbours' halo rows and
runs K1's halo entry (``gn_silu_conv3x3_halo``: the conv launch alone, with
the caller's per-(b, c) mult / add and the raw rows above and below the
shard); ``gn_silu_conv3x3_halo_plain`` is its plain version, and its
backward is autograd through that plain version, as K1's is.
"""


from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sr3_tpu_torch.ops import _build
from sr3_tpu_torch.ops.groupnorm import (check_channels_last,
                                         group_norm_plain, space_stats,
                                         stats_workspace)

counter = _build.LaunchCount("gn_silu_conv3x3")
# The bfloat16 kernel's tiles <TW, NI, BN> (tile width, images per block,
# output channels per block), in the order sr3_gn_silu_conv3x3_tiles
# reports their launches.
BF16_TILES = ("<16,1,128>", "<16,1,64>", "<16,1,8>", "<8,2,64>")


def bf16_tile_launches(reset=False):
    """Launches of each bfloat16 tile since the last reset, by tile name;
    ``reset`` sets them to 0 after reading. Loads the CUDA library."""
    counts = (ctypes.c_longlong * len(BF16_TILES))()
    n = _build.load_library().sr3_gn_silu_conv3x3_tiles(counts, int(reset))
    if n != len(BF16_TILES):
        raise RuntimeError(f"the library reports {n} bfloat16 tiles, "
                           f"expected {len(BF16_TILES)}")
    return dict(zip(BF16_TILES, counts))


def gn_silu_conv3x3_plain(x, gn_weight, gn_bias, weight, bias, num_groups,
                          eps=1e-5, pre_scale=None, pre_bias=None,
                          residual=None):
    """x: (B,Cin,H,W); weight: (Cout,Cin,3,3); pre_scale/pre_bias: (B,Cin);
    residual: (B,Cout,H,W). Returns (B,Cout,H,W) in x's dtype."""
    if pre_scale is not None:
        x = x * pre_scale[:, :, None, None].to(x.dtype)
    if pre_bias is not None:
        x = x + pre_bias[:, :, None, None].to(x.dtype)
    xn = group_norm_plain(x, gn_weight, gn_bias, num_groups, eps, swish=True)
    y = F.conv2d(xn, weight.to(x.dtype),
                 None if bias is None else bias.to(x.dtype), padding=1)
    if residual is not None:
        y = y + residual.to(y.dtype)
    return y.contiguous(memory_format=torch.channels_last)


def _f32_or_none(t, shape, name):
    if t is None:
        return None
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    return t.float().contiguous()


def gn_silu_conv3x3(x, gn_weight, gn_bias, weight, bias, num_groups,
                    eps=1e-5, pre_scale=None, pre_bias=None, residual=None):
    """GroupNorm+SiLU+conv3x3 (+ pre-affine, + residual): the plain version
    on the CPU, kernel K1 on CUDA."""
    check_channels_last(x)
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    if tuple(weight.shape) != (cout, cin, 3, 3):
        raise ValueError(f"weight must be ({cout}, {cin}, 3, 3), got "
                         f"{tuple(weight.shape)}")
    if cin % num_groups:
        raise ValueError(f"{cin} channels do not split into {num_groups} groups")
    if residual is not None:
        check_channels_last(residual, "residual")
        if tuple(residual.shape) != (b, cout, h, w):
            raise ValueError(f"residual must be {(b, cout, h, w)}, got "
                             f"{tuple(residual.shape)}")
    args = (x, gn_weight, gn_bias, weight, bias, pre_scale, pre_bias, residual)
    if _build.needs_grad(*args):
        return _GnSiluConv3x3.apply(*args, num_groups, eps)
    return _fwd(*args, num_groups, eps)


def _fwd(x, gn_weight, gn_bias, weight, bias, pre_scale, pre_bias, residual,
         num_groups, eps):
    if x.device.type == "cpu":
        return gn_silu_conv3x3_plain(
            x, gn_weight, gn_bias, weight, bias, num_groups, eps,
            pre_scale=pre_scale, pre_bias=pre_bias, residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"gn_silu_conv3x3 runs on cpu or cuda, not {x.device}")

    b, cin, h, w = x.shape
    cout = weight.shape[0]
    wk = weight.to(x.dtype)
    if not wk.permute(0, 2, 3, 1).is_contiguous():
        raise ValueError("conv weight must be in torch.channels_last memory "
                         "(physically (Cout, 3, 3, Cin))")
    if residual is not None and residual.dtype != x.dtype:
        raise TypeError(f"residual dtype {residual.dtype} != x dtype {x.dtype}")
    if x.data_ptr() % 16 or wk.data_ptr() % 16:
        raise ValueError("x and the conv weight must start 16-byte aligned")
    if x.dtype == torch.bfloat16 and cin % 16:
        raise ValueError(f"the bfloat16 kernel takes C_in a multiple of 16, "
                         f"got {cin}")
    lib = _build.load_library()
    ws, tickets = stats_workspace(lib, x, num_groups)
    ps = _f32_or_none(pre_scale, (b, cin), "pre_scale")
    pb = _f32_or_none(pre_bias, (b, cin), "pre_bias")
    cb = None if bias is None else bias.float().contiguous()
    gamma = gn_weight.float().contiguous()
    beta = gn_bias.float().contiguous()
    y = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    ptr = _build.ptr
    err = lib.sr3_gn_silu_conv3x3(
        x.data_ptr(), ptr(ps), ptr(pb), gamma.data_ptr(), beta.data_ptr(),
        wk.data_ptr(), ptr(cb), ptr(residual), y.data_ptr(), ws.data_ptr(),
        tickets.data_ptr(), b, h, w, cin, cout, num_groups, float(eps),
        _build.dtype_code(x), _build.stream_of(x),
    )
    _build.check(err, "sr3_gn_silu_conv3x3")
    counter.n += 1
    return y


class _GnSiluConv3x3(torch.autograd.Function):
    """Counterpart of ``_fused_fwd_bwd``: kernel forward; the backward is
    autograd through the plain version, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, gn_weight, gn_bias, weight, bias, pre_scale, pre_bias,
                residual, num_groups, eps):
        ctx.save_for_backward(x, gn_weight, gn_bias, weight, bias, pre_scale,
                              pre_bias)
        ctx.cfg = (num_groups, eps)
        ctx.residual_dtype = None if residual is None else residual.dtype
        return _fwd(x, gn_weight, gn_bias, weight, bias, pre_scale, pre_bias,
                    residual, num_groups, eps)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:7]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            x, gw, gb, w, cb, ps, pb = leaves
            y = gn_silu_conv3x3_plain(x, gw, gb, w, cb, *ctx.cfg,
                                      pre_scale=ps, pre_bias=pb)
            wrt = [t for t in leaves if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(y, wrt, g) if wrt else ())
        out = [next(grads) if t is not None and t.requires_grad else None
               for t in leaves]
        dres = g.to(ctx.residual_dtype) if ctx.needs_input_grad[7] else None
        return (*out, dres, None, None)


# ---------------------------------------------------- the halo entry (space)

halo_counter = _build.LaunchCount("gn_silu_conv3x3_halo")


def _act(t, mult, add, dtype):
    z = t.float() * mult[:, :, None, None] + add[:, :, None, None]
    return (z * torch.sigmoid(z)).to(dtype)


def gn_silu_conv3x3_halo_plain(x, top, bottom, mult, add, weight, bias,
                               residual=None):
    """The plain version of K1's halo entry. x: (B,Cin,h,W) an H-shard;
    top / bottom: (B,Cin,1,W) the raw rows above / below it, or None for
    zero padding after the activation; mult / add: (B,Cin) float32, the
    normalized x being x * mult + add; weight (Cout,Cin,3,3); residual
    (B,Cout,h,W). SiLU in float32, cast to x's dtype, conv3x3 (padding 1
    on W, the halo rows on H) with bias, then the residual. Returns
    (B,Cout,h,W) in x's dtype."""
    b, cin, h, w = x.shape
    zero = x.new_zeros((b, cin, 1, w))
    rows = [zero if top is None else _act(top, mult, add, x.dtype),
            _act(x, mult, add, x.dtype),
            zero if bottom is None else _act(bottom, mult, add, x.dtype)]
    y = F.conv2d(torch.cat(rows, dim=2), weight.to(x.dtype),
                 None if bias is None else bias.to(x.dtype), padding=(0, 1))
    if residual is not None:
        y = y + residual.to(y.dtype)
    return y.contiguous(memory_format=torch.channels_last)


def _fwd_halo(x, top, bottom, mult, add, weight, bias, residual):
    if x.device.type == "cpu":
        return gn_silu_conv3x3_halo_plain(x, top, bottom, mult, add, weight,
                                          bias, residual)
    if x.device.type != "cuda":
        raise ValueError(f"gn_silu_conv3x3_halo runs on cpu or cuda, not "
                         f"{x.device}")
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    wk = weight.to(x.dtype)
    if not wk.permute(0, 2, 3, 1).is_contiguous():
        raise ValueError("conv weight must be in torch.channels_last memory "
                         "(physically (Cout, 3, 3, Cin))")
    for t, name in ((top, "top"), (bottom, "bottom")):
        if t is not None:
            check_channels_last(t, name)
            if tuple(t.shape) != (b, cin, 1, w) or t.dtype != x.dtype:
                raise ValueError(f"{name} must be {(b, cin, 1, w)} of "
                                 f"{x.dtype}, got {tuple(t.shape)} {t.dtype}")
    if residual is not None and residual.dtype != x.dtype:
        raise TypeError(f"residual dtype {residual.dtype} != x dtype "
                        f"{x.dtype}")
    if x.dtype == torch.bfloat16 and cin % 16:
        raise ValueError(f"the bfloat16 kernel takes C_in a multiple of 16, "
                         f"got {cin}")
    m = _f32_or_none(mult, (b, cin), "mult")
    a = _f32_or_none(add, (b, cin), "add")
    if any(t is not None and t.data_ptr() % 16
           for t in (x, wk, top, bottom, m, a)):
        raise ValueError("x, the halo rows, mult, add and the conv weight "
                         "must start 16-byte aligned")
    cb = None if bias is None else bias.float().contiguous()
    y = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    ptr = _build.ptr
    err = _build.load_library().sr3_gn_silu_conv3x3_halo(
        x.data_ptr(), ptr(top), ptr(bottom), m.data_ptr(), a.data_ptr(),
        wk.data_ptr(), ptr(cb), ptr(residual), y.data_ptr(), b, h, w, cin,
        cout, _build.dtype_code(x), _build.stream_of(x))
    _build.check(err, "sr3_gn_silu_conv3x3_halo")
    halo_counter.n += 1
    return y


class _GnSiluConv3x3Halo(torch.autograd.Function):
    """K1's halo entry forward; the backward is autograd through
    ``gn_silu_conv3x3_halo_plain`` recomputed from the saved inputs (the
    residual's gradient is the output gradient)."""

    @staticmethod
    def forward(ctx, x, top, bottom, mult, add, weight, bias, residual):
        ctx.save_for_backward(x, top, bottom, mult, add, weight, bias)
        ctx.residual_dtype = None if residual is None else residual.dtype
        return _fwd_halo(x, top, bottom, mult, add, weight, bias, residual)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:7]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            y = gn_silu_conv3x3_halo_plain(*leaves)
            wrt = [t for t in leaves if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(y, wrt, g) if wrt else ())
        out = [next(grads) if t is not None and t.requires_grad else None
               for t in leaves]
        dres = g.to(ctx.residual_dtype) if ctx.needs_input_grad[7] else None
        return (*out, dres)


def gn_silu_conv3x3_halo(x, top, bottom, mult, add, weight, bias,
                         residual=None):
    """K1's halo entry: the plain version on the CPU, the kernel on CUDA;
    differentiable in every tensor argument."""
    check_channels_last(x)
    if residual is not None:
        check_channels_last(residual, "residual")
    args = (x, top, bottom, mult, add, weight, bias, residual)
    if _build.needs_grad(*args):
        return _GnSiluConv3x3Halo.apply(*args)
    return _fwd_halo(*args)


def gn_silu_conv3x3_space(x, gn_weight, gn_bias, weight, bias, num_groups,
                          axis, eps=1e-5, pre_scale=None, pre_bias=None,
                          residual=None):
    """``gn_silu_conv3x3`` of the H-shard x of a map sharded over the space
    ``axis``: the whole map's GroupNorm statistics of a*x + b
    (``groupnorm.space_stats``: K3 sums of the shard, adjusted for the
    pre-affine in float32, all-reduced, folded), folded with the affine
    into per-(b, c) mult / add, the halo rows from the neighbours, then K1's
    halo entry. Differentiable; a collective over ``axis``."""
    from sr3_tpu_torch.parallel.spatial import halo_exchange, is_border

    mean_c, rstd_c = space_stats(x, num_groups, eps, axis, pre_scale,
                                 pre_bias)
    sc = gn_weight.float()[None] * rstd_c
    shift = -mean_c if pre_bias is None else pre_bias.float() - mean_c
    add = shift * sc + gn_bias.float()[None]
    mult = sc if pre_scale is None else sc * pre_scale.float()
    top, bottom = halo_exchange(x, axis)
    at_top, at_bottom = is_border(axis)
    return gn_silu_conv3x3_halo(x, None if at_top else top,
                                None if at_bottom else bottom, mult, add,
                                weight, bias, residual)
