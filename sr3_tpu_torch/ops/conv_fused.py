"""Fused GroupNorm -> SiLU -> conv3x3 (kernel K1, ``csrc/conv_fused.cu``).

Counterpart of ``sr3_tpu/ops/conv_fused.py``. ``gn_silu_conv3x3_plain`` is
the plain PyTorch version of the XLA spec ``gn_silu_conv3x3_xla`` (plus the
residual add of the dispatcher): optional per-(batch, channel) pre-affine
``a*x + b`` in x's dtype, one-pass float32 GroupNorm, SiLU, cast to x's
dtype, conv3x3 with padding 1 and bias, then the residual.
``gn_silu_conv3x3`` runs it for a CPU tensor and launches the Hopper kernel
for a CUDA tensor. It is differentiable. Its backward, in an
``ops.kernel_backward`` span (``utils/profiler.py``), takes three steps:
``groupnorm.gn_silu_act`` recomputes the activation SiLU(GroupNorm(a*x +
b)) and its statistics from the saved x (the backward kernel's own
launches, not K1's); ``convolution_backward`` gives the activation's, the
weight's and the bias's gradients, as autograd of the conv would (the JAX
package leaves the conv's vjp to XLA, ``_fused_fwd_bwd``); and
``groupnorm.gn_silu_bwd`` turns the activation's gradient into those of x,
the GroupNorm affine and the pre-affine. The residual's gradient is the
output gradient. On the CPU each step is its plain version. Activations
are logical NCHW in
``torch.channels_last`` memory; the conv weight is torch's (Cout, Cin, 3,
3), also channels_last (physically (Cout, 3, 3, Cin), the layout the kernel
reads).

On an H-shard of a map sharded over the mesh's space axis
(``parallel/spatial.py``), ``gn_silu_conv3x3_space`` takes the whole map's
statistics (K3 on the shard, all-reduced) and the neighbours' halo rows and
runs K1's halo entry (``gn_silu_conv3x3_halo``: the conv launch alone, with
the caller's per-(b, c) mult / add and the raw rows above and below the
shard); ``gn_silu_conv3x3_halo_plain`` is its plain version, and its
backward is autograd through that plain version (an ``ops.plain_backward``
span).

With ``post_scale`` / ``post_shift`` (B, Cin) the normalized map is scaled
and shifted per (batch, channel) after the norm, SiLU(GroupNorm(x) * (1 +
post_scale) + post_shift) -> conv3x3, the conditioning of guided-diffusion's
scale-shift ResBlocks (``models/adm_unet.py``): the plain version computes
it in float32 before the SiLU; the kernel folds it into the per-(batch,
channel) multiply-add its statistics launch builds; under autograd the
backward is autograd through the plain version, in an
``ops.plain_backward`` span. K1's
statistics launch takes up to 2048 input channels (the ADM's concatenated
up-path inputs); its backward kernel, up to 1024.
"""


from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sr3_tpu_torch.ops import _build
from sr3_tpu_torch.ops.groupnorm import (_group_stats, _grouped, _normalize,
                                         check_channels_last, f32_or_none,
                                         gn_silu_act, gn_silu_bwd,
                                         group_norm_plain, space_stats,
                                         stats_workspace)
from sr3_tpu_torch.utils.profiler import Counter, span

counter = Counter("gn_silu_conv3x3")
# The bfloat16 conv launch's classes <TW, NI, BN> (tile width, images a
# tile, output channels a tile), in the order sr3_gn_silu_conv3x3_tiles
# reports their launches: the Hopper kernel's six, then C_out <= 8.
BF16_TILES = ("<16,1,256>", "<16,1,192>", "<16,1,128>", "<16,1,64>",
              "<8,2,128>", "<8,2,64>", "<16,1,8>")
# sr3_gn_silu_conv3x3_plan's fields
PLAN_FIELDS = ("cls", "tiles_h", "tiles_w", "ptiles", "n_tiles", "items",
               "grid")


def bf16_tile_launches(reset=False):
    """Launches of each bfloat16 class since the last reset, by class name;
    ``reset`` sets them to 0 after reading. Loads the CUDA library."""
    counts = (ctypes.c_longlong * len(BF16_TILES))()
    n = _build.load_library().sr3_gn_silu_conv3x3_tiles(counts, int(reset))
    if n != len(BF16_TILES):
        raise RuntimeError(f"the library reports {n} bfloat16 tiles, "
                           f"expected {len(BF16_TILES)}")
    return dict(zip(BF16_TILES, counts))


def bf16_plan(b, h, w, cout):
    """The C library's plan of the bfloat16 conv launch on a (b, h, w)
    map to ``cout`` channels on the current device, a dict of PLAN_FIELDS
    (``tests/torch_port_conv_plan.py`` mirrors it). Loads the library."""
    out = (ctypes.c_longlong * len(PLAN_FIELDS))()
    err = _build.load_library().sr3_gn_silu_conv3x3_plan(b, h, w, cout, out)
    _build.check(err, "sr3_gn_silu_conv3x3_plan")
    return dict(zip(PLAN_FIELDS, out))


def _post_act(x, gn_weight, gn_bias, num_groups, eps, post_scale,
              post_shift):
    """SiLU(GroupNorm(x) * (1 + post_scale) + post_shift), all in float32,
    cast to x's dtype; post_scale / post_shift (B,C) or None."""
    xf = _grouped(x, num_groups)
    mean, rstd = _group_stats(xf, eps)
    z = _normalize(xf, gn_weight, gn_bias, mean, rstd, swish=False)
    if post_scale is not None:
        z = z * (1.0 + post_scale.float()[:, :, None, None])
    if post_shift is not None:
        z = z + post_shift.float()[:, :, None, None]
    return (z * torch.sigmoid(z)).to(x.dtype).contiguous(
        memory_format=torch.channels_last)


def gn_silu_conv3x3_plain(x, gn_weight, gn_bias, weight, bias, num_groups,
                          eps=1e-5, pre_scale=None, pre_bias=None,
                          residual=None, post_scale=None, post_shift=None):
    """x: (B,Cin,H,W); weight: (Cout,Cin,3,3); pre_scale/pre_bias: (B,Cin);
    residual: (B,Cout,H,W); post_scale/post_shift: (B,Cin), the scale and
    shift of the normalized map, GroupNorm(x) * (1 + post_scale) +
    post_shift, in float32 before the SiLU. Returns (B,Cout,H,W) in x's
    dtype."""
    if pre_scale is not None:
        x = x * pre_scale[:, :, None, None].to(x.dtype)
    if pre_bias is not None:
        x = x + pre_bias[:, :, None, None].to(x.dtype)
    if post_scale is None and post_shift is None:
        xn = group_norm_plain(x, gn_weight, gn_bias, num_groups, eps,
                              swish=True)
    else:
        xn = _post_act(x, gn_weight, gn_bias, num_groups, eps, post_scale,
                       post_shift)
    y = F.conv2d(xn, weight.to(x.dtype),
                 None if bias is None else bias.to(x.dtype), padding=1)
    if residual is not None:
        y = y + residual.to(y.dtype)
    return y.contiguous(memory_format=torch.channels_last)


def gn_silu_conv3x3(x, gn_weight, gn_bias, weight, bias, num_groups,
                    eps=1e-5, pre_scale=None, pre_bias=None, residual=None,
                    post_scale=None, post_shift=None):
    """GroupNorm+SiLU+conv3x3 (+ pre-affine, + the scale-shift after the
    norm, + residual): the plain version on the CPU, kernel K1 on CUDA. With
    ``post_scale`` / ``post_shift`` its backward is autograd through the
    plain version (``_GnSiluConv3x3Post``)."""
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
    post = (post_scale, post_shift)
    if post_scale is not None or post_shift is not None:
        if _build.needs_grad(*args, *post):
            return _GnSiluConv3x3Post.apply(*args, *post, num_groups, eps)
        return _fwd(*args, num_groups, eps, *post)
    if _build.needs_grad(*args):
        return _GnSiluConv3x3.apply(*args, num_groups, eps)
    return _fwd(*args, num_groups, eps)


def _fwd(x, gn_weight, gn_bias, weight, bias, pre_scale, pre_bias, residual,
         num_groups, eps, post_scale=None, post_shift=None):
    if x.device.type == "cpu":
        return gn_silu_conv3x3_plain(
            x, gn_weight, gn_bias, weight, bias, num_groups, eps,
            pre_scale=pre_scale, pre_bias=pre_bias, residual=residual,
            post_scale=post_scale, post_shift=post_shift)
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
    ps = f32_or_none(pre_scale, (b, cin), "pre_scale")
    pb = f32_or_none(pre_bias, (b, cin), "pre_bias")
    cb = None if bias is None else bias.float().contiguous()
    gamma = gn_weight.float().contiguous()
    beta = gn_bias.float().contiguous()
    y = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    ptr = _build.ptr
    qs = f32_or_none(post_scale, (b, cin), "post_scale")
    qb = f32_or_none(post_shift, (b, cin), "post_shift")
    err = lib.sr3_gn_silu_conv3x3(
        x.data_ptr(), ptr(ps), ptr(pb), ptr(qs), ptr(qb), gamma.data_ptr(),
        beta.data_ptr(), wk.data_ptr(), ptr(cb), ptr(residual),
        y.data_ptr(), ws.data_ptr(), tickets.data_ptr(), b, h, w, cin, cout,
        num_groups, float(eps), _build.dtype_code(x), _build.stream_of(x),
    )
    _build.check(err, "sr3_gn_silu_conv3x3")
    counter.n += 1
    return y


class _GnSiluConv3x3(torch.autograd.Function):
    """Counterpart of ``_fused_fwd_bwd``: kernel forward; the backward
    recomputes the activation, takes the conv's gradients and then the
    GroupNorm+SiLU's (``gn_silu_act``, ``convolution_backward``,
    ``gn_silu_bwd``)."""

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
        # unpacked outside the span: it may replay a remat block's forward
        saved = ctx.saved_tensors
        x, gw, gb, w, cb, ps, pb = saved
        need = ctx.needs_input_grad
        grads = [None] * 7
        with span("ops.kernel_backward", g, op="gn_silu_conv3x3"):
            need_act = any(need[i] for i in (0, 1, 2, 5, 6))
            need_cb = cb is not None and need[4]
            if need_act or need[3] or need_cb:
                num_groups, eps = ctx.cfg
                act, stats = gn_silu_act(x, gw, gb, num_groups, eps,
                                         pre_scale=ps, pre_bias=pb)
                gy = g.to(x.dtype).contiguous(
                    memory_format=torch.channels_last)
                dact, grads[3], grads[4] = \
                    torch.ops.aten.convolution_backward(
                        gy, act, w.to(x.dtype),
                        None if cb is None else [cb.shape[0]], [1, 1],
                        [1, 1], [1, 1], False, [0, 0], 1,
                        [need_act, need[3], need_cb])
                if need_act:
                    dx, dgw, dgb, dps, dpb = gn_silu_bwd(
                        x, dact, gw, gb, num_groups, eps, stats=stats,
                        pre_scale=ps, pre_bias=pb)
                    grads[:3], grads[5:] = (dx, dgw, dgb), (dps, dpb)
            dres = g.to(ctx.residual_dtype) if need[7] else None
        grads = [t.to(s.dtype) if n and t is not None else None
                 for t, s, n in zip(grads, saved, need)]
        return (*grads, dres, None, None)


class _GnSiluConv3x3Post(torch.autograd.Function):
    """K1 with the scale-shift after the norm: the kernel forward; the
    backward is autograd through ``gn_silu_conv3x3_plain`` recomputed from
    the saved inputs, in an ``ops.plain_backward`` span (the residual's
    gradient is the output gradient)."""

    @staticmethod
    def forward(ctx, x, gn_weight, gn_bias, weight, bias, pre_scale, pre_bias,
                residual, post_scale, post_shift, num_groups, eps):
        ctx.save_for_backward(x, gn_weight, gn_bias, weight, bias, pre_scale,
                              pre_bias, post_scale, post_shift)
        ctx.cfg = (num_groups, eps)
        ctx.residual_dtype = None if residual is None else residual.dtype
        return _fwd(x, gn_weight, gn_bias, weight, bias, pre_scale, pre_bias,
                    residual, num_groups, eps, post_scale, post_shift)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad
        with span("ops.plain_backward", g, op="gn_silu_conv3x3_post"):
            flags = need[:7] + need[8:10]
            with torch.enable_grad():
                leaves = [None if t is None else t.detach().requires_grad_(n)
                          for t, n in zip(saved, flags)]
                x, gw, gb, w, cb, ps, pb, qs, qb = leaves
                y = gn_silu_conv3x3_plain(
                    x, gw, gb, w, cb, *ctx.cfg, pre_scale=ps, pre_bias=pb,
                    post_scale=qs, post_shift=qb)
                wrt = [t for t in leaves if t is not None and t.requires_grad]
                grads = iter(torch.autograd.grad(y, wrt, g.to(y.dtype))
                             if wrt else ())
            out = [next(grads) if t is not None and t.requires_grad else None
                   for t in leaves]
            dres = g.to(ctx.residual_dtype) if need[7] else None
        return (*out[:7], dres, *out[7:], None, None)


# ---------------------------------------------------- the halo entry (space)

halo_counter = Counter("gn_silu_conv3x3_halo")


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
    m = f32_or_none(mult, (b, cin), "mult")
    a = f32_or_none(add, (b, cin), "add")
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
        saved = ctx.saved_tensors
        with span("ops.plain_backward", g, op="gn_silu_conv3x3_halo"):
            need = ctx.needs_input_grad[:7]
            with torch.enable_grad():
                leaves = [None if t is None else t.detach().requires_grad_(n)
                          for t, n in zip(saved, need)]
                y = gn_silu_conv3x3_halo_plain(*leaves)
                wrt = [t for t in leaves if t is not None and t.requires_grad]
                grads = iter(torch.autograd.grad(y, wrt, g) if wrt else ())
            out = [next(grads) if t is not None and t.requires_grad else None
                   for t in leaves]
            dres = (g.to(ctx.residual_dtype) if ctx.needs_input_grad[7]
                    else None)
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
