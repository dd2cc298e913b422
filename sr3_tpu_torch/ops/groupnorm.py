"""GroupNorm with optional SiLU (kernel K2, ``csrc/groupnorm.cu``).

Counterpart of ``sr3_tpu/ops/groupnorm.py``: ``group_norm_plain`` is the
plain PyTorch version of the XLA spec ``group_norm_swish_xla`` (float32
one-pass sum / sum-of-squares statistics, variance clamped at 0, eps 1e-5);
``group_norm`` runs it for a CPU tensor and launches the Hopper kernel for a
CUDA tensor. ``group_norm`` is differentiable: its backward is the JAX
package's hand formula (``_gn_swish_fwd_bwd``), ``group_norm_bwd_plain``, in
plain PyTorch on either device, as it is XLA and not a Pallas kernel there.
Tensors are logical NCHW in ``torch.channels_last`` memory.
"""

from __future__ import annotations

import torch

from sr3_tpu_torch.ops import _build

counter = _build.LaunchCount("group_norm")


def check_channels_last(x, name="x"):
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(
            f"{name} must be a 4-D tensor in torch.channels_last memory "
            f"(got shape {tuple(x.shape)}, strides {tuple(x.stride())})")


def stats_workspace(lib, x):
    """Float32 scratch of the kernels' GroupNorm statistics of x (B,C,H,W),
    sized by the kernel library."""
    b, c, h, w = x.shape
    n = lib.sr3_gn_workspace_floats(b, h * w, c)
    if n < 0:
        raise ValueError(f"the GroupNorm kernels do not take {c} channels "
                         f"(kGnMaxChannels, csrc/common.cuh)")
    return torch.empty(n, dtype=torch.float32, device=x.device)


def group_norm_plain(x, weight, bias, num_groups, eps=1e-5, swish=True):
    """x: (B,C,H,W). weight/bias: (C,). Same shape, dtype and layout as x."""
    b, c, h, w = x.shape
    xf = x.float().reshape(b, num_groups, c // num_groups, h, w)
    mean = xf.mean(dim=(2, 3, 4), keepdim=True)
    msq = xf.square().mean(dim=(2, 3, 4), keepdim=True)
    var = (msq - mean.square()).clamp_min(0.0)
    xn = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, c, h, w)
    xn = xn * weight.float()[None, :, None, None] \
        + bias.float()[None, :, None, None]
    if swish:
        xn = xn * torch.sigmoid(xn)
    return xn.to(x.dtype).contiguous(memory_format=torch.channels_last)


def group_norm_bwd_plain(x, weight, bias, g, num_groups, eps=1e-5,
                         swish=True):
    """(dx, dweight, dbias) of ``group_norm_plain`` for the output gradient
    g (the hand formula of ``_gn_swish_fwd_bwd``): the statistics recomputed
    in one pass, the variance clamped at 0, the SiLU derivative when
    ``swish``. dx has x's dtype and layout; dweight and dbias are float32
    (C,)."""
    b, c, h, w = x.shape
    shape = (b, num_groups, c // num_groups, h, w)
    xf = x.float().reshape(shape)
    mean = xf.mean(dim=(2, 3, 4), keepdim=True)
    msq = xf.square().mean(dim=(2, 3, 4), keepdim=True)
    var = (msq - mean.square()).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mean) * rstd
    per_channel = (1, num_groups, c // num_groups, 1, 1)
    sc = weight.float().reshape(per_channel)
    dz = g.float().reshape(shape)
    if swish:
        z = xhat * sc + bias.float().reshape(per_channel)
        s = torch.sigmoid(z)
        dz = dz * (s * (1 + z * (1 - s)))
    dbias = dz.sum(dim=(0, 3, 4)).reshape(c)
    dweight = (dz * xhat).sum(dim=(0, 3, 4)).reshape(c)
    dzg = dz * sc
    m1 = dzg.mean(dim=(2, 3, 4), keepdim=True)
    m2 = (dzg * xhat).mean(dim=(2, 3, 4), keepdim=True)
    dx = (rstd * (dzg - m1 - xhat * m2)).reshape(b, c, h, w)
    return (dx.to(x.dtype).contiguous(memory_format=torch.channels_last),
            dweight, dbias)


def _group_norm_fwd(x, weight, bias, num_groups, eps, swish):
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, num_groups, eps, swish)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm runs on cpu or cuda, not {x.device}")
    b, c, h, w = x.shape
    lib = _build.load_library()
    ws = stats_workspace(lib, x)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    gamma = weight.float().contiguous()
    beta = bias.float().contiguous()
    err = lib.sr3_group_norm(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        ws.data_ptr(), b, h * w, c, num_groups, float(eps), int(swish),
        _build.dtype_code(x), _build.stream_of(x),
    )
    _build.check(err, "sr3_group_norm")
    counter.n += 1
    return y


class _GroupNorm(torch.autograd.Function):
    """Counterpart of ``_gn_swish_fwd_bwd``: kernel forward, hand backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, swish):
        ctx.save_for_backward(x, weight, bias)
        ctx.cfg = (num_groups, eps, swish)
        return _group_norm_fwd(x, weight, bias, num_groups, eps, swish)

    @staticmethod
    def backward(ctx, g):
        x, weight, bias = ctx.saved_tensors
        dx, dw, db = group_norm_bwd_plain(x, weight, bias, g, *ctx.cfg)
        return dx, dw.to(weight.dtype), db.to(bias.dtype), None, None, None


def group_norm(x, weight, bias, num_groups, eps=1e-5, swish=True):
    """GroupNorm(+SiLU): the plain version on the CPU, kernel K2 on CUDA;
    differentiable in x, weight and bias."""
    check_channels_last(x)
    c = x.shape[1]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    if _build.needs_grad(x, weight, bias):
        return _GroupNorm.apply(x, weight, bias, num_groups, eps, swish)
    return _group_norm_fwd(x, weight, bias, num_groups, eps, swish)
