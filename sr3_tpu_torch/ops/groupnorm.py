"""GroupNorm with optional SiLU (kernel K2, ``csrc/groupnorm.cu``).

Counterpart of ``sr3_tpu/ops/groupnorm.py``: ``group_norm_plain`` is the
plain PyTorch version of the XLA spec ``group_norm_swish_xla`` (float32
one-pass sum / sum-of-squares statistics, variance clamped at 0, eps 1e-5);
``group_norm`` runs it for a CPU tensor and launches the Hopper kernel for a
CUDA tensor. Tensors are logical NCHW in ``torch.channels_last`` memory.
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


def group_norm(x, weight, bias, num_groups, eps=1e-5, swish=True):
    """GroupNorm(+SiLU): the plain version on the CPU, kernel K2 on CUDA."""
    check_channels_last(x)
    b, c, h, w = x.shape
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, num_groups, eps, swish)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm runs on cpu or cuda, not {x.device}")
    lib = _build.load_library()
    ws = stats_workspace(lib, x)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    gamma = weight.detach().float().contiguous()
    beta = bias.detach().float().contiguous()
    err = lib.sr3_group_norm(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        ws.data_ptr(), b, h * w, c, num_groups, float(eps), int(swish),
        _build.dtype_code(x), _build.stream_of(x),
    )
    _build.check(err, "sr3_group_norm")
    counter.n += 1
    return y
