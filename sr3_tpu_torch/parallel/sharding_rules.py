"""Parameters sharded on their output channels over the mesh's ``model``
axis.

Counterpart of ``sr3_tpu/parallel/sharding_rules.py``
(``param_partition_spec`` / ``make_param_shardings`` / ``shard_state``).
The rule is the JAX package's: every conv / linear weight and bias and
every GroupNorm affine is sharded on its output-channel dimension (torch's
dim 0, the last dimension of flax's HWIO kernels) when the ``model`` axis
size divides it, and replicated otherwise. A rank keeps only its slice
(``shard_params``); the Adam moments and the EMA are made from the sharded
parameters, so they follow them.

Compute (``models/unet.py``): a sharded conv or linear computes its output
slice from the whole input (K1 with the weight slice (Cout/m, 3, 3, Cin))
and the output is all-gathered along C (``gather_channels``); a sharded
GroupNorm affine is all-gathered before use (``gather_param``). What
follows a gather is computed identically on every model rank, so a
gather's backward keeps the rank's own slice and does not sum: summing
would multiply the gradient by m. The input of a sharded op gets only this
rank's part of its gradient, so it passes through ``copy_in`` (identity;
the backward sums over ``model``), as Megatron's column-parallel layers do.

Checkpoints gather the full tensors on save (``full_state_dict``) and slice
them on load (``load_full_state_dict``), so a checkpoint does not depend on
the layout.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

CL = torch.channels_last
SHARDED_MODULES = (nn.Conv2d, nn.Linear, nn.GroupNorm)


def shardable(module, axis):
    """Whether ``module``'s parameters shard over ``axis``: a conv, linear
    or GroupNorm whose output channels the axis size divides."""
    return (axis is not None and axis.size > 1
            and isinstance(module, SHARDED_MODULES)
            and module.weight is not None
            and module.weight.shape[0] % axis.size == 0)


def slice_dim0(t, axis):
    """This rank's slice of t's dim 0 (a copy; channels_last when 4-D)."""
    n = t.shape[0] // axis.size
    out = t.detach()[axis.rank * n:(axis.rank + 1) * n].clone()
    if out.dim() == 4:
        out = out.contiguous(memory_format=CL)
    return out


def shard_params(net, axis):
    """Replace the parameters of every shardable module of ``net`` by this
    rank's slice of their dim 0 and mark the module (``module.tp = axis``).
    Returns the names of the sharded parameters."""
    names = []
    for mname, m in net.named_modules():
        if not shardable(m, axis):
            continue
        for pname, p in list(m.named_parameters(recurse=False)):
            setattr(m, pname, nn.Parameter(slice_dim0(p, axis),
                                           requires_grad=p.requires_grad))
            names.append(f"{mname}.{pname}" if mname else pname)
        m.tp = axis
    return names


def sharded_names(net):
    """Names of ``net``'s parameters that are sharded over ``model``."""
    return {f"{mname}.{pname}" if mname else pname
            for mname, m in net.named_modules()
            if getattr(m, "tp", None) is not None
            for pname, _ in m.named_parameters(recurse=False)}


def model_axis(net):
    for m in net.modules():
        if getattr(m, "tp", None) is not None:
            return m.tp
    return None


def gather_dim0(t, axis):
    """The model ranks' slices of t concatenated along dim 0 (a
    collective)."""
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t, group=axis.group)
    out = torch.cat(parts)
    return out.contiguous(memory_format=CL) if out.dim() == 4 else out


def full_tensors(tensors, names, sharded, axis):
    """{name: tensor} with every name in ``sharded`` gathered along dim 0
    over ``axis`` (a collective; the others unchanged)."""
    return {n: gather_dim0(t, axis) if n in sharded else t
            for n, t in zip(names, tensors)}


def full_state_dict(net):
    """``net.state_dict()`` with the sharded parameters gathered whole (a
    collective over ``model``)."""
    sd = net.state_dict()
    axis = model_axis(net)
    if axis is None:
        return sd
    return full_tensors(list(sd.values()), list(sd), sharded_names(net), axis)


def slice_full(sd, net):
    """A full state dict cut to ``net``'s layout: this rank's dim-0 slice of
    every parameter that is sharded in ``net``."""
    axis = model_axis(net)
    if axis is None:
        return sd
    names = sharded_names(net)
    return {k: slice_dim0(v, axis) if k in names else v for k, v in sd.items()}


def load_full_state_dict(net, sd):
    net.load_state_dict(slice_full(sd, net), strict=True)


class _CopyIn(torch.autograd.Function):
    """Identity; the backward sums the gradient over ``model`` (the input of
    a sharded op, which gives each rank its part of the gradient)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.axis.group)
        return g, None


def copy_in(x, axis):
    if x is None or axis is None:
        return x
    return _CopyIn.apply(x, axis)


class _GatherDim(torch.autograd.Function):
    """Every model rank's slice concatenated along ``dim``; the backward
    keeps this rank's slice of the gradient, which every rank holds whole
    (no sum)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        xt = x.movedim(dim, -1).contiguous()
        parts = [torch.empty_like(xt) for _ in range(axis.size)]
        dist.all_gather(parts, xt, group=axis.group)
        out = torch.cat(parts, dim=-1).movedim(-1, dim)
        return out.contiguous(memory_format=CL) if out.dim() == 4 else out

    @staticmethod
    def backward(ctx, g):
        n, r = ctx.n, ctx.axis.rank
        g = g.narrow(ctx.dim, r * n, n)
        g = g.contiguous(memory_format=CL) if g.dim() == 4 else g.contiguous()
        return g, None, None


def gather_channels(y, axis, dim=1):
    """The whole output from the model ranks' channel slices."""
    return _GatherDim.apply(y, axis, dim)


def gather_param(p, module):
    """A parameter of ``module`` whole: gathered over ``model`` when the
    module is sharded."""
    axis = getattr(module, "tp", None)
    return p if axis is None else _GatherDim.apply(p, axis, 0)


def slice_channels(x, axis):
    """This rank's channel slice of x (B, C, H, W), channels_last."""
    n = x.shape[1] // axis.size
    return x[:, axis.rank * n:(axis.rank + 1) * n] \
        .contiguous(memory_format=CL)
