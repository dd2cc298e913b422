"""Activations sharded on H over the mesh's ``space`` axis, by hand.

Counterpart of ``sr3_tpu/parallel/spatial.py`` (``spatial_constraint``),
where GSPMD inserts the halo exchanges, the GroupNorm reductions and the
gathers around attention. Here each is written out, and the kernels keep
running on the shards: K1 through its halo entry
(``ops/conv_fused.py`` ``gn_silu_conv3x3_space``), every other GroupNorm
through K3's per-(b, c) sums all-reduced over ``space``
(``ops/groupnorm.py`` ``group_norm_space``), attention (K4-K6) on the
gathered tokens.

A space rank holds rows [r * H / S, (r + 1) * H / S) of every map of a
sharded level. A level is sharded when S divides its H and a shard keeps at
least 2 rows (``sharded``); any other level runs replicated, gathered on
the way in and re-sliced on the way out, as ``spatial_constraint`` passes
such shapes through.

Gradients follow one convention inside the UNet: a rank's gradient of a
replicated tensor is its partial, the part that flows from its own rows.
``gather_rows``' backward sums the partials over the ranks and keeps the
rank's rows; ``slice_rows``' backward is the plain one; ``all_reduce_sum``'s
backward sums the partials. So every parameter's gradient on a rank is a
partial too, and the trainer sums them over ``space`` before the data-axis
mean. At the UNet's output, which the loss reads whole on every rank,
``gather_output`` keeps the rank's own rows of the output gradient (every
rank holds the same whole one).

Collectives used: ``all_gather`` (list form) and ``all_reduce`` SUM, both of
which gloo also takes for CUDA tensors.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

CL = torch.channels_last


def sharded(h, axis):
    """Whether a level of (full) height h is sharded over ``axis``."""
    return (axis is not None and axis.size > 1 and h % axis.size == 0
            and h // axis.size >= 2)


def _gather(x, axis):
    """Every rank's x, in rank order (same shape on all ranks)."""
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(axis.size)]
    dist.all_gather(parts, x.contiguous(), group=axis.group)
    return parts


def _all_reduce(x, axis):
    x = x.contiguous()
    dist.all_reduce(x, group=axis.group)
    return x


class _HaloExchange(torch.autograd.Function):
    """(top, bottom): the row above and the row below this rank's rows,
    from its space neighbours; zeros at the image border. Forward: one
    all_gather of every rank's two edge rows. Backward: the halo rows'
    gradients go back to their owners through one all_gather and are added
    onto the owners' edge rows."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.h = axis, x.shape[2]
        r, s = axis.rank, axis.size
        parts = _gather(torch.cat([x[:, :, :1], x[:, :, -1:]], dim=2), axis)
        zero = torch.zeros_like(parts[0][:, :, :1])
        top = parts[r - 1][:, :, 1:] if r > 0 else zero
        bottom = parts[r + 1][:, :, :1] if r < s - 1 else zero
        return (top.contiguous(memory_format=CL),
                bottom.contiguous(memory_format=CL))

    @staticmethod
    def backward(ctx, g_top, g_bottom):
        axis = ctx.axis
        r, s = axis.rank, axis.size
        parts = _gather(torch.cat([g_top, g_bottom], dim=2), axis)
        b, c, _, w = g_top.shape
        dx = g_top.new_zeros((b, c, ctx.h, w))
        if r > 0:  # my first row is rank r-1's bottom halo
            dx[:, :, :1] += parts[r - 1][:, :, 1:]
        if r < s - 1:  # my last row is rank r+1's top halo
            dx[:, :, -1:] += parts[r + 1][:, :, :1]
        return dx.contiguous(memory_format=CL), None


def halo_exchange(x, axis):
    """(top, bottom) halo rows of the H-shard x (B, C, h, W), each
    (B, C, 1, W) in channels_last memory, zeros beyond the image;
    differentiable."""
    return _HaloExchange.apply(x, axis)


def is_border(axis):
    """(top, bottom): whether this rank's top / bottom halo is the image's
    zero padding."""
    return axis.rank == 0, axis.rank == axis.size - 1


class _GatherRows(torch.autograd.Function):
    """All ranks' rows concatenated on H; the backward sums the ranks'
    partial gradients (``own_rows=False``) or takes the rank's own rows of
    a gradient that every rank holds whole (``own_rows=True``)."""

    @staticmethod
    def forward(ctx, x, axis, whole_grad):
        ctx.axis, ctx.h, ctx.whole_grad = axis, x.shape[2], whole_grad
        return torch.cat(_gather(x, axis), dim=2) \
            .contiguous(memory_format=CL)

    @staticmethod
    def backward(ctx, g):
        axis, h = ctx.axis, ctx.h
        if not ctx.whole_grad:
            g = _all_reduce(g, axis)
        g = g[:, :, axis.rank * h:(axis.rank + 1) * h]
        return g.contiguous(memory_format=CL), None, None


def gather_rows(x, axis):
    """The whole map from the H-shards (inside the UNet: partial-gradient
    convention)."""
    return _GatherRows.apply(x, axis, False)


def gather_output(x, axis):
    """The whole map from the H-shards at the UNet's output, whose gradient
    every rank holds whole: the backward keeps the rank's own rows."""
    return _GatherRows.apply(x, axis, True)


class _RankZero(torch.autograd.Function):
    """Identity; the backward keeps the gradient on space rank 0 only (a
    replicated output whose gradient every rank holds whole)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.axis.rank == 0 else torch.zeros_like(g)), None


def replicated_output(x, axis):
    return _RankZero.apply(x, axis)


def row_slice(h_full, axis):
    h = h_full // axis.size
    return slice(axis.rank * h, (axis.rank + 1) * h)


def slice_rows(x, axis):
    """This rank's rows of a whole map."""
    return x[:, :, row_slice(x.shape[2], axis)].contiguous(memory_format=CL)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of ``axis``; the backward sums the partial
    gradients."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_reduce(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.axis), None


def all_reduce_sum(x, axis):
    return _AllReduceSum.apply(x, axis)


def halo_conv2d(x, weight, bias, axis, stride=1):
    """3x3 convolution (padding 1) of the H-shard x with its halo rows
    (zero padding at the image border): one row above and below from the
    neighbours, then ``F.conv2d`` with padding only on W. Stride 2 (the
    Downsample) needs an even shard height; its output is this rank's rows
    of the strided map."""
    if stride == 2 and x.shape[2] % 2:
        raise ValueError(f"a stride-2 halo conv needs an even shard height, "
                         f"got {x.shape[2]}")
    top, bottom = halo_exchange(x, axis)
    ext = torch.cat([top, x, bottom], dim=2)
    y = F.conv2d(ext, weight, bias, stride=stride, padding=(0, 1))
    return y.contiguous(memory_format=CL)
