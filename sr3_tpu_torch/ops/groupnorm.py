"""GroupNorm with optional SiLU: kernel K2 (``csrc/groupnorm.cu``) and, for
large maps, the statistics route with kernel K3 (``csrc/gn_stats.cu``).

Counterpart of ``sr3_tpu/ops/groupnorm.py``: ``group_norm_plain`` is the
plain PyTorch version of the XLA spec ``group_norm_swish_xla`` (float32
one-pass sum / sum-of-squares statistics, variance clamped at 0, eps 1e-5);
``group_norm`` runs it for a CPU tensor and launches the Hopper kernel for a
CUDA tensor. ``group_norm`` is differentiable: its backward is the JAX
package's hand formula (``_gn_swish_fwd_bwd``), ``gn_silu_bwd``: the plain
version ``gn_silu_bwd_plain`` on the CPU, the backward kernel
(``csrc/gn_bwd.cu``, which replaces no Pallas kernel: the JAX package leaves
this backward to XLA) on CUDA, in an ``ops.kernel_backward`` span
(``utils/profiler.py``). ``gn_silu_bwd`` also takes K1's pre-affine and
gives its gradients, and ``gn_silu_act`` recomputes K1's activation with
the statistics ``gn_silu_bwd`` takes, for K1's backward
(``ops/conv_fused.py``).

On maps of H*W >= 256^2 (``STATS_MIN_HW``) ``group_norm`` takes the
statistics route instead, the counterpart of ``_gn_swish_stats_fwd_bwd``:
``gn_stats`` gives the per-(batch, channel) float32 sums (``gn_stats_plain``
for a CPU tensor, kernel K3 for a CUDA tensor), ``_group_fold`` turns them
into per-channel mean and rstd, and the normalize (+SiLU) is plain PyTorch,
as it is XLA there. Its backward is ``gn_silu_bwd`` on the statistics the
forward stashed, with no second pass over x for them. The JAX package
takes that route only on a TPU and behind an environment variable; in the
port the kernels are the default on CUDA, and the CPU takes the same route
with the plain sums. Tensors are logical NCHW in ``torch.channels_last``
memory.

On an H-shard of a map sharded over the mesh's space axis,
``group_norm_space`` takes K3's per-(b, c) sums of the shard
(``channel_sums``, differentiable), all-reduces them over the axis and
folds them (``space_stats``, which K1's halo route shares); the backward is
autograd of that composition, so the gradients of the statistics are
all-reduced as well.
"""


from __future__ import annotations

import ctypes

import torch

from sr3_tpu_torch.ops import _build
from sr3_tpu_torch.utils.profiler import Counter, span

counter = Counter("group_norm")
stats_counter = Counter("gn_stats")
bwd_counter = Counter("gn_silu_bwd")
act_counter = Counter("gn_silu_act")
# maps of at least this many pixels take the statistics route (K3)
STATS_MIN_HW = 256 * 256
# channels K1's and K2's GroupNorm kernels take (kGnMaxChannels, common.cuh)
KERNEL_MAX_CHANNELS = 1024


def check_channels_last(x, name="x"):
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(
            f"{name} must be a 4-D tensor in torch.channels_last memory "
            f"(got shape {tuple(x.shape)}, strides {tuple(x.stride())})")


# int32 ticket counters of K1's statistics launch, one tensor per (device,
# stream), zeroed once: the kernel leaves every counter it uses at 0 again
_tickets = {}


def stats_workspace(lib, x, num_groups):
    """(workspace, tickets) of K1's GroupNorm statistics of x (B,C,H,W):
    float32 scratch sized by the kernel library (per-channel mult / add and
    the blocks' sums) and B*C int32 ticket counters that are 0 between
    launches. The counters are kept per device and stream: launches on one
    stream run in order, and launches on two streams never share one."""
    b, c, h, w = x.shape
    n = lib.sr3_gn_workspace_floats(b, h * w, c, num_groups,
                                    _build.dtype_code(x))
    if n < 0:
        raise ValueError(f"the GroupNorm kernels do not take {c} channels in "
                         f"{num_groups} groups at batch {b} (kGnStatsMaxChannels, "
                         f"csrc/common.cuh)")
    key = (x.device, _build.stream_of(x))
    tickets = _tickets.get(key)
    if tickets is None or tickets.numel() < b * c:
        tickets = torch.zeros(max(b * c, 1 << 14), dtype=torch.int32,
                              device=x.device)
        _tickets[key] = tickets
    return torch.empty(n, dtype=torch.float32, device=x.device), tickets


# fields of the C library's GroupNorm plan (sr3_gn_plan)
PLAN_FIELDS = ("vec", "cb", "threads", "splits", "per", "resident",
               "smem_bytes", "sms")


def gn_plan(shape, num_groups, dtype, route="cluster"):
    """The kernels' plan for a (B, C, H, W) map of ``dtype`` in
    ``num_groups`` groups, from the C library on the current device:
    ``route`` "cluster" (K2: ``splits`` is the cluster size) or "stats"
    (K1's statistics launch); a dict of PLAN_FIELDS."""
    b, c, h, w = shape
    out = (ctypes.c_longlong * len(PLAN_FIELDS))()
    code = _build.DTYPE_CODES[dtype]
    err = _build.load_library().sr3_gn_plan(
        b, h * w, c, num_groups, code, 0 if route == "cluster" else 1, out)
    if err:
        raise ValueError(f"the GroupNorm kernels do not take {tuple(shape)} "
                         f"in {num_groups} groups")
    return dict(zip(PLAN_FIELDS, out))


def cluster_launches(reset=False):
    """K2's launches since the last reset, by (dtype, cluster size,
    resident), those not 0; ``reset`` sets them to 0 after reading. Loads
    the CUDA library."""
    counts = (ctypes.c_longlong * 64)()
    n = _build.load_library().sr3_group_norm_clusters(counts, int(reset))
    if n != len(counts):
        raise RuntimeError(f"the library reports {n} K2 launch counts, "
                           f"expected {len(counts)}")
    return {(("float32", "bfloat16")[i // 32], i % 16 + 1, bool(i // 16 % 2)):
            k for i, k in enumerate(counts) if k}


def _grouped(x, num_groups):
    """x (B,C,H,W) as float32 (B, G, C/G, H, W)."""
    b, c, h, w = x.shape
    return x.float().reshape(b, num_groups, c // num_groups, h, w)


def _group_stats(xf, eps):
    """One-pass group mean and rstd of grouped float32 xf, each
    (B, G, 1, 1, 1)."""
    mean = xf.mean(dim=(2, 3, 4), keepdim=True)
    msq = xf.square().mean(dim=(2, 3, 4), keepdim=True)
    var = (msq - mean.square()).clamp_min(0.0)
    return mean, torch.rsqrt(var + eps)


def _normalize(xf, weight, bias, mean, rstd, swish):
    """SiLU?(GroupNorm) of grouped float32 xf given its group statistics
    (broadcast against xf): float32 (B, C, H, W)."""
    b, num_groups, cg, h, w = xf.shape
    xn = ((xf - mean) * rstd).reshape(b, num_groups * cg, h, w)
    xn = xn * weight.float()[None, :, None, None] \
        + bias.float()[None, :, None, None]
    return xn * torch.sigmoid(xn) if swish else xn


def group_norm_plain(x, weight, bias, num_groups, eps=1e-5, swish=True):
    """x: (B,C,H,W). weight/bias: (C,). Same shape, dtype and layout as x."""
    xf = _grouped(x, num_groups)
    mean, rstd = _group_stats(xf, eps)
    return _normalize(xf, weight, bias, mean, rstd, swish).to(x.dtype) \
        .contiguous(memory_format=torch.channels_last)


def _gn_bwd(xf, weight, bias, g, mean, rstd, swish):
    """The hand backward of GroupNorm(+SiLU) of grouped float32 xf given its
    statistics (mean and rstd broadcast against xf). Returns float32 (dx
    (B,C,H,W), dweight (C,), dbias (C,))."""
    b, num_groups, cg, h, w = xf.shape
    c = num_groups * cg
    xhat = (xf - mean) * rstd
    per_channel = (1, num_groups, cg, 1, 1)
    sc = weight.float().reshape(per_channel)
    dz = g.float().reshape(xf.shape)
    if swish:
        z = xhat * sc + bias.float().reshape(per_channel)
        s = torch.sigmoid(z)
        dz = dz * (s * (1 + z * (1 - s)))
    dbias = dz.sum(dim=(0, 3, 4)).reshape(c)
    dweight = (dz * xhat).sum(dim=(0, 3, 4)).reshape(c)
    dzg = dz * sc
    m1 = dzg.mean(dim=(2, 3, 4), keepdim=True)
    m2 = (dzg * xhat).mean(dim=(2, 3, 4), keepdim=True)
    return (rstd * (dzg - m1 - xhat * m2)).reshape(b, c, h, w), dweight, dbias


def _pre_affine(xf, pre_scale, pre_bias):
    """a*x + b of float32 xf (B,C,H,W) for (B, C) pre_scale / pre_bias, each
    None for 1 / 0, in float32."""
    if pre_scale is not None:
        xf = xf * pre_scale.float()[:, :, None, None]
    if pre_bias is not None:
        xf = xf + pre_bias.float()[:, :, None, None]
    return xf


def _per_channel(t, c):
    """Group statistics (B, G, 1, 1, 1) -> per-channel (B, C)."""
    b, num_groups = t.shape[:2]
    return t.reshape(b, num_groups).repeat_interleave(c // num_groups, dim=1)


def gn_silu_bwd_plain(x, dy, weight, bias, num_groups, eps=1e-5, swish=True,
                      stats=None, pre_scale=None, pre_bias=None):
    """Gradients of y = SiLU?(GroupNorm(v)), v = a*x + b, for the output
    gradient dy: the hand formula of ``_gn_swish_fwd_bwd`` (the SiLU
    derivative when ``swish``), extended by the pre-affine. v is taken in
    float32 (a, b: (B, C) ``pre_scale`` / ``pre_bias``, 1 / 0 where None);
    ``stats``: per-(b, c) (mean, rstd) of v's groups, (B, C) float32 each,
    or None to take them in one pass (the variance clamped at 0). Returns
    (dx, dweight, dbias, dpre_scale, dpre_bias): dx of x's dtype and layout,
    dweight and dbias float32 (C,), dpre_* float32 (B, C) or None where
    pre_* is None."""
    b, c = x.shape[:2]
    xf = x.float()
    vg = _grouped(_pre_affine(xf, pre_scale, pre_bias), num_groups)
    if stats is None:
        mean, rstd = _group_stats(vg, eps)
    else:
        per_group = (b, num_groups, c // num_groups, 1, 1)
        mean, rstd = (t.float().reshape(per_group) for t in stats)
    dv, dweight, dbias = _gn_bwd(vg, weight, bias, dy, mean, rstd, swish)
    dpre_scale = None if pre_scale is None else (dv * xf).sum(dim=(2, 3))
    dpre_bias = None if pre_bias is None else dv.sum(dim=(2, 3))
    dx = _pre_affine(dv, pre_scale, None)
    return (dx.to(x.dtype).contiguous(memory_format=torch.channels_last),
            dweight, dbias, dpre_scale, dpre_bias)


def gn_silu_act_plain(x, weight, bias, num_groups, eps=1e-5, pre_scale=None,
                      pre_bias=None):
    """(act, (mean, rstd)): K1's activation SiLU(GroupNorm(a*x + b)) with v =
    a*x + b in float32, in x's dtype and layout, and the per-(b, c)
    statistics of v's groups, (B, C) float32 each."""
    c = x.shape[1]
    vg = _grouped(_pre_affine(x.float(), pre_scale, pre_bias), num_groups)
    mean, rstd = _group_stats(vg, eps)
    act = _normalize(vg, weight, bias, mean, rstd, True).to(x.dtype)
    return (act.contiguous(memory_format=torch.channels_last),
            (_per_channel(mean, c), _per_channel(rstd, c)))


def f32_or_none(t, shape, name):
    """A per-sample tensor of ``shape`` as contiguous float32, or None."""
    if t is None:
        return None
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    return t.float().contiguous()


def _aligned(t):
    """t in channels_last memory, copied where its data does not start
    16-byte aligned."""
    t = t.contiguous(memory_format=torch.channels_last)
    return t if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.channels_last)


def _bwd_operands(x, weight, bias, num_groups, pre_scale, pre_bias):
    """What both CUDA entries of the backward kernel take: the library, x
    16-byte aligned, the float32 workspace, the pre-affine (B, C) and the
    affine (C,) as contiguous float32 (None where absent)."""
    b, c, h, w = x.shape
    lib = _build.load_library()
    x = _aligned(x)
    pre = pre_scale is not None or pre_bias is not None
    n = lib.sr3_gn_bwd_workspace_floats(b, h * w, c, num_groups,
                                        _build.dtype_code(x), int(pre))
    if n < 0:
        raise ValueError(f"the GroupNorm backward kernel takes C a multiple "
                         f"of {16 // x.element_size()} for {x.dtype}, at "
                         f"most {KERNEL_MAX_CHANNELS}, in whole groups; got "
                         f"C={c} in {num_groups} groups")
    ws = torch.empty(n, dtype=torch.float32, device=x.device)
    return (lib, x, ws, f32_or_none(pre_scale, (b, c), "pre_scale"),
            f32_or_none(pre_bias, (b, c), "pre_bias"),
            weight.float().contiguous(), bias.float().contiguous())


def gn_silu_bwd(x, dy, weight, bias, num_groups, eps=1e-5, swish=True,
                stats=None, pre_scale=None, pre_bias=None):
    """``gn_silu_bwd_plain``'s gradients: the plain version on the CPU, the
    backward kernel (``csrc/gn_bwd.cu``) on CUDA, which takes ``stats`` in a
    pass of its own where they are None."""
    check_channels_last(x)
    if x.device.type == "cpu":
        return gn_silu_bwd_plain(x, dy, weight, bias, num_groups, eps, swish,
                                 stats, pre_scale, pre_bias)
    if x.device.type != "cuda":
        raise ValueError(f"gn_silu_bwd runs on cpu or cuda, not {x.device}")
    b, c, h, w = x.shape
    lib, x, ws, ps, pb, gamma, beta = _bwd_operands(
        x, weight, bias, num_groups, pre_scale, pre_bias)
    dy = _aligned(dy.to(x.dtype))
    mean, rstd = (None, None) if stats is None else (
        f32_or_none(t, (b, c), "stats") for t in stats)
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=x.device)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    dweight, dbias = f32(c), f32(c)
    dps = None if ps is None else f32(b, c)
    dpb = None if pb is None else f32(b, c)
    ptr = _build.ptr
    err = lib.sr3_gn_bwd(
        x.data_ptr(), dy.data_ptr(), ptr(ps), ptr(pb), gamma.data_ptr(),
        beta.data_ptr(), ptr(mean), ptr(rstd), dx.data_ptr(),
        dweight.data_ptr(), dbias.data_ptr(), ptr(dps), ptr(dpb),
        ws.data_ptr(), b, h * w, c, num_groups, float(eps), int(swish),
        _build.dtype_code(x), _build.stream_of(x))
    _build.check(err, "sr3_gn_bwd")
    bwd_counter.n += 1
    return dx, dweight, dbias, dps, dpb


def gn_silu_act(x, weight, bias, num_groups, eps=1e-5, pre_scale=None,
                pre_bias=None):
    """``gn_silu_act_plain``: the plain version on the CPU, the backward
    kernel's statistics and activation launches on CUDA."""
    check_channels_last(x)
    if x.device.type == "cpu":
        return gn_silu_act_plain(x, weight, bias, num_groups, eps, pre_scale,
                                 pre_bias)
    if x.device.type != "cuda":
        raise ValueError(f"gn_silu_act runs on cpu or cuda, not {x.device}")
    b, c, h, w = x.shape
    lib, x, ws, ps, pb, gamma, beta = _bwd_operands(
        x, weight, bias, num_groups, pre_scale, pre_bias)
    act = torch.empty_like(x, memory_format=torch.channels_last)
    stats = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    ptr = _build.ptr
    err = lib.sr3_gn_bwd_act(
        x.data_ptr(), ptr(ps), ptr(pb), gamma.data_ptr(), beta.data_ptr(),
        act.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
        ws.data_ptr(), b, h * w, c, num_groups, float(eps),
        _build.dtype_code(x), _build.stream_of(x))
    _build.check(err, "sr3_gn_bwd_act")
    act_counter.n += 1
    return act, (stats[0], stats[1])


def _group_norm_fwd(x, weight, bias, num_groups, eps, swish):
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, num_groups, eps, swish)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm runs on cpu or cuda, not {x.device}")
    b, c, h, w = x.shape
    if c > KERNEL_MAX_CHANNELS:
        raise ValueError(f"the GroupNorm kernel takes at most "
                         f"{KERNEL_MAX_CHANNELS} channels, got {c}")
    lib = _build.load_library()
    y = torch.empty_like(x, memory_format=torch.channels_last)
    gamma = weight.float().contiguous()
    beta = bias.float().contiguous()
    err = lib.sr3_group_norm(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        b, h * w, c, num_groups, float(eps), int(swish),
        _build.dtype_code(x), _build.stream_of(x),
    )
    _build.check(err, "sr3_group_norm")
    counter.n += 1
    return y


class _GroupNorm(torch.autograd.Function):
    """Counterpart of ``_gn_swish_fwd_bwd``: kernel forward, hand backward
    (``gn_silu_bwd``, its own statistics pass)."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, swish):
        ctx.save_for_backward(x, weight, bias)
        ctx.cfg = (num_groups, eps, swish)
        return _group_norm_fwd(x, weight, bias, num_groups, eps, swish)

    @staticmethod
    def backward(ctx, g):
        x, weight, bias = ctx.saved_tensors
        with span("ops.kernel_backward", g, op="group_norm"):
            dx, dw, db, _, _ = gn_silu_bwd(x, g, weight, bias, *ctx.cfg)
            dw, db = dw.to(weight.dtype), db.to(bias.dtype)
        return dx, dw, db, None, None, None


def gn_stats_plain(x):
    """(s1, s2): float32 (B, C) sums of x and of x^2 over the pixels of
    x (B,C,H,W)."""
    xf = x.float()
    return xf.sum(dim=(2, 3)), xf.square().sum(dim=(2, 3))


def gn_stats(x):
    """Per-(batch, channel) float32 sums (s1, s2) of x and x^2: the plain
    version on the CPU, kernel K3 on CUDA."""
    check_channels_last(x)
    if x.device.type == "cpu":
        return gn_stats_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"gn_stats runs on cpu or cuda, not {x.device}")
    b, c, h, w = x.shape
    if x.data_ptr() % 16:
        raise ValueError("x must start 16-byte aligned")
    lib = _build.load_library()
    code = _build.dtype_code(x)
    n = lib.sr3_gn_stats_workspace_floats(b, h * w, c, code)
    if n < 0:
        raise ValueError(f"the statistics kernel takes C a multiple of "
                         f"{16 // x.element_size()} and at most "
                         f"{256 * 16 // x.element_size()} for {x.dtype}, and "
                         f"B <= 65535; got B={b}, C={c}")
    ws = torch.empty(n, dtype=torch.float32, device=x.device)
    s1, s2 = (torch.empty((b, c), dtype=torch.float32, device=x.device)
              for _ in range(2))
    err = lib.sr3_gn_stats(x.data_ptr(), s1.data_ptr(), s2.data_ptr(),
                           ws.data_ptr(), b, h * w, c, code,
                           _build.stream_of(x))
    _build.check(err, "sr3_gn_stats")
    stats_counter.n += 1
    return s1, s2


def _group_fold(s1, s2, n, num_groups, eps):
    """(B, C) channel sums over n pixels -> per-channel (B, C) mean and rstd
    of their groups (one-pass variance clamped at 0)."""
    b, c = s1.shape
    cg = c // num_groups
    cnt = float(n * cg)
    mean_g = s1.reshape(b, num_groups, cg).sum(dim=2) / cnt
    var_g = (s2.reshape(b, num_groups, cg).sum(dim=2) / cnt
             - mean_g.square()).clamp_min(0.0)
    rstd_g = torch.rsqrt(var_g + eps)
    return mean_g.repeat_interleave(cg, dim=1), \
        rstd_g.repeat_interleave(cg, dim=1)


def _stats_fwd(x, weight, bias, num_groups, eps, swish):
    """The statistics route's forward: (y, mean_c, rstd_c)."""
    b, c, h, w = x.shape
    mean_c, rstd_c = _group_fold(*gn_stats(x), h * w, num_groups, eps)
    sc = weight.float()[None] * rstd_c
    off = bias.float()[None] - mean_c * sc
    z = x.float() * sc[:, :, None, None] + off[:, :, None, None]
    if swish:
        z = z * torch.sigmoid(z)
    y = z.to(x.dtype).contiguous(memory_format=torch.channels_last)
    return y, mean_c, rstd_c


class _GroupNormStats(torch.autograd.Function):
    """Counterpart of ``_gn_swish_stats_fwd_bwd``: K3 statistics and a torch
    normalize; the backward is ``gn_silu_bwd`` on the stashed (B, C)
    statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, swish):
        y, mean_c, rstd_c = _stats_fwd(x, weight, bias, num_groups, eps,
                                       swish)
        ctx.save_for_backward(x, weight, bias, mean_c, rstd_c)
        ctx.cfg = (num_groups, swish)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, bias, mean_c, rstd_c = ctx.saved_tensors
        with span("ops.kernel_backward", g, op="group_norm_stats"):
            num_groups, swish = ctx.cfg
            dx, dw, db, _, _ = gn_silu_bwd(x, g, weight, bias, num_groups,
                                           swish=swish,
                                           stats=(mean_c, rstd_c))
            dw, db = dw.to(weight.dtype), db.to(bias.dtype)
        return dx, dw, db, None, None, None


def _check_groups(x, num_groups):
    check_channels_last(x)
    c = x.shape[1]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")


def group_norm_stats(x, weight, bias, num_groups, eps=1e-5, swish=True):
    """GroupNorm(+SiLU) through the statistics route at any map size:
    ``gn_stats`` (kernel K3 on CUDA), the group fold and a torch normalize;
    differentiable in x, weight and bias."""
    _check_groups(x, num_groups)
    if _build.needs_grad(x, weight, bias):
        return _GroupNormStats.apply(x, weight, bias, num_groups, eps, swish)
    return _stats_fwd(x, weight, bias, num_groups, eps, swish)[0]


def group_norm(x, weight, bias, num_groups, eps=1e-5, swish=True):
    """GroupNorm(+SiLU): the plain version on the CPU, kernel K2 on CUDA;
    maps of H*W >= STATS_MIN_HW take the statistics route
    (``group_norm_stats``). Differentiable in x, weight and bias."""
    _check_groups(x, num_groups)
    if x.shape[2] * x.shape[3] >= STATS_MIN_HW:
        return group_norm_stats(x, weight, bias, num_groups, eps, swish)
    if _build.needs_grad(x, weight, bias):
        return _GroupNorm.apply(x, weight, bias, num_groups, eps, swish)
    return _group_norm_fwd(x, weight, bias, num_groups, eps, swish)


class _ChannelSums(torch.autograd.Function):
    """(s1, s2) = per-(b, c) sums of x and x^2 by ``gn_stats`` (kernel K3
    on CUDA); the backward is ds1 + 2 x ds2."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return gn_stats(x)

    @staticmethod
    def backward(ctx, g1, g2):
        (x,) = ctx.saved_tensors
        dx = g1[:, :, None, None] + 2.0 * x.float() * g2[:, :, None, None]
        return dx.to(x.dtype).contiguous(memory_format=torch.channels_last)


def channel_sums(x):
    """Differentiable per-(b, c) float32 sums (s1, s2) of x and x^2."""
    check_channels_last(x)
    if _build.needs_grad(x):
        return _ChannelSums.apply(x)
    return gn_stats(x)


def space_stats(x, num_groups, eps, axis, pre_scale=None, pre_bias=None):
    """Per-(b, c) mean and rstd of the groups of a*x + b over the whole map
    of which x (B, C, h, W) is this rank's H-shard: K3's sums of the shard,
    adjusted in float32 for the pre-affine (sums of a*x+b and its square),
    all-reduced over ``axis``, then folded. Differentiable."""
    from sr3_tpu_torch.parallel.spatial import all_reduce_sum

    b, c, h, w = x.shape
    s1, s2 = channel_sums(x)
    n = float(h * w)
    if pre_scale is not None:
        a = pre_scale.float()
        s1, s2 = a * s1, a.square() * s2
    if pre_bias is not None:
        pb = pre_bias.float()
        s1, s2 = s1 + n * pb, s2 + 2.0 * pb * s1 + n * pb.square()
    sums = all_reduce_sum(torch.stack([s1, s2]), axis)
    return _group_fold(sums[0], sums[1], h * w * axis.size, num_groups, eps)


def group_norm_space(x, weight, bias, num_groups, axis, eps=1e-5,
                     swish=True):
    """GroupNorm(+SiLU) of the H-shard x of a map sharded over ``axis``:
    the statistics of the whole map (``space_stats``: K3, all-reduce, fold)
    and a torch normalize; differentiable (the statistics' gradients are
    all-reduced over ``axis`` through ``all_reduce_sum``'s backward)."""
    _check_groups(x, num_groups)
    mean_c, rstd_c = space_stats(x, num_groups, eps, axis)
    sc = weight.float()[None] * rstd_c
    off = bias.float()[None] - mean_c * sc
    z = x.float() * sc[:, :, None, None] + off[:, :, None, None]
    if swish:
        z = z * torch.sigmoid(z)
    return z.to(x.dtype).contiguous(memory_format=torch.channels_last)
