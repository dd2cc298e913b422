"""The GroupNorm(+SiLU) backward of K1 and K2 on the CPU, where each step
is its plain version.

- ``gn_silu_bwd_plain`` against autograd through ``group_norm_plain`` (K2)
  and, with the pre-affine, through ``gn_silu_conv3x3_plain``'s norm;
- K1's backward decomposition (``gn_silu_act``, ``convolution_backward``,
  ``gn_silu_bwd``) through the autograd Function against autograd through
  ``gn_silu_conv3x3_plain``, every input's gradient;
- the statistics route's Function on its stashed statistics;
- K1's and K2's Functions against ``jax.vjp`` of the JAX package's
  dispatchers (``_fused_fwd_bwd``, ``_gn_swish_fwd_bwd``) on the same numpy
  inputs;
- ``gn_silu_act_plain`` against K1's plain norm and its statistics against
  the group fold; CPU calls count no launch.

Tolerance: float32, atol 2e-5 (values O(1); only the order of float32 sums
and where the pre-affine's products are rounded differ)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sr3_tpu.ops.conv_fused import gn_silu_conv3x3 as jax_fused
from sr3_tpu.ops.groupnorm import group_norm_swish
from sr3_tpu_torch.ops import conv_fused, groupnorm

ATOL = 2e-5
CL = torch.channels_last


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b=2, c=32, hw=6, cout=16, pre_scale=False, pre_bias=False,
            residual=False):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    return dict(
        x=(2 * r(b, c, hw, hw) + 0.5).contiguous(memory_format=CL),
        gw=1 + 0.2 * r(c), gb=0.1 * r(c),
        w=(0.1 * r(cout, c, 3, 3)).contiguous(memory_format=CL),
        cb=0.1 * r(cout),
        ps=1 + 0.3 * r(b, c) if pre_scale else None,
        pb=0.5 * r(b, c) if pre_bias else None,
        res=r(b, cout, hw, hw).contiguous(memory_format=CL)
        if residual else None,
        dy=r(b, c, hw, hw), dout=r(b, cout, hw, hw))


def _autograd(fn, leaves, dout):
    leaves = [None if t is None else t.detach().clone().requires_grad_()
              for t in leaves]
    out = fn(*leaves)
    wrt = [t for t in leaves if t is not None]
    grads = iter(torch.autograd.grad(out, wrt, dout))
    return [None if t is None else next(grads) for t in leaves]


def _close(got, want, name=""):
    assert (got is None) == (want is None), name
    if got is not None:
        assert got.dtype == want.dtype, name
        np.testing.assert_allclose(got.detach().numpy(),
                                   want.detach().numpy(), atol=ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("groups", [16, 32])
@pytest.mark.parametrize("swish", [True, False])
@pytest.mark.parametrize("pre", ["none", "scale", "bias", "both"])
def test_plain_backward_matches_autograd(groups, swish, pre):
    """gn_silu_bwd_plain against autograd through group_norm_plain of a*x+b
    (the pre-affine in float32, as the kernels take it)."""
    a = _inputs(1, pre_scale=pre in ("scale", "both"),
                pre_bias=pre in ("bias", "both"))

    def forward(x, gw, gb, ps, pb):
        v = x
        if ps is not None:
            v = v * ps[:, :, None, None]
        if pb is not None:
            v = v + pb[:, :, None, None]
        return groupnorm.group_norm_plain(v.contiguous(memory_format=CL), gw,
                                          gb, groups, swish=swish)

    want = _autograd(forward, [a["x"], a["gw"], a["gb"], a["ps"], a["pb"]],
                     a["dy"])
    dx, dgw, dgb, dps, dpb = groupnorm.gn_silu_bwd_plain(
        a["x"], a["dy"], a["gw"], a["gb"], groups, swish=swish,
        pre_scale=a["ps"], pre_bias=a["pb"])
    assert dx.is_contiguous(memory_format=CL)
    for name, got, ref in zip(["x", "gw", "gb", "ps", "pb"],
                              [dx, dgw, dgb, dps, dpb], want):
        _close(got, ref, name)


@pytest.mark.parametrize("groups", [16, 32])
@pytest.mark.parametrize("pre_scale,pre_bias,residual", [
    (False, False, False), (True, False, False), (False, True, False),
    (True, True, False), (False, False, True), (True, True, True)])
def test_k1_decomposition_matches_autograd_of_the_plain_version(
        groups, pre_scale, pre_bias, residual):
    """The K1 Function's backward (activation recompute, the conv's
    gradients, gn_silu_bwd) against autograd through the plain version, for
    every input."""
    a = _inputs(2, pre_scale=pre_scale, pre_bias=pre_bias,
                residual=residual)
    leaves = [a["x"], a["gw"], a["gb"], a["w"], a["cb"], a["ps"], a["pb"],
              a["res"]]
    call = lambda f: lambda *t: f(*t[:5], groups, pre_scale=t[5],
                                  pre_bias=t[6], residual=t[7])
    got = _autograd(call(conv_fused.gn_silu_conv3x3), leaves, a["dout"])
    want = _autograd(call(conv_fused.gn_silu_conv3x3_plain), leaves,
                     a["dout"])
    for name, g, w in zip(["x", "gw", "gb", "w", "cb", "ps", "pb", "res"],
                          got, want):
        _close(g, w, name)


@pytest.mark.parametrize("need", ["x", "w", "gw", "res"])
def test_k1_backward_gives_only_what_is_asked(need):
    """With one input requiring grad, the Function hands back that gradient
    alone, equal to autograd's."""
    a = _inputs(3, pre_scale=True, pre_bias=True, residual=True)
    names = ["x", "gw", "gb", "w", "cb", "ps", "pb", "res"]
    vals = [a["x"], a["gw"], a["gb"], a["w"], a["cb"], a["ps"], a["pb"],
            a["res"]]
    outs = []
    for f in (conv_fused.gn_silu_conv3x3, conv_fused.gn_silu_conv3x3_plain):
        leaves = [t.detach().clone().requires_grad_(n == need)
                  for n, t in zip(names, vals)]
        out = f(*leaves[:5], 16, pre_scale=leaves[5], pre_bias=leaves[6],
                residual=leaves[7])
        (out * a["dout"]).sum().backward()
        outs.append([t.grad for t in leaves])
    for n, g, w in zip(names, *outs):
        if n != need:
            assert g is None and w is None, n
        else:
            _close(g, w, n)


@pytest.mark.parametrize("groups", [16, 32])
@pytest.mark.parametrize("swish", [True, False])
def test_k2_function_matches_autograd_of_the_plain_version(groups, swish):
    a = _inputs(4)
    leaves = [a["x"], a["gw"], a["gb"]]
    call = lambda f: lambda *t: f(*t, groups, swish=swish)
    got = _autograd(call(groupnorm.group_norm), leaves, a["dy"])
    want = _autograd(call(groupnorm.group_norm_plain), leaves, a["dy"])
    for name, g, w in zip(["x", "gw", "gb"], got, want):
        _close(g, w, name)


@pytest.mark.parametrize("groups", [16, 32])
@pytest.mark.parametrize("swish", [True, False])
def test_statistics_route_backward_on_its_stashed_statistics(groups, swish):
    """The statistics route's Function (at any map size through
    group_norm_stats) against autograd of the plain version, and
    gn_silu_bwd_plain on the route's statistics against the one that takes
    its own."""
    a = _inputs(5)
    leaves = [a["x"], a["gw"], a["gb"]]
    call = lambda f: lambda *t: f(*t, groups, swish=swish)
    got = _autograd(call(groupnorm.group_norm_stats), leaves, a["dy"])
    want = _autograd(call(groupnorm.group_norm_plain), leaves, a["dy"])
    for name, g, w in zip(["x", "gw", "gb"], got, want):
        _close(g, w, name)
    b, c, h, w = a["x"].shape
    s1, s2 = groupnorm.gn_stats(a["x"])
    stats = groupnorm._group_fold(s1, s2, h * w, groups, 1e-5)
    given = groupnorm.gn_silu_bwd_plain(a["x"], a["dy"], a["gw"], a["gb"],
                                        groups, swish=swish, stats=stats)
    own = groupnorm.gn_silu_bwd_plain(a["x"], a["dy"], a["gw"], a["gb"],
                                      groups, swish=swish)
    for name, g, w in zip(["x", "gw", "gb"], given, own):
        _close(g, w, name)


@pytest.mark.parametrize("pre", [False, True])
def test_activation_recompute_matches_the_forward_norm(pre):
    """gn_silu_act_plain gives K1's plain norm of a*x + b and the per-(b, c)
    statistics of its groups."""
    a = _inputs(6, pre_scale=pre, pre_bias=pre)
    act, (mean, rstd) = groupnorm.gn_silu_act(a["x"], a["gw"], a["gb"], 16,
                                              pre_scale=a["ps"],
                                              pre_bias=a["pb"])
    v = groupnorm._pre_affine(a["x"].float(), a["ps"], a["pb"])
    v = v.contiguous(memory_format=CL)
    _close(act, groupnorm.group_norm_plain(v, a["gw"], a["gb"], 16))
    assert act.is_contiguous(memory_format=CL)
    b, c, h, w = v.shape
    s1, s2 = groupnorm.gn_stats_plain(v)
    want = groupnorm._group_fold(s1, s2, h * w, 16, 1e-5)
    for got, ref in zip((mean, rstd), want):
        assert got.shape == (b, c)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize("groups", [16, 32])
@pytest.mark.parametrize("affine,residual", [(False, False), (True, False),
                                             (True, True)])
def test_k1_function_grads_match_jax_vjp(groups, affine, residual):
    """Every input gradient of the K1 Function against jax.vjp of the JAX
    dispatcher with the Pallas kernel (``_fused_fwd_bwd``: the XLA vjp of
    the plain composition), on the same numpy inputs. 64 channels: groups of
    one channel over 64 pixels give both sides' one-pass float32 variance a
    gap of 6e-5 from float64 (the plain version's autograd alike)."""
    rng = np.random.default_rng(7)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    b, hw, c, cout = 2, 8, 64, 16
    a = dict(x=2 * f(b, hw, hw, c) + 0.5, gs=1 + 0.2 * f(c), gb=0.1 * f(c),
             k=0.1 * f(3, 3, c, cout), cb=0.1 * f(cout),
             ps=1 + 0.3 * f(b, c) if affine else None,
             pb=0.5 * f(b, c) if affine else None,
             res=f(b, hw, hw, cout) if residual else None)
    g = f(b, hw, hw, cout)
    names = ["x", "gs", "gb", "k", "cb", "ps", "pb", "res"]
    present = [n for n in names if a[n] is not None]
    t = {n: (nchw(a[n]) if n in ("x", "res") else
             torch.from_numpy(a[n]).permute(3, 2, 0, 1).contiguous(
                 memory_format=CL) if n == "k" else torch.from_numpy(a[n]))
         for n in present}
    leaves = [None if n not in t else t[n].requires_grad_() for n in names]
    out = conv_fused.gn_silu_conv3x3(*leaves[:5], groups, pre_scale=leaves[5],
                                     pre_bias=leaves[6], residual=leaves[7])
    ours = dict(zip(present, torch.autograd.grad(
        out, [t[n] for n in present], nchw(g))))

    def fn(*vals):
        kw = dict(zip(present, vals))
        return jax_fused(kw["x"], kw["gs"], kw["gb"], kw["k"], kw["cb"],
                         groups, pre_scale=kw.get("ps"),
                         pre_bias=kw.get("pb"), residual=kw.get("res"),
                         use_pallas=True, interpret=True)

    _, vjp = jax.vjp(fn, *(jnp.asarray(a[n]) for n in present))
    ref = dict(zip(present, vjp(jnp.asarray(g))))
    layout = {"x": nhwc, "res": nhwc,
              "k": lambda v: v.permute(2, 3, 1, 0).numpy()}
    for n in present:
        got = layout.get(n, lambda v: v.numpy())(ours[n])
        np.testing.assert_allclose(got, np.asarray(ref[n]), atol=ATOL,
                                   rtol=0, err_msg=n)


@pytest.mark.parametrize("groups", [16, 32])
@pytest.mark.parametrize("swish", [True, False])
@pytest.mark.parametrize("route", ["kernel", "stats"])
def test_k2_and_route_grads_match_jax_vjp(groups, swish, route):
    """K2's Function and the statistics route's against jax.vjp of
    ``group_norm_swish`` with the Pallas kernel (``_gn_swish_fwd_bwd``)."""
    rng = np.random.default_rng(8)
    x = (2.0 * rng.standard_normal((2, 8, 8, 32)) + 0.5).astype(np.float32)
    s = (1.0 + 0.2 * rng.standard_normal(32)).astype(np.float32)
    b = (0.1 * rng.standard_normal(32)).astype(np.float32)
    g = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    fn = groupnorm.group_norm if route == "kernel" else \
        groupnorm.group_norm_stats
    inputs = [nchw(x).requires_grad_(), torch.from_numpy(s).requires_grad_(),
              torch.from_numpy(b).requires_grad_()]
    out = fn(*inputs, groups, swish=swish)
    dx, ds, db = torch.autograd.grad(out, inputs, nchw(g))
    _, vjp = jax.vjp(
        lambda p, q, r: group_norm_swish(p, q, r, groups, swish=swish,
                                         use_pallas=True, interpret=True),
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    rdx, rds, rdb = vjp(jnp.asarray(g))
    np.testing.assert_allclose(nhwc(dx), np.asarray(rdx), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ds.numpy(), np.asarray(rds), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(db.numpy(), np.asarray(rdb), atol=ATOL,
                               rtol=0)


def test_cpu_backwards_count_no_launch():
    groupnorm.bwd_counter.n = groupnorm.act_counter.n = 0
    a = _inputs(9, pre_bias=True, residual=True)
    leaves = [a[n].requires_grad_() for n in ("x", "gw", "gb", "w", "cb",
                                               "pb")]
    out = conv_fused.gn_silu_conv3x3(*leaves[:5], 16, pre_bias=leaves[5])
    y = groupnorm.group_norm(out, torch.ones(16), torch.zeros(16), 8)
    y.sum().backward()
    assert (groupnorm.bwd_counter.n, groupnorm.act_counter.n) == (0, 0)
    assert all(t.grad is not None for t in leaves)
