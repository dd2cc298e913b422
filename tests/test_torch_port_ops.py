"""The port's kernel ops on the CPU: each plain PyTorch version (K1, K2, K4
with its logsumexp, the K5/K6 backward) against the JAX package's XLA spec
and its Pallas kernels in interpret mode, on the same numpy inputs; the
gradients of the three autograd Functions against ``jax.vjp`` of the JAX
dispatchers with the Pallas kernels (interpret mode); the wrappers' CPU
dispatch and layout checks; the kernel build without nvcc.

Tolerance: float32, atol 2e-5 -- the same math in float32 on both sides,
only the order of the sums differs (values are O(1)).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sr3_tpu.ops.attention import (attention_flash, attention_flash_bwd,
                                   attention_flash_fwd, attention_xla,
                                   self_attention)
from sr3_tpu.ops.conv_fused import gn_silu_conv3x3 as jax_fused
from sr3_tpu.ops.conv_fused import gn_silu_conv3x3_xla
from sr3_tpu.ops.groupnorm import (group_norm_swish, group_norm_swish_pallas,
                                   group_norm_swish_xla)
from sr3_tpu_torch.ops import _build, attention, conv_fused, groupnorm

ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def nchw(x):
    """NHWC numpy -> logical NCHW torch view in channels_last memory."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _k1_inputs(seed, b=2, hw=16, cin=16, cout=16, affine=False,
               residual=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(
        x=f(b, hw, hw, cin),
        gs=1.0 + 0.2 * f(cin), gb=0.1 * f(cin),
        k=0.1 * f(3, 3, cin, cout), cb=0.1 * f(cout),
        ps=(1.0 + 0.3 * f(b, cin)) if affine else None,
        pb=(0.5 * f(b, cin)) if affine else None,
        res=f(b, hw, hw, cout) if residual else None,
    )


def _k1_port(a):
    w = torch.from_numpy(a["k"]).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    t = lambda v: None if v is None else torch.from_numpy(v)
    out = conv_fused.gn_silu_conv3x3(
        nchw(a["x"]), t(a["gs"]), t(a["gb"]), w, t(a["cb"]), 8,
        pre_scale=t(a["ps"]), pre_bias=t(a["pb"]),
        residual=None if a["res"] is None else nchw(a["res"]))
    assert out.is_contiguous(memory_format=torch.channels_last)
    return nhwc(out)


K1_CASES = [
    # (cin, cout, pre-affine, residual)
    (16, 16, False, False),
    (16, 16, True, True),
    (24, 16, True, False),
    (16, 32, False, True),
    (16, 3, False, False),  # final_conv: Cout = 3
]


@pytest.mark.parametrize("cin,cout,affine,residual", K1_CASES)
def test_k1_plain_matches_xla_spec(cin, cout, affine, residual):
    a = _k1_inputs(1, cin=cin, cout=cout, affine=affine, residual=residual)
    j = lambda v: None if v is None else jnp.asarray(v)
    ref = gn_silu_conv3x3_xla(
        j(a["x"]), j(a["gs"]), j(a["gb"]), j(a["k"]), j(a["cb"]), 8,
        pre_scale=j(a["ps"]), pre_bias=j(a["pb"]))
    ref = np.asarray(ref) + (0 if a["res"] is None else a["res"])
    np.testing.assert_allclose(_k1_port(a), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("cin,cout,affine,residual", K1_CASES)
def test_k1_plain_matches_pallas_interpret(cin, cout, affine, residual):
    a = _k1_inputs(2, cin=cin, cout=cout, affine=affine, residual=residual)
    j = lambda v: None if v is None else jnp.asarray(v)
    ref = jax_fused(
        j(a["x"]), j(a["gs"]), j(a["gb"]), j(a["k"]), j(a["cb"]), 8,
        pre_scale=j(a["ps"]), pre_bias=j(a["pb"]), residual=j(a["res"]),
        use_pallas=True, interpret=True)
    np.testing.assert_allclose(_k1_port(a), np.asarray(ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("groups,c,hw,swish", [
    (8, 64, 8, False), (8, 64, 16, True), (4, 32, 8, True),
])
def test_k2_plain_matches_spec_and_pallas(groups, c, hw, swish):
    rng = np.random.default_rng(3)
    x = (2.0 * rng.standard_normal((2, hw, hw, c)) + 0.5).astype(np.float32)
    s = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    out = groupnorm.group_norm(nchw(x), torch.from_numpy(s),
                               torch.from_numpy(b), groups, swish=swish)
    assert out.is_contiguous(memory_format=torch.channels_last)
    ref = group_norm_swish_xla(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                               groups, swish=swish)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=ATOL, rtol=0)
    pal = group_norm_swish_pallas(jnp.asarray(x), jnp.asarray(s),
                                  jnp.asarray(b), groups, swish=swish,
                                  interpret=True)
    np.testing.assert_allclose(nhwc(out), np.asarray(pal), atol=ATOL, rtol=0)


@pytest.mark.parametrize("seq,d", [(64, 32), (256, 32), (64, 512)])
def test_k4_plain_matches_spec_and_flash_interpret(seq, d):
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, seq, d)).astype(np.float32)
               for _ in range(3))
    scale = 1.0 / np.sqrt(d)
    out = attention.attention(*(torch.from_numpy(t) for t in (q, k, v)), scale)
    assert out.dtype == torch.float32
    ref = attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    fl = attention_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                         interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(fl), atol=ATOL, rtol=0)


def _qkv(seed, bh, seq, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bh, seq, d)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("seq,d", [(64, 32), (256, 16)])
def test_k4_lse_plain_matches_flash_fwd_interpret(seq, d):
    q, k, v, _ = _qkv(6, 2, seq, d)
    scale = 1.0 / np.sqrt(d)
    o, lse = attention.attention_fwd(*(torch.from_numpy(t) for t in (q, k, v)),
                                     scale)
    assert o.dtype == lse.dtype == torch.float32 and lse.shape == (2, seq)
    ref_o, ref_lse = attention_flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), scale, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0],
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("seq,d", [(64, 32), (256, 16)])
def test_k5_k6_plain_matches_flash_bwd_interpret_and_vjp(seq, d):
    q, k, v, g = _qkv(7, 2, seq, d)
    scale = 1.0 / np.sqrt(d)
    tq, tk, tv, tg = (torch.from_numpy(t) for t in (q, k, v, g))
    o, lse = attention.attention_fwd_plain(tq, tk, tv, scale)
    dsum = (tg * o).sum(-1)
    grads = attention.attention_bwd(tq, tk, tv, tg, lse, dsum, scale)
    jq, jk, jv, jg = (jnp.asarray(t) for t in (q, k, v, g))
    pal = attention_flash_bwd(jq, jk, jv, jg, jnp.asarray(lse.numpy())[..., None],
                              jnp.asarray(dsum.numpy())[..., None], scale,
                              interpret=True)
    _, vjp = jax.vjp(lambda a, b, c: attention_xla(a, b, c, scale), jq, jk, jv)
    for ours, p, x in zip(grads, pal, vjp(jg)):
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), np.asarray(p), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(ours.numpy(), np.asarray(x), atol=ATOL,
                                   rtol=0)


def _port_grads(out, inputs, g):
    """Gradients of ``out`` against each tensor of ``inputs`` (None kept)."""
    wrt = [t for t in inputs if t is not None]
    grads = iter(torch.autograd.grad(out, wrt, g))
    return [None if t is None else next(grads) for t in inputs]


@pytest.mark.parametrize("affine,residual", [(False, False), (True, True)])
def test_k1_function_grads_match_jax_vjp(affine, residual):
    """Every input gradient of the K1 autograd Function against jax.vjp of
    the dispatcher with the Pallas kernel (``_fused_fwd_bwd``)."""
    a = _k1_inputs(8, hw=8, cin=16, cout=16, affine=affine, residual=residual)
    rng = np.random.default_rng(9)
    g = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    t = lambda v: None if v is None else torch.from_numpy(v).requires_grad_()
    x = nchw(a["x"]).requires_grad_()
    w = torch.from_numpy(a["k"]).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    res = None if a["res"] is None else nchw(a["res"]).requires_grad_()
    inputs = [x, t(a["gs"]), t(a["gb"]), w, t(a["cb"]), t(a["ps"]),
              t(a["pb"]), res]
    out = conv_fused.gn_silu_conv3x3(*inputs[:5], 8, pre_scale=inputs[5],
                                     pre_bias=inputs[6], residual=res)
    assert out.grad_fn is not None
    ours = _port_grads(out, inputs, nchw(g))

    names = ["x", "gs", "gb", "k", "cb", "ps", "pb", "res"]
    present = [n for n in names if a[n] is not None]

    def f(*vals):
        kw = dict(zip(present, vals))
        return jax_fused(kw["x"], kw["gs"], kw["gb"], kw["k"], kw["cb"], 8,
                         pre_scale=kw.get("ps"), pre_bias=kw.get("pb"),
                         residual=kw.get("res"), use_pallas=True,
                         interpret=True)

    _, vjp = jax.vjp(f, *(jnp.asarray(a[n]) for n in present))
    ref = dict(zip(present, vjp(jnp.asarray(g))))
    layout = {"x": nhwc, "res": nhwc,
              "k": lambda t: t.permute(2, 3, 1, 0).numpy()}
    for n, grad in zip(names, ours):
        if a[n] is None:
            continue
        got = layout.get(n, lambda t: t.numpy())(grad)
        np.testing.assert_allclose(got, np.asarray(ref[n]), atol=ATOL, rtol=0,
                                   err_msg=n)


@pytest.mark.parametrize("swish", [True, False])
def test_k2_function_grads_match_jax_vjp(swish):
    """The K2 Function's hand backward against jax.vjp of the dispatcher
    with the Pallas kernel (``_gn_swish_fwd_bwd``)."""
    rng = np.random.default_rng(10)
    x = (2.0 * rng.standard_normal((2, 8, 8, 32)) + 0.5).astype(np.float32)
    s = (1.0 + 0.2 * rng.standard_normal(32)).astype(np.float32)
    b = (0.1 * rng.standard_normal(32)).astype(np.float32)
    g = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    inputs = [nchw(x).requires_grad_(), torch.from_numpy(s).requires_grad_(),
              torch.from_numpy(b).requires_grad_()]
    out = groupnorm.group_norm(*inputs, 8, swish=swish)
    assert out.grad_fn is not None
    dx, ds, db = _port_grads(out, inputs, nchw(g))
    _, vjp = jax.vjp(
        lambda a, c, e: group_norm_swish(a, c, e, 8, swish=swish,
                                         use_pallas=True, interpret=True),
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    rdx, rds, rdb = vjp(jnp.asarray(g))
    assert dx.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(nhwc(dx), np.asarray(rdx), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ds.numpy(), np.asarray(rds), atol=ATOL, rtol=0)
    np.testing.assert_allclose(db.numpy(), np.asarray(rdb), atol=ATOL, rtol=0)


@pytest.mark.parametrize("seq,d", [(64, 32), (256, 16)])
def test_k4_function_grads_match_jax_vjp(seq, d):
    """The attention Function (lse forward, K5/K6 backward) against jax.vjp
    of ``self_attention`` on its flash path (``_flash_with_vjp``)."""
    q, k, v, g = _qkv(11, 2, seq, d)
    scale = 1.0 / np.sqrt(d)
    inputs = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = attention.attention(*inputs, scale)
    assert out.grad_fn is not None
    ours = _port_grads(out, inputs, torch.from_numpy(g))
    _, vjp = jax.vjp(
        lambda a, b, c: self_attention(a, b, c, scale, use_flash=True,
                                       interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for got, ref in zip(ours, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=0)


def test_cpu_tensors_never_count_a_launch():
    counters = (conv_fused.counter, groupnorm.counter, attention.counter,
                attention.dkv_counter, attention.dq_counter)
    for c in counters:
        c.n = 0
    a = _k1_inputs(5, affine=True, residual=True)
    _k1_port(a)
    x = nchw(np.ones((1, 4, 4, 16), np.float32))
    groupnorm.group_norm(x, torch.ones(16), torch.zeros(16), 8)
    q = torch.ones(1, 16, 16, requires_grad=True)
    attention.attention(q, q, q, 0.25).sum().backward()
    assert [c.n for c in counters] == [0] * 5


def test_wrappers_reject_other_layouts():
    x = torch.ones(1, 16, 4, 4)  # NCHW-contiguous, not channels_last
    with pytest.raises(ValueError, match="channels_last"):
        groupnorm.group_norm(x, torch.ones(16), torch.zeros(16), 8)
    w = torch.ones(16, 16, 3, 3)
    with pytest.raises(ValueError, match="channels_last"):
        conv_fused.gn_silu_conv3x3(x, torch.ones(16), torch.zeros(16), w,
                                   None, 8)
    q = torch.ones(1, 16, 32).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        attention.attention(q, q, q, 1.0)


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    assert _build.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()

