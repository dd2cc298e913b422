"""The port's kernel ops on the CPU: each plain PyTorch version (K1, K2, K4)
against the JAX package's XLA spec and its Pallas kernel in interpret mode,
on the same numpy inputs; the wrappers' CPU dispatch and layout checks; the
kernel build without nvcc.

Tolerance: float32, atol 2e-5 -- the same math in float32 on both sides,
only the order of the sums differs (values are O(1)).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sr3_tpu.ops.attention import attention_flash, attention_xla
from sr3_tpu.ops.conv_fused import gn_silu_conv3x3 as jax_fused
from sr3_tpu.ops.conv_fused import gn_silu_conv3x3_xla
from sr3_tpu.ops.groupnorm import group_norm_swish_pallas, group_norm_swish_xla
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


def test_cpu_tensors_never_count_a_launch():
    for c in (conv_fused.counter, groupnorm.counter, attention.counter):
        c.n = 0
    a = _k1_inputs(5, affine=True, residual=True)
    _k1_port(a)
    x = nchw(np.ones((1, 4, 4, 16), np.float32))
    groupnorm.group_norm(x, torch.ones(16), torch.zeros(16), 8)
    q = torch.ones(1, 16, 16)
    attention.attention(q, q, q, 0.25)
    assert [c.n for c in (conv_fused.counter, groupnorm.counter,
                          attention.counter)] == [0, 0, 0]


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

