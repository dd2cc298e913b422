"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``: the kernels have no CPU mode, so these tests skip without a
CUDA device. On a machine with a card and without JAX (tests/conftest.py
imports it), run them with

  python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py

Tolerances, relative to max|plain|: float32 1e-4 for K1 and K4 and 1e-5 for
K2 (float32 sums in another order); bfloat16 2e-2 for K1 and K2 (the plain
version rounds intermediate results to bf16, 2^-8 relative each, where a
kernel rounds once) and 1e-4 for K4 (both sides compute in float32 from the
same inputs). The reasons are spelled out in each kernel's source header.
"""

import pytest
import torch

from sr3_tpu_torch.ops import attention, conv_fused, groupnorm

pytestmark = pytest.mark.gpu
CL = torch.channels_last
TOL = {torch.float32: {"k1": 1e-4, "k2": 1e-5, "k4": 1e-4},
       torch.bfloat16: {"k1": 2e-2, "k2": 2e-2, "k4": 1e-4}}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def rel(out, ref):
    torch.cuda.synchronize()
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,cin,cout,h,w,film", [
    (2, 64, 64, 32, 32, True),
    (1, 192, 64, 16, 16, False),
    (2, 64, 3, 32, 32, False),      # final_conv tail
    (2, 48, 40, 12, 20, True),      # ragged C_out and tiles
    (1, 1024, 512, 8, 8, True),
])
def test_k1_matches_plain(gen, dtype, b, cin, cout, h, w, film):
    args, kw = _k1_inputs(gen, dtype, b, cin, cout, h, w, film)
    n = conv_fused.counter.n
    out = conv_fused.gn_silu_conv3x3(*args, **kw)
    assert conv_fused.counter.n == n + 1
    assert out.is_contiguous(memory_format=CL) and out.dtype == dtype
    ref = conv_fused.gn_silu_conv3x3_plain(*args, **kw)
    assert rel(out, ref) <= TOL[dtype]["k1"]


def test_k1_ragged_cin(gen):
    """C_in not a multiple of 16: the float32 kernel masks it; the bfloat16
    kernel stages 16-channel chunks with 16-byte loads and refuses it."""
    args, kw = _k1_inputs(gen, torch.float32, 2, 40, 24, 8, 8, True)
    out = conv_fused.gn_silu_conv3x3(*args, **kw)
    ref = conv_fused.gn_silu_conv3x3_plain(*args, **kw)
    assert rel(out, ref) <= TOL[torch.float32]["k1"]
    args, kw = _k1_inputs(gen, torch.bfloat16, 2, 40, 24, 8, 8, True)
    n = conv_fused.counter.n
    with pytest.raises(ValueError, match="multiple of 16"):
        conv_fused.gn_silu_conv3x3(*args, **kw)
    assert conv_fused.counter.n == n


def _k1_inputs(gen, dtype, b, cin, cout, h, w, film):
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    x = r(b, cin, h, w).to(dtype).contiguous(memory_format=CL)
    wt = (r(cout, cin, 3, 3) / (3 * cin ** 0.5)).to(dtype)
    wt = wt.contiguous(memory_format=CL)
    args = (x, 1 + 0.2 * r(cin), 0.1 * r(cin), wt, 0.1 * r(cout), 8)
    kw = {}
    if film:
        kw = dict(pre_scale=1 + 0.3 * r(b, cin), pre_bias=0.5 * r(b, cin),
                  residual=r(b, cout, h, w).to(dtype).contiguous(
                      memory_format=CL))
    return args, kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,hw,groups,swish", [
    (2, 512, 16, 32, False), (1, 512, 8, 32, False), (2, 96, 12, 8, True),
])
def test_k2_matches_plain(gen, dtype, b, c, hw, groups, swish):
    x = 3 * torch.randn(b, c, hw, hw, device="cuda", generator=gen) + 1
    x = x.to(dtype).contiguous(memory_format=CL)
    s = 1 + 0.2 * torch.randn(c, device="cuda", generator=gen)
    t = 0.1 * torch.randn(c, device="cuda", generator=gen)
    n = groupnorm.counter.n
    out = groupnorm.group_norm(x, s, t, groups, swish=swish)
    assert groupnorm.counter.n == n + 1
    ref = groupnorm.group_norm_plain(x, s, t, groups, swish=swish)
    assert rel(out, ref) <= TOL[dtype]["k2"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,seq,d", [(2, 256, 512), (2, 64, 512),
                                      (3, 100, 64)])
def test_k4_matches_plain(gen, dtype, bh, seq, d):
    q, k, v = (torch.randn(bh, seq, d, device="cuda", generator=gen)
               .to(dtype) for _ in range(3))
    n = attention.counter.n
    out = attention.attention(q, k, v, d ** -0.5)
    assert attention.counter.n == n + 1 and out.dtype == torch.float32
    ref = attention.attention_plain(q, k, v, d ** -0.5)
    assert rel(out, ref) <= TOL[dtype]["k4"]


def test_cuda_wrappers_raise_on_other_layouts(gen):
    x = torch.ones(1, 16, 8, 8, device="cuda")
    with pytest.raises(ValueError, match="channels_last"):
        groupnorm.group_norm(x, torch.ones(16, device="cuda"),
                             torch.zeros(16, device="cuda"), 8)
    xc = x.contiguous(memory_format=CL)
    w = torch.ones(16, 16, 3, 3, device="cuda")  # OIHW-contiguous
    with pytest.raises(ValueError, match="channels_last"):
        conv_fused.gn_silu_conv3x3(xc, torch.ones(16, device="cuda"),
                                   torch.zeros(16, device="cuda"), w, None, 8)
    q = torch.ones(1, 16, 600, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        attention.attention(q, q, q, 1.0)
