"""The bfloat16 tensor-core routes of K4, K5 and K6 on the CPU, and the
kernels' C signatures.

The card's bf16 kernels round P (K4), dO, P and dS (K5) and dO, dS (K6) to
bf16 before their products, where the plain versions, the JAX package's XLA
spec and its TPU kernels keep them in float32. The CUDA kernels cannot run
here, so ``_k4_rounding``, ``_k5_rounding`` and ``_k6_rounding`` below
write that rounding out in PyTorch (test helpers, not a knob of the
package), and the tests hold them against ``attention_xla`` and ``jax.vjp``
of it on the same bf16 inputs (numpy seed) at head_dim 512: within 2e-2 of
max|ref|, the bound the card checks use for K4's o, K5's dk, dv and K6's
dq. The exact plain versions, and K4's logsumexp, stay within 1e-4.

The last tests guard the ctypes boundary: every ``extern "C"`` entry of
``csrc/*.cu`` against the ctypes signatures in ``_build._SIGNATURES`` (a
changed C signature cannot reach ctypes mismatched), the order in which
the library counts K1's bfloat16 tiles against ``conv_fused.BF16_TILES``,
and the backward launcher's refusal of a dO in another dtype than q.
"""

import ctypes
import glob
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.scipy.special import logsumexp

from sr3_tpu.ops.attention import attention_xla
from sr3_tpu_torch.ops import _build, attention, conv_fused

TOL_BF16 = 2e-2   # K4's o, K5's dk / dv, K6's dq on the bf16 route
TOL_EXACT = 1e-4  # the plain versions; K4's logsumexp on both routes
D = 512


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _rel(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _inputs(seed, bh, seq):
    """bf16-valued q, k, v (as float32 torch tensors) and a float32 output
    gradient, from a numpy seed."""
    rng = np.random.default_rng(seed)
    q, k, v = (_bf16(torch.from_numpy(
        rng.standard_normal((bh, seq, D)).astype(np.float32)))
        for _ in range(3))
    g = torch.from_numpy(rng.standard_normal((bh, seq, D)).astype(np.float32))
    return q, k, v, g


def _k4_rounding(q, k, v, scale):
    """(o, lse) as K4's bf16 route computes them: float32 scores and
    softmax statistics, P rounded to bf16 before P V, l the sum of the
    unrounded P."""
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bqk,bkd->bqd", _bf16(p), v) / p.sum(-1, keepdim=True)
    return o, torch.logsumexp(s, dim=-1)


def _k5_rounding(q, k, v, g, lse, dsum, scale):
    """(dk, dv) as K5's bf16 route computes them: dO rounded to bf16 once,
    P and dS in float32, rounded to bf16 before dV += P^T dO and
    dK += dS^T Q."""
    g16 = _bf16(g)
    p = torch.exp(torch.einsum("bqd,bkd->bqk", q, k) * scale - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", g16, v)
    ds = p * (dp - dsum[..., None]) * scale
    dv = torch.einsum("bqk,bqd->bkd", _bf16(p), g16)
    dk = torch.einsum("bqk,bqd->bkd", _bf16(ds), q)
    return dk, dv


def _k6_rounding(q, k, v, g, lse, dsum, scale):
    """dq as K6's bf16 route computes it: dO rounded to bf16 once, P and dS
    in float32 (the scale applied after the products), dS rounded to bf16
    before dQ += dS K."""
    g16 = _bf16(g)
    p = torch.exp(torch.einsum("bqd,bkd->bqk", q, k) * scale - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", g16, v)
    ds = p * (dp - dsum[..., None]) * scale
    return torch.einsum("bqk,bkd->bqd", _bf16(ds), k)


@pytest.mark.parametrize("seq", [256, 1024])
def test_k4_bf16_rounding_within_the_card_tolerance(seq):
    q, k, v, _ = _inputs(20 + seq, 2, seq)
    scale = D ** -0.5
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    ref = attention_xla(jq, jk, jv, scale)
    ref_lse = logsumexp(jnp.einsum("bqd,bkd->bqk", jq, jk) * scale, axis=-1)
    o, lse = _k4_rounding(q, k, v, scale)
    assert _rel(o, ref) <= TOL_BF16
    assert _rel(lse, ref_lse) <= TOL_EXACT
    plain_o, plain_lse = attention.attention_fwd_plain(q, k, v, scale)
    assert _rel(plain_o, ref) <= TOL_EXACT
    assert _rel(plain_lse, ref_lse) <= TOL_EXACT


@pytest.mark.parametrize("seq", [256, 1024])
def test_k5_bf16_rounding_within_the_card_tolerance(seq):
    q, k, v, g = _inputs(30 + seq, 2, seq)
    scale = D ** -0.5
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    _, vjp = jax.vjp(lambda a, b, c: attention_xla(a, b, c, scale), jq, jk, jv)
    ref_dq, ref_dk, ref_dv = vjp(jnp.asarray(g.numpy()))
    # lse and dsum as the card's backward gets them: the bf16 forward's
    o, lse = _k4_rounding(q, k, v, scale)
    dk, dv = _k5_rounding(q, k, v, g, lse, (g * o).sum(-1), scale)
    assert _rel(dk, ref_dk) <= TOL_BF16
    assert _rel(dv, ref_dv) <= TOL_BF16
    o, lse = attention.attention_fwd_plain(q, k, v, scale)
    grads = attention.attention_bwd_plain(q, k, v, g, lse, (g * o).sum(-1),
                                          scale)
    for ours, ref in zip(grads, (ref_dq, ref_dk, ref_dv)):
        assert _rel(ours, ref) <= TOL_EXACT


@pytest.mark.parametrize("seq", [256, 64, 100])
def test_k6_bf16_rounding_within_the_card_tolerance(seq):
    """The 16->128 path's 256 and 64 tokens, and a length that fills no
    32-query or 32-key tile."""
    q, k, v, g = _inputs(40 + seq, 2, seq)
    scale = D ** -0.5
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    _, vjp = jax.vjp(lambda a, b, c: attention_xla(a, b, c, scale), jq, jk, jv)
    ref_dq = vjp(jnp.asarray(g.numpy()))[0]
    # lse and dsum as the card's backward gets them: the bf16 forward's
    o, lse = _k4_rounding(q, k, v, scale)
    dq = _k6_rounding(q, k, v, g, lse, (g * o).sum(-1), scale)
    assert _rel(dq, ref_dq) <= TOL_BF16
    o, lse = attention.attention_fwd_plain(q, k, v, scale)
    plain_dq = attention.attention_bwd_plain(q, k, v, g, lse, (g * o).sum(-1),
                                             scale)[0]
    assert _rel(plain_dq, ref_dq) <= TOL_EXACT


_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
            "long long": ctypes.c_longlong}


def _ctype(decl):
    """The ctypes type of one C declaration ("const float* g", "int B")."""
    if "*" in decl:
        return ctypes.c_void_p
    words = decl.replace("const ", "").split()
    return _C_TYPES[" ".join(words[:-1])]


def test_extern_c_signatures_match_ctypes():
    found = {}
    for path in sorted(glob.glob(os.path.join(_build.CSRC_DIR, "*.cu"))):
        with open(path) as f:
            src = f.read()
        for ret, name, args in re.findall(
                r'extern "C"\s+(.+?)\s+(sr3_\w+)\s*\(([^)]*)\)', src):
            assert name not in found, f"{name} defined twice"
            found[name] = ([_ctype(a) for a in args.split(",")],
                           _ctype(ret + " result"))
    assert set(found) == set(_build._SIGNATURES)
    for name, (argtypes, restype) in _build._SIGNATURES.items():
        assert len(found[name][0]) == len(argtypes), name
        assert found[name] == (list(argtypes), restype), name



def test_k1_tile_order_matches_the_library():
    with open(os.path.join(_build.CSRC_DIR, "conv_fused.cu")) as f:
        src = f.read()
    launches = re.findall(r"launch_wgmma<(\d+), (\d+), (\d+)>\(a, (\d+), st\)",
                          src)
    by_index = {int(i): f"<{tw},{ni},{bn}>" for tw, ni, bn, i in launches}
    assert len(by_index) == len(launches)
    assert [by_index[i] for i in range(len(by_index))] == list(
        conv_fused.BF16_TILES)
    assert f"g_tile_launches[{len(conv_fused.BF16_TILES)}]" in src
    assert f"return {len(conv_fused.BF16_TILES)};" in src


def test_bwd_launcher_refuses_g_in_another_dtype():
    q, k, v = (torch.zeros(1, 16, 64, dtype=torch.bfloat16) for _ in range(3))
    g = torch.zeros(1, 16, 64)
    stats = torch.zeros(1, 16)
    launched = attention.dq_counter.n
    with pytest.raises(ValueError, match="g dtype"):
        attention._bwd_kernel("sr3_flash_attention_bwd_dq",
                              attention.dq_counter, q, k, v, g, stats, stats,
                              (torch.zeros(1, 16, 64),), 0.125)
    assert attention.dq_counter.n == launched
