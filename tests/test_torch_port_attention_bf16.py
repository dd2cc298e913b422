"""The bfloat16 tensor-core routes of K4, K5 and K6 on the CPU, their
launch plans, and the kernels' C signatures.

The card's bf16 kernels round P (K4), dO, P and dS (K5) and dO, dS (K6) to
bf16 before their products, where the plain versions, the JAX package's XLA
spec and its TPU kernels keep them in float32. The CUDA kernels cannot run
here, so ``_k4_rounding``, ``_k5_rounding`` and ``_k6_rounding`` below
write that arithmetic out in PyTorch (test helpers, not a knob of the
package), and the tests hold them against ``attention_xla`` and ``jax.vjp``
of it on the same bf16 inputs (numpy seed): within 2e-2 of max|ref|, the
bound the card checks use for K4's o, K5's dk, dv and K6's dq. The exact
plain versions, and K4's logsumexp, stay within 1e-4. ``_k4_rounding``
follows K4's wgmma kernel (``csrc/attention.cu``): per key tile of its
head_dim class the online softmax with its running max in the base-2
exponent, P rounded to bf16 at that tile's max, l the sum of the unrounded
P; and, where the launch plan splits the keys, each split's unnormalised
O, m and l merged in split order. ``_k5_rounding`` and ``_k6_rounding``
follow K5's and K6's wgmma kernels (``csrc/attention_bwd.cu``): per
streamed tile of their plan (K5: queries, K6: keys) X and Y, added from
the two warpgroups' halves of D where the class splits D, P in the base-2
exponent and dS in float32, P and dS rounded to bf16 before their
products, and each split's partial sums added in split order.

The launch plans are mirrored in ``tests/torch_port_attention_plan.py``;
the tests here check that their blocks cover every (query, key) pair once,
that every head_dim the wrapper takes maps to a class the C source
instantiates, and that the merges' order is fixed.

The last tests guard the ctypes boundary: every ``extern "C"`` entry of
``csrc/*.cu`` against the ctypes signatures in ``_build._SIGNATURES`` (a
changed C signature cannot reach ctypes mismatched), the order in which
the library counts K1's bfloat16 tiles against ``conv_fused.BF16_TILES``,
K4's classes against ``attention.BF16_TILES`` and K5's / K6's against
``attention.BWD_TILES``, and the backward launcher's refusal of a dO in
another dtype than q.
"""

import ctypes
import glob
import math
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
import torch_port_attention_plan as plan_mirror

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


def _inputs(seed, bh, seq, d=D):
    """bf16-valued q, k, v (as float32 torch tensors) and a float32 output
    gradient, from a numpy seed."""
    rng = np.random.default_rng(seed)
    q, k, v = (_bf16(torch.from_numpy(
        rng.standard_normal((bh, seq, d)).astype(np.float32)))
        for _ in range(3))
    g = torch.from_numpy(rng.standard_normal((bh, seq, d)).astype(np.float32))
    return q, k, v, g


def _k4_partials(q, k, v, scale):
    """Each key split's (unnormalised O, m, l) as K4's wgmma kernel leaves
    them, in split order: per key tile of the plan the scores in float32,
    scaled into the base-2 exponent, the running max m, P = 2^(s - m)
    rounded to bf16 before P V, l the sum of the unrounded P."""
    bh, seq, d = q.shape
    p = plan_mirror.fwd_plan(bh, seq, d)
    c = scale * math.log2(math.e)
    parts = []
    for z in range(p["splits"]):
        m = torch.full((bh, seq), -math.inf)
        l = torch.zeros(bh, seq)
        acc = torch.zeros(bh, seq, d)
        for t in range(z * p["per"], min(p["key_tiles"], (z + 1) * p["per"])):
            k0, k1 = t * p["bk"], min(seq, (t + 1) * p["bk"])
            s = torch.einsum("bqd,bkd->bqk", q, k[:, k0:k1]) * c
            mx = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - mx)
            pr = torch.exp2(s - mx[..., None])
            l = l * alpha + pr.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqk,bkd->bqd", _bf16(pr), v[:, k0:k1])
            m = mx
        parts.append((acc, m, l))
    return parts


def _k4_merge(parts):
    """(o, lse) from the splits' (O, m, l), folded in split order as
    flash_merge_kernel does (one split: O / l)."""
    if len(parts) == 1:
        acc, m, l = parts[0]
        return acc / l[..., None], m * math.log(2) + torch.log(l)
    mx = parts[0][1]
    for _, m, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    total = torch.zeros_like(mx)
    for _, m, l in parts:
        total = total + l * torch.exp2(m - mx)
    o = torch.zeros_like(parts[0][0])
    for acc, m, _ in parts:
        o = o + acc * (torch.exp2(m - mx) / total)[..., None]
    return o, mx * math.log(2) + torch.log(total)


def _k4_rounding(q, k, v, scale):
    """(o, lse) as K4's bf16 route computes them: _k4_partials merged."""
    return _k4_merge(_k4_partials(q, k, v, scale))


def _bwd_product(a, b, split_d, dc):
    """a b^T (bh, n, m) in float32 as the backward kernels form X and Y:
    over all of D, or (split_d) as the sum of the two warpgroups' partials
    over the halves of the class's DC columns (the columns past D are 0)."""
    if not split_d:
        return torch.einsum("bnd,bmd->bnm", a, b)
    h = dc // 2
    return (torch.einsum("bnd,bmd->bnm", a[..., :h], b[..., :h])
            + torch.einsum("bnd,bmd->bnm", a[..., h:], b[..., h:]))


def _bwd_partials(q, k, v, g, lse, dsum, scale, kernel):
    """Each split's float32 partial sums as K5's (kernel 0: (dk, dv)) or
    K6's (kernel 1: (dq,)) wgmma kernel leaves them, in split order: per
    streamed tile of the plan (K5: queries, K6: keys) X and Y (split-d
    partials added where the class splits D), P = 2^(X * scale * log2(e) -
    lse * log2(e)), dS = P (Y - dsum) * scale in float32, P and dS rounded
    to bf16 before dV += P^T dO, dK += dS^T Q, dQ += dS K, summed in tile
    order; dO rounded to bf16 once, as the wrapper does."""
    bh, seq, d = q.shape
    p = plan_mirror.bwd_plan(bh, seq, d, kernel)
    dc = plan_mirror.BWD_CLASS_DC[p["cls"]]
    split_d = p["rows"] == 64
    g16 = _bf16(g)
    c = scale * math.log2(math.e)
    l2 = lse * math.log2(math.e)
    parts = []
    for z in range(p["splits"]):
        acc = [torch.zeros(bh, seq, d) for _ in range(2 - kernel)]
        for t in range(z * p["per"], min(p["col_tiles"], (z + 1) * p["per"])):
            c0, c1 = t * p["bn"], min(seq, (t + 1) * p["bn"])
            if kernel == 0:  # rows: keys, columns: this tile's queries
                x = _bwd_product(k, q[:, c0:c1], split_d, dc)
                y = _bwd_product(v, g16[:, c0:c1], split_d, dc)
                pr = torch.exp2(x * c - l2[:, None, c0:c1])
                ds = pr * (y - dsum[:, None, c0:c1]) * scale
                acc[0] = acc[0] + torch.einsum("bkq,bqd->bkd", _bf16(ds),
                                               q[:, c0:c1])
                acc[1] = acc[1] + torch.einsum("bkq,bqd->bkd", _bf16(pr),
                                               g16[:, c0:c1])
            else:  # rows: queries, columns: this tile's keys
                x = _bwd_product(q, k[:, c0:c1], split_d, dc)
                y = _bwd_product(g16, v[:, c0:c1], split_d, dc)
                pr = torch.exp2(x * c - l2[..., None])
                ds = pr * (y - dsum[..., None]) * scale
                acc[0] = acc[0] + torch.einsum("bqk,bkd->bqd", _bf16(ds),
                                               k[:, c0:c1])
        parts.append(acc)
    return parts


def _bwd_merge(parts):
    """Each output the sum of the splits' partials in split order, as
    flash_bwd_merge_kernel adds them (one split: its sums)."""
    out = list(parts[0])
    for part in parts[1:]:
        out = [a + b for a, b in zip(out, part)]
    return out


def _k5_rounding(q, k, v, g, lse, dsum, scale):
    """(dk, dv) as K5's bf16 route computes them: _bwd_partials merged."""
    return tuple(_bwd_merge(_bwd_partials(q, k, v, g, lse, dsum, scale, 0)))


def _k6_rounding(q, k, v, g, lse, dsum, scale):
    """dq as K6's bf16 route computes it: _bwd_partials merged."""
    return _bwd_merge(_bwd_partials(q, k, v, g, lse, dsum, scale, 1))[0]


def _bwd_refs(q, k, v, g, scale):
    """jax.vjp of attention_xla at the same inputs: (dq, dk, dv)."""
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    _, vjp = jax.vjp(lambda a, b, c: attention_xla(a, b, c, scale), jq, jk, jv)
    return vjp(jnp.asarray(g.numpy()))


@pytest.mark.parametrize("bh,seq,d", [
    pytest.param(2, 256, 512, id="256"),    # 4 tiles, no split
    pytest.param(2, 1024, 512, id="1024"),  # 4 key splits of 4 tiles
    pytest.param(8, 1024, 512, id="8-1024-512"),  # no split, 16 tiles
    pytest.param(2, 100, 512, id="2-100-512"),    # ragged, 2 tiles
    pytest.param(8, 256, 128, id="8-256-128"),    # 2 tiles of 128 keys
    pytest.param(2, 100, 128, id="2-100-128"),    # ragged, one tile
    pytest.param(8, 16, 256, id="8-16-256"),      # under one tile
    pytest.param(2, 300, 256, id="2-300-256"),    # ragged, 5 tiles
    pytest.param(2, 300, 192, id="2-300-192"),    # d under its class
    pytest.param(2, 1000, 512, id="2-1000-512"),  # ragged, 4 splits
    pytest.param(1, 2048, 256, id="1-2048-256"),  # 8 splits of 4 tiles
])
def test_k4_bf16_rounding_within_the_card_tolerance(bh, seq, d):
    q, k, v, _ = _inputs(20 + seq + d, bh, seq, d)
    scale = d ** -0.5
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    ref = attention_xla(jq, jk, jv, scale)
    ref_lse = logsumexp(jnp.einsum("bqd,bkd->bqk", jq, jk) * scale, axis=-1)
    o, lse = _k4_rounding(q, k, v, scale)
    assert _rel(o, ref) <= TOL_BF16
    assert _rel(lse, ref_lse) <= TOL_EXACT
    plain_o, plain_lse = attention.attention_fwd_plain(q, k, v, scale)
    assert _rel(plain_o, ref) <= TOL_EXACT
    assert _rel(plain_lse, ref_lse) <= TOL_EXACT


# (bh, seq, head_dim) of K5 / K6: every class, ragged lengths, head_dims
# under their class's width and splits of the streamed tiles
BWD_CASES = [
    pytest.param(2, 256, 512, id="256"),     # K5 and K6 split in 2
    pytest.param(2, 1024, 512, id="1024"),   # split in 4
    pytest.param(2, 64, 512, id="64"),       # one tile pair
    pytest.param(2, 100, 512, id="100"),     # ragged: no 32-row tile full
    pytest.param(8, 256, 128, id="8-256-128"),
    pytest.param(2, 100, 128, id="2-100-128"),   # ragged, one tile
    pytest.param(4, 700, 128, id="4-700-128"),   # ragged, K5 split in 2
    pytest.param(2, 300, 192, id="2-300-192"),   # d under its class
    pytest.param(2, 300, 256, id="2-300-256"),   # ragged, split-d K5
    pytest.param(8, 16, 256, id="8-16-256"),     # under one tile
    pytest.param(1, 2048, 256, id="1-2048-256"),  # K5 split in 4
    pytest.param(3, 100, 64, id="3-100-64"),
    pytest.param(2, 1000, 512, id="2-1000-512"),  # ragged, split
]


@pytest.mark.parametrize("bh,seq,d", BWD_CASES)
def test_k5_bf16_rounding_within_the_card_tolerance(bh, seq, d):
    q, k, v, g = _inputs(30 + seq + d, bh, seq, d)
    scale = d ** -0.5
    ref_dq, ref_dk, ref_dv = _bwd_refs(q, k, v, g, scale)
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


@pytest.mark.parametrize("bh,seq,d", BWD_CASES)
def test_k6_bf16_rounding_within_the_card_tolerance(bh, seq, d):
    """The 16->128 path's 256 and 64 tokens, lengths that fill no tile, and
    every class of K6 with its splits."""
    q, k, v, g = _inputs(40 + seq + d, bh, seq, d)
    scale = d ** -0.5
    ref_dq = _bwd_refs(q, k, v, g, scale)[0]
    # lse and dsum as the card's backward gets them: the bf16 forward's
    o, lse = _k4_rounding(q, k, v, scale)
    dq = _k6_rounding(q, k, v, g, lse, (g * o).sum(-1), scale)
    assert _rel(dq, ref_dq) <= TOL_BF16
    o, lse = attention.attention_fwd_plain(q, k, v, scale)
    plain_dq = attention.attention_bwd_plain(q, k, v, g, lse, (g * o).sum(-1),
                                             scale)[0]
    assert _rel(plain_dq, ref_dq) <= TOL_EXACT


# (bh, seq, head_dim) of K4 on the paths (PERF.md section 6) and ragged
# sizes: seq past no tile edge, head_dims under their class's width
PLAN_SHAPES = [(1, 16384, 256), (8, 256, 128), (2, 1024, 512),
               (2, 4096, 512), (8, 1024, 512), (8, 256, 512), (8, 64, 512),
               (8, 16, 256), (8, 4096, 512), (3, 100, 64), (2, 100, 80),
               (2, 300, 192), (2, 130, 384), (1, 77, 16), (5, 1000, 512),
               (64, 4096, 128)]


def _covered(ranges, seq):
    """Whether sorted half-open ranges tile [0, seq) without overlap."""
    at = 0
    for a, b in sorted(ranges):
        if a != at or b <= a:
            return False
        at = b
    return at == seq


@pytest.mark.parametrize("bh,seq,d", PLAN_SHAPES)
def test_k4_plan_covers_every_query_key_pair_once(bh, seq, d):
    """The blocks of the launch (query tile, head, key split) give each
    head's query rows to exactly one tile, and each (head, query tile) the
    key tiles of [0, seq) exactly once over its splits, in key order."""
    p = plan_mirror.fwd_plan(bh, seq, d)
    blocks = plan_mirror.blocks_of(bh, seq, d)
    assert len(blocks) == p["q_tiles"] * bh * p["splits"]
    assert p["splits"] <= plan_mirror.MAX_SPLITS
    by_tile = {}
    for h, rows, keys, z in blocks:
        assert keys, "every split runs at least one key tile"
        by_tile.setdefault((h, rows), []).append((z, keys))
    for h in range(bh):
        rows = [r for hh, r in by_tile if hh == h]
        assert _covered(rows, seq)
    for (h, rows), splits in by_tile.items():
        assert sorted(z for z, _ in splits) == list(range(p["splits"]))
        ranges = [r for _, keys in sorted(splits) for r in keys]
        assert ranges == sorted(ranges)  # split z's keys precede z + 1's
        assert _covered(ranges, seq)
    # a split only where the blocks fill at most half of the SMs
    assert (p["splits"] > 1) <= (2 * p["q_tiles"] * bh <= plan_mirror.SMS)


def test_k4_every_head_dim_has_an_instantiated_class():
    """Each head_dim the wrapper takes (a multiple of 16, at most 512) maps
    to a class at least as wide, and csrc/attention.cu instantiates exactly
    the mirror's classes, in BF16_TILES' order."""
    with open(os.path.join(_build.CSRC_DIR, "attention.cu")) as f:
        src = f.read()
    launched = re.findall(
        r"case (\d+): return launch_class<(\d+), (\d+), (true|false)>",
        src)
    launched += re.findall(
        r"(default): return launch_class<(\d+), (\d+), (true|false)>", src)
    dcs = tuple(int(dc) for _, dc, _, _ in launched)
    bks = tuple(int(bk) for _, _, bk, _ in launched)
    assert dcs == plan_mirror.CLASS_DC and bks == plan_mirror.CLASS_BK
    rows = tuple(64 if split == "true" else 128
                 for _, _, _, split in launched)
    assert rows == plan_mirror.CLASS_ROWS
    for name, values in (("kClassBK", plan_mirror.CLASS_BK),
                         ("kClassRows", plan_mirror.CLASS_ROWS)):
        m = re.search(name + r"\[kClasses\] = \{([^}]*)\}", src)
        assert tuple(int(x) for x in m.group(1).split(",")) == values
    assert attention.BF16_TILES == tuple(
        f"<{dc},{bk}>" for dc, bk in zip(dcs, bks)) + ("merge",)
    assert f"g_fwd_launches[kClasses + 1]" in src
    assert len(plan_mirror.CLASS_DC) == 4 and "kClasses = 4;" in src
    for d in range(16, attention.MAX_HEAD_DIM + 1, 16):
        cls = plan_mirror.head_dim_class(d)
        assert d <= plan_mirror.CLASS_DC[cls]
        assert cls == 0 or d > plan_mirror.CLASS_DC[cls - 1]


def test_k4_merge_order_is_fixed():
    """The merge folds the splits in index order (the kernel's loops over
    z ascend); the emulated merge of the same partials gives the same bits
    every time, and another order gives other bits: the order is part of
    the result, which is why it is fixed."""
    with open(os.path.join(_build.CSRC_DIR, "attention.cu")) as f:
        src = f.read()
    merge = src[src.index("flash_merge_kernel(const float"):]
    merge = merge[:merge.index("\n}\n")]
    assert merge.count("for (int z = 0; z < splits; ++z)") == 3
    assert "atomic" not in merge
    q, k, v, _ = _inputs(7, 2, 1024, D)
    parts = _k4_partials(q, k, v, D ** -0.5)
    assert len(parts) == plan_mirror.fwd_plan(2, 1024, D)["splits"] == 4
    a, b = _k4_merge(parts), _k4_merge(parts)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    c = _k4_merge(parts[::-1])
    assert not torch.equal(a[0], c[0])
    assert _rel(c[0], a[0]) <= TOL_EXACT


@pytest.mark.parametrize("kernel", [0, 1], ids=["k5", "k6"])
@pytest.mark.parametrize("bh,seq,d", PLAN_SHAPES + [(4, 256, 512),
                                                    (16, 256, 512),
                                                    (16, 64, 512),
                                                    (4, 700, 128),
                                                    (1, 2048, 256)])
def test_bwd_plan_covers_every_query_key_pair_once(bh, seq, d, kernel):
    """The blocks of K5's or K6's launch (row tile, head, split) give each
    head's resident rows (K5: keys, K6: queries) to exactly one tile, and
    each (head, row tile) the streamed tiles (K5: queries, K6: keys) of
    [0, seq) exactly once over its splits, in order: every (query, key)
    pair once."""
    p = plan_mirror.bwd_plan(bh, seq, d, kernel)
    blocks = plan_mirror.bwd_blocks_of(bh, seq, d, kernel)
    assert len(blocks) == p["row_tiles"] * bh * p["splits"]
    assert p["splits"] <= plan_mirror.MAX_SPLITS
    by_tile = {}
    for h, rows, cols, z in blocks:
        assert cols, "every split runs at least one streamed tile"
        if p["splits"] > 1:
            assert len(cols) >= plan_mirror.MIN_SPLIT_TILES or \
                z == p["splits"] - 1
        by_tile.setdefault((h, rows), []).append((z, cols))
    for h in range(bh):
        assert _covered([r for hh, r in by_tile if hh == h], seq)
    for (h, rows), splits in by_tile.items():
        assert sorted(z for z, _ in splits) == list(range(p["splits"]))
        ranges = [r for _, cols in sorted(splits) for r in cols]
        assert ranges == sorted(ranges)  # split z's tiles precede z + 1's
        assert _covered(ranges, seq)
    # a split only where the blocks fill at most a quarter of the SMs
    assert (p["splits"] > 1) <= (4 * p["row_tiles"] * bh <= plan_mirror.SMS)


def _c_array(src, name):
    m = re.search(name + r"\[kClasses\] = \{([^}]*)\}", src)
    return tuple(int(x) for x in m.group(1).split(","))


def test_bwd_every_head_dim_has_an_instantiated_class():
    """Each head_dim the wrapper takes maps to a class at least as wide for
    K5 and K6; csrc/attention_bwd.cu's class tables are the mirror's and
    the launcher instantiates each (kernel, class) once, in BWD_TILES'
    order; the K5 classes whose dK and dV would pass 128 registers a
    thread take two passes, the others one."""
    with open(os.path.join(_build.CSRC_DIR, "attention_bwd.cu")) as f:
        src = f.read()
    assert _c_array(src, "kClassDC") == plan_mirror.BWD_CLASS_DC
    assert (_c_array(src, "kDkvBN"), _c_array(src, "kDqBN")) == \
        plan_mirror.BWD_BN
    assert (_c_array(src, "kDkvRows"), _c_array(src, "kDqRows")) == \
        plan_mirror.BWD_ROWS
    assert "kClasses = 4;" in src
    launched = re.findall(r"(case (\d+)|default): return launch_class<(\d), "
                          r"(\d)>", src)
    assert [(int(k), int(c)) for _, _, k, c in launched] == [
        (k, c) for k in (0, 1) for c in range(4)]
    names = tuple(f"{kind}<{dc},{bn}>" for kind, bns in
                  (("dkv", plan_mirror.BWD_BN[0]), ("dq", plan_mirror.BWD_BN[1]))
                  for dc, bn in zip(plan_mirror.BWD_CLASS_DC, bns))
    assert attention.BWD_TILES == names + ("merge",)
    assert [plan_mirror.bwd_passes(dc, 0) for dc in
            plan_mirror.BWD_CLASS_DC] == [1, 1, 1, 2]
    assert all(plan_mirror.bwd_passes(dc, 1) == 1
               for dc in plan_mirror.BWD_CLASS_DC)
    for d in range(16, attention.MAX_HEAD_DIM + 1, 16):
        cls = plan_mirror.head_dim_class(d)
        assert d <= plan_mirror.BWD_CLASS_DC[cls]
        assert cls == 0 or d > plan_mirror.BWD_CLASS_DC[cls - 1]
        for kernel in (0, 1):
            assert plan_mirror.bwd_plan(3, 77, d, kernel)["cls"] == cls


def test_bwd_merge_order_is_fixed():
    """The merge adds the splits' partials in index order (its loop over z
    ascends, no atomics); the emulated merge of the same partials gives the
    same bits every time, and another order other bits: the order is part
    of the result, which is why it is fixed."""
    with open(os.path.join(_build.CSRC_DIR, "attention_bwd.cu")) as f:
        src = f.read()
    merge = src[src.index("flash_bwd_merge_kernel(const float"):]
    merge = merge[:merge.index("\n}\n")]
    assert "for (int z = 1; z < splits; ++z)" in merge
    kernel_src = src[src.index("flash_bwd_wgmma_kernel(const"):]
    kernel_src = kernel_src[:kernel_src.index("\n}\n")]
    assert "atomic" not in merge and "atomic" not in kernel_src
    q, k, v, g = _inputs(8, 2, 1024, D)
    scale = D ** -0.5
    o, lse = _k4_rounding(q, k, v, scale)
    dsum = (g * o).sum(-1)
    for kernel in (0, 1):
        parts = _bwd_partials(q, k, v, g, lse, dsum, scale, kernel)
        assert len(parts) == plan_mirror.bwd_plan(2, 1024, D,
                                                  kernel)["splits"] == 4
        a, b = _bwd_merge(parts), _bwd_merge(parts)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        c = _bwd_merge(parts[::-1])
        assert not all(torch.equal(x, y) for x, y in zip(a, c))
        assert max(_rel(y, x) for x, y in zip(a, c)) <= TOL_EXACT


def test_bwd_tile_order_matches_the_library():
    """sr3_flash_attention_bwd_tiles counts K5's classes, then K6's, then
    the merge, in BWD_TILES' order."""
    with open(os.path.join(_build.CSRC_DIR, "attention_bwd.cu")) as f:
        src = f.read()
    assert "return 2 * kClasses + 1;" in src
    assert "g_bwd_launches[2 * kClasses + 1];" in src
    assert "g_bwd_launches[kKernel * kClasses + kCls].fetch_add" in src
    assert "g_bwd_launches[2 * kClasses].fetch_add" in src  # the merge
    assert len(attention.BWD_TILES) == 2 * 4 + 1
    assert attention.BWD_PLAN_FIELDS == plan_mirror.BWD_FIELDS
    assert attention.BWD_KERNELS == {"sr3_flash_attention_bwd_dkv": 0,
                                     "sr3_flash_attention_bwd_dq": 1}


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
    # the backward kernels' entries: a workspace after the outputs, the
    # workspace size, the plan and the launch counts
    for name in ("sr3_flash_attention_bwd_dkv", "sr3_flash_attention_bwd_dq",
                 "sr3_flash_attention_bwd_workspace_floats",
                 "sr3_flash_attention_bwd_plan",
                 "sr3_flash_attention_bwd_tiles"):
        assert name in found, name
    assert len(found["sr3_flash_attention_bwd_dkv"][0]) == 15
    assert len(found["sr3_flash_attention_bwd_dq"][0]) == 14
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


def test_k4_tile_order_matches_the_library():
    with open(os.path.join(_build.CSRC_DIR, "attention.cu")) as f:
        src = f.read()
    assert "return kClasses + 1;" in src
    assert "g_fwd_launches[kClasses].fetch_add" in src  # the merge, last
    for i in range(4):
        assert re.search(rf"case {i}: return launch_class<" if i < 3 else
                         r"default: return launch_class<", src)


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
