"""The partition and fold order of the GroupNorm kernels (K2 and K1's
statistics launch, ``csrc/groupnorm.cu``), emulated in float32 numpy on the
CPU, against the port's ``group_norm_plain`` and the JAX package's
``group_norm_swish_xla``.

The CUDA kernels cannot run here, so the test mirrors their plan
(``csrc/common.cuh`` ``gn_cluster_plan`` / ``gn_stats_plan``, for an H100's
132 SMs) and their order of float32 additions: channel blocks of whole
groups; per block a pixel range, each thread summing every rows-th pixel of
it in order; the rows of a block folded in a fixed tree; the blocks of a
slice folded in rank order (K2's cluster, through distributed shared
memory) or, for K1's statistics, written to slots that the last block folds
in index order in `parts` runs; the channels of a group summed in order;
then mult / add and x*mult + add (+SiLU). ``tests/test_torch_port_gpu.py``
holds the C library's plan against this mirror on the card.

Shapes: every K2 site of the SR3 16->128 and 64->512 UNets (the dropout
Blocks' GroupNorm+SiLU on maps below 256^2 in training, the attention
pre-norms without SiLU), both with and without SiLU, at batch 2, and a
ragged map (HW = 100, C = 96, G = 32); K1's statistics at a few of its
sites, with the FiLM pre-affine. Tolerance: 1e-5 of max|ref|, float32 sums
in another order than torch's and XLA's.

JAX is imported only where the XLA spec runs, so that the card's tests
(which run without JAX) can import the plan mirror from this module.
"""

import math
import os

import numpy as np
import pytest
import torch

from sr3_tpu_torch.models.unet import Downsample, UNet, Upsample
from sr3_tpu_torch.ops.groupnorm import STATS_MIN_HW, group_norm_plain
from sr3_tpu_torch.utils.config import load_config

TOL = 1e-5
EPS = 1e-5
SMS = 132  # an H100 SXM
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"16_128": os.path.join(ROOT, "configs", "sr_sr3_16_128.json"),
           "64_512": os.path.join(ROOT, "configs",
                                  "sr_sr3_64_512_attn.json")}

# csrc/common.cuh
MAX_CHANNELS = 1024
THREADS = 256
CLUSTER_ROW_BYTES = 64
STATS_ROW_BYTES = 128
MAX_CLUSTER = 16
CHUNK_BYTES = 64 << 10
MAX_SMEM = 232448
STATS_BLOCKS_PER_SM = 4
STATS_MIN_PIXELS = 256
RING = 8  # cp.async slots a thread of K1's statistics launch keeps


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- the plan

def gn_vec(c, elem):
    v = 16 // elem
    return v if c % v == 0 else 1


def block_channels(c, g, elem, row_bytes):
    cg, vec = c // g, gn_vec(c, elem)
    unit = cg // math.gcd(cg, vec) * vec
    for cb in range(unit, c, unit):
        if c % cb == 0 and cb * elem >= row_bytes:
            return cb
    return c


def geometry(c, g, elem, row_bytes):
    cb, vec = block_channels(c, g, elem, row_bytes), gn_vec(c, elem)
    cols = cb // vec
    rows = 1 if cols >= THREADS else THREADS // cols
    return {"vec": vec, "cb": cb, "cols": cols, "rows": rows,
            "threads": cols * rows}


def scratch_bytes(p, cg):
    return 4 * (2 * p["rows"] * p["cb"] + 2 * p["cb"] + 2 * (p["cb"] // cg))


def cluster_plan(b, hw, c, g, elem, sms=SMS):
    """K2: cluster size (splits), pixels a block, residency."""
    p = geometry(c, g, elem, CLUSTER_ROW_BYTES)
    clusters = b * (c // p["cb"])
    cs = max(-(-hw * p["cb"] * elem // CHUNK_BYTES), -(-sms // clusters))
    p["splits"] = max(1, min(cs, MAX_CLUSTER, hw))
    p["per"] = -(-hw // p["splits"])
    tile = -(-p["per"] * p["cb"] * elem // 16) * 16
    scratch = scratch_bytes(p, c // g)
    p["resident"] = int(tile + scratch <= MAX_SMEM)
    p["smem_bytes"] = scratch + (tile if p["resident"] else 0)
    return p


def stats_plan(b, hw, c, g, elem, sms=SMS):
    """K1's statistics: blocks a slice (splits), pixels a block."""
    p = geometry(c, g, elem, STATS_ROW_BYTES)
    slices = b * (c // p["cb"])
    s = min(-(-STATS_BLOCKS_PER_SM * sms // slices), hw // STATS_MIN_PIXELS)
    p["splits"] = max(1, s)
    p["per"] = -(-hw // p["splits"])
    red = 4 * 2 * p["rows"] * p["cb"]
    ring = RING * p["threads"] * 16 if p["vec"] > 1 else 0
    p["smem_bytes"] = scratch_bytes(p, c // g) + max(0, ring - red)
    return p


# ------------------------------------------------------- the emulation

def block_sums(v, p):
    """Per-(b, block, channel) float32 sums of v (B, HW, C) and v^2 in the
    kernels' order: each thread's pixels in order, then the rows of a block
    in the fixed tree. Returns two (B, splits, C) arrays."""
    b, hw, c = v.shape
    splits, per, rows = p["splits"], p["per"], p["rows"]
    n_iter = -(-per // rows)
    blocks = np.zeros((b, splits, n_iter * rows, c), np.float32)
    for k in range(splits):
        p0, p1 = min(hw, k * per), min(hw, k * per + per)
        blocks[:, k, :p1 - p0] = v[:, p0:p1]
    blocks = blocks.reshape(b, splits, n_iter, rows, c)
    s1 = np.zeros((b, splits, rows, c), np.float32)
    s2 = np.zeros_like(s1)
    for i in range(n_iter):  # a thread's pixels, in order
        t = blocks[:, :, i]
        s1 += t
        s2 += t * t
    h = 1
    while 2 * h < rows:
        h *= 2
    while h > 0:  # row i takes row i + h
        n = max(0, min(h, rows - h))
        s1[:, :, :n] += s1[:, :, h:h + n]
        s2[:, :, :n] += s2[:, :, h:h + n]
        h //= 2
    return s1[:, :, 0], s2[:, :, 0]


def in_order(parts):
    """Sum of a sequence of float32 arrays, left to right."""
    out = np.zeros_like(parts[0])
    for a in parts:
        out += a
    return out


def cluster_fold(s1, s2):
    """K2: the blocks of a slice in rank order."""
    n = s1.shape[1]
    return (in_order([s1[:, k] for k in range(n)]),
            in_order([s2[:, k] for k in range(n)]))


def slot_fold(s1, s2, p):
    """K1's statistics: the last block folds the slots in index order, in
    `parts` runs of slots added in order (a thread takes 4 neighbouring
    values of a slot when the slot's 2*cb floats allow it)."""
    splits, n2 = p["splits"], 2 * p["cb"]
    if splits == 1:
        return s1[:, 0], s2[:, 0]
    ncol = n2 // 4 if n2 % 4 == 0 else n2
    parts = max(1, min(p["rows"], p["threads"] // ncol))
    runs = [(pt * splits // parts, (pt + 1) * splits // parts)
            for pt in range(parts)]
    out = []
    for s in (s1, s2):
        out.append(in_order([in_order([s[:, k] for k in range(k0, k1)])
                             for k0, k1 in runs if k1 > k0]))
    return out


def group_fold(t1, t2, hw, g, gamma, beta, a=None, o=None):
    """Per-channel mult / add (B, C) from per-channel sums, the channels of
    a group added in order."""
    b, c = t1.shape
    cg = c // g
    g1 = in_order([t1.reshape(b, g, cg)[:, :, j] for j in range(cg)])
    g2 = in_order([t2.reshape(b, g, cg)[:, :, j] for j in range(cg)])
    cnt = np.float32(hw) * np.float32(cg)
    mean = g1 / cnt
    var = np.maximum(g2 / cnt - mean * mean, np.float32(0))
    rstd = (np.float32(1) / np.sqrt(var + np.float32(EPS))).astype(np.float32)
    sc = gamma[None] * np.repeat(rstd, cg, axis=1)
    a = np.ones((b, c), np.float32) if a is None else a
    o = np.zeros((b, c), np.float32) if o is None else o
    return a * sc, (o - np.repeat(mean, cg, axis=1)) * sc + beta[None]


def silu(v):
    return v / (np.float32(1) + np.exp(-v))


def emulate_k2(x, gamma, beta, g, swish, p):
    """K2 on x (B, HW, C) float32 with plan p."""
    b, hw, c = x.shape
    mult = np.empty((b, c), np.float32)
    add = np.empty_like(mult)
    cb = p["cb"]
    for c0 in range(0, c, cb):  # one cluster per (b, channel block)
        s1, s2 = block_sums(x[:, :, c0:c0 + cb], p)
        t1, t2 = cluster_fold(s1, s2)
        mult[:, c0:c0 + cb], add[:, c0:c0 + cb] = group_fold(
            t1, t2, hw, g * cb // c, gamma[c0:c0 + cb], beta[c0:c0 + cb])
    y = x * mult[:, None] + add[:, None]
    return silu(y) if swish else y


def emulate_k1_stats(x, gamma, beta, g, a, o, p):
    """K1's statistics launch: mult / add (B, C) of a*x + o."""
    b, hw, c = x.shape
    v = x * a[:, None] + o[:, None]
    mult = np.empty((b, c), np.float32)
    add = np.empty_like(mult)
    cb = p["cb"]
    for c0 in range(0, c, cb):
        sl = slice(c0, c0 + cb)
        s1, s2 = block_sums(v[:, :, sl], p)
        t1, t2 = slot_fold(s1, s2, p)
        mult[:, sl], add[:, sl] = group_fold(
            t1, t2, hw, g * cb // c, gamma[sl], beta[sl], a[:, sl], o[:, sl])
    return mult, add


# ------------------------------------------------------------ the sites

def k2_sites(name):
    """(C, H, groups, swish) of every K2 call of one training forward of a
    config's UNet, read off a meta-device build: the dropout Block of every
    ResnetBlock (GroupNorm+SiLU) on maps below STATS_MIN_HW, and every
    attention pre-norm (no SiLU)."""
    opt = load_config(CONFIGS[name])
    u, d = opt["model"]["unet"], opt["model"]["diffusion"]
    groups = u.get("norm_groups") or 32
    with torch.device("meta"):
        net = UNet(in_channel=u["in_channel"], out_channel=u["out_channel"],
                   inner_channel=u["inner_channel"], norm_groups=groups,
                   channel_mults=tuple(u["channel_multiplier"]),
                   attn_res=tuple(u["attn_res"] or ()),
                   res_blocks=u["res_blocks"], dropout=u["dropout"],
                   image_size=d["image_size"])
    res, out = net.image_size, set()
    for layer in (*net.downs[1:], *net.mid, *net.ups):
        if isinstance(layer, Downsample):
            res //= 2
            continue
        if isinstance(layer, Upsample):
            res *= 2
            continue
        c = layer.res_block.block2.block[3].weight.shape[0]
        if res * res < STATS_MIN_HW:
            out.add((c, res, groups, True))
        if layer.attn is not None:
            out.add((layer.attn.qkv.weight.shape[1], res, groups, False))
    return sorted(out)


def train_batch(name):
    return load_config(CONFIGS[name])["datasets"]["train"]["batch_size"]


SITES = {name: k2_sites(name) for name in CONFIGS}
SHAPES = sorted({(c, h, g) for sites in SITES.values()
                 for c, h, g, _ in sites})
RAGGED = (96, 10, 32)  # HW = 100


def test_sites_are_the_models_k2_calls():
    """Both models run K2 at maps 8^2..128^2, C 64..512, 16 and 32 groups,
    with and without SiLU."""
    assert {h for _, h, _ in SHAPES} == {8, 16, 32, 64, 128}
    assert {g for _, _, g in SHAPES} == {16, 32}
    assert {c for c, _, _ in SHAPES} == {64, 128, 256, 512}
    for sites in SITES.values():
        assert {s for *_, s in sites} == {True, False}


def _inputs(b, c, h, seed):
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal((b, h, h, c)) + 1).astype(np.float32)
    gamma = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, gamma, beta


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("swish", [True, False])
@pytest.mark.parametrize("c,h,g", SHAPES + [RAGGED])
def test_k2_emulation_matches_plain_and_xla(c, h, g, swish):
    import jax
    import jax.numpy as jnp

    from sr3_tpu.ops.groupnorm import group_norm_swish_xla

    b = 2
    x, gamma, beta = _inputs(b, c, h, seed=c + h + g)
    p = cluster_plan(b, h * h, c, g, 4)
    out = emulate_k2(x.reshape(b, h * h, c), gamma, beta, g, swish, p)
    out = out.reshape(b, h, h, c)
    plain = group_norm_plain(_nchw(x), torch.from_numpy(gamma),
                             torch.from_numpy(beta), g, EPS, swish)
    plain = plain.permute(0, 2, 3, 1).numpy()
    xla = np.asarray(jax.jit(group_norm_swish_xla, static_argnums=(3, 4, 5))(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), g, EPS, swish))
    for ref in (plain, xla):
        err = np.abs(out - ref).max() / np.abs(ref).max()
        assert err <= TOL, err


def test_k2_emulation_without_residency():
    """A slice larger than a 16-block cluster's shared memory (float32,
    128 channels a group at 128^2): the second pass re-reads x, the same
    arithmetic."""
    b, c, h, g = 1, 256, 128, 2
    p = cluster_plan(b, h * h, c, g, 4)
    assert not p["resident"] and p["splits"] == MAX_CLUSTER
    x, gamma, beta = _inputs(b, c, h, seed=7)
    out = emulate_k2(x.reshape(b, h * h, c), gamma, beta, g, True, p)
    ref = group_norm_plain(_nchw(x), torch.from_numpy(gamma),
                           torch.from_numpy(beta), g, EPS, True)
    ref = ref.permute(0, 2, 3, 1).numpy().reshape(out.shape)
    assert np.abs(out - ref).max() / np.abs(ref).max() <= TOL


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_every_site_is_resident_in_bf16(name):
    """At the training batch and the serving batch 8, every K2 site's slice
    stays in its cluster's shared memory, in clusters of at most 16 blocks
    that fill the card."""
    for b in (train_batch(name), 8):
        for c, h, g, _ in SITES[name]:
            p = cluster_plan(b, h * h, c, g, 2)
            assert p["resident"], (b, c, h, g, p)
            assert p["smem_bytes"] <= MAX_SMEM
            assert 1 <= p["splits"] <= MAX_CLUSTER
            assert b * (c // p["cb"]) * p["splits"] >= SMS or \
                p["splits"] == min(MAX_CLUSTER, h * h), (b, c, h, p)


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("b,hw,c,g", [
    (2, 4096, 512, 16), (4, 16384, 64, 32), (8, 64, 1024, 32),
    (2, 100, 96, 32), (1, 1, 1024, 1), (3, 7, 6, 3), (2, 262144, 64, 16),
    (65535, 1, 8, 8),
])
def test_plan_invariants(b, hw, c, g, elem):
    """Channel blocks of whole groups and whole 16-byte words; the blocks'
    ranges cover every pixel (the last ones may be empty); threads and
    shared memory within a block's limits."""
    for p, row in ((cluster_plan(b, hw, c, g, elem), CLUSTER_ROW_BYTES),
                   (stats_plan(b, hw, c, g, elem), STATS_ROW_BYTES)):
        cb, cg = p["cb"], c // g
        assert c % cb == 0 and cb % cg == 0 and cb % p["vec"] == 0
        assert cb * elem >= row or cb == c
        assert p["threads"] == p["cols"] * p["rows"] <= MAX_CHANNELS
        assert 1 <= p["per"] <= hw <= p["splits"] * p["per"]
        assert p["smem_bytes"] <= MAX_SMEM
    assert cluster_plan(b, hw, c, g, elem)["splits"] <= MAX_CLUSTER


# (B, C, H, G): K1 sites -- 64->512 at 512^2 (many slots a slice), 16->128
# at 8^2 (one block a slice), and the GPU tests' ragged float32 C_in
K1_CASES = [(2, 64, 512, 16), (2, 256, 128, 16), (8, 1024, 8, 32),
            (2, 40, 8, 8)]


@pytest.mark.parametrize("b,c,h,g", K1_CASES)
def test_k1_stats_emulation_matches_plain(b, c, h, g):
    """K1's statistics: mult / add of the FiLM pre-affined map, applied as
    x*mult + add, against group_norm_plain of a*x + o."""
    x, gamma, beta = _inputs(b, c, h, seed=b + c + h)
    rng = np.random.default_rng(3)
    a = (1 + 0.3 * rng.standard_normal((b, c))).astype(np.float32)
    o = (0.5 * rng.standard_normal((b, c))).astype(np.float32)
    p = stats_plan(b, h * h, c, g, 4)
    if h == 512:
        assert p["splits"] > 1  # the slot fold runs
    if h == 8:
        assert p["splits"] == 1
    xs = x.reshape(b, h * h, c)
    mult, add = emulate_k1_stats(xs, gamma, beta, g, a, o, p)
    out = xs * mult[:, None] + add[:, None]
    v = _nchw(x) * torch.from_numpy(a)[:, :, None, None] \
        + torch.from_numpy(o)[:, :, None, None]
    ref = group_norm_plain(v, torch.from_numpy(gamma),
                           torch.from_numpy(beta), g, EPS, False)
    ref = ref.permute(0, 2, 3, 1).numpy().reshape(out.shape)
    assert np.abs(out - ref).max() / np.abs(ref).max() <= TOL


class _FakeClusterCounts:
    """Stands in for the kernel library's K2 launch counts: 64 counts, the
    given ones set, zeroed on a read with reset."""

    def __init__(self, counts):
        self.counts = dict(counts)

    def sr3_group_norm_clusters(self, out, reset):
        for i in range(64):
            out[i] = self.counts.get(i, 0)
        if reset:
            self.counts.clear()
        return 64


def test_cluster_launch_counts_decode_as_the_library_lays_them_out(
        monkeypatch):
    """groupnorm.cluster_launches reads the library's counts (index
    (dtype * 2 + resident) * 16 + cluster size - 1, groupnorm.cu) as
    (dtype, cluster size, resident), drops zeros and resets on request."""
    from sr3_tpu_torch.ops import _build, groupnorm

    with open(os.path.join(ROOT, "sr3_tpu_torch", "csrc",
                           "groupnorm.cu")) as f:
        src = f.read()
    assert "g_cluster_launches[2][2][kGnMaxCluster]" in src
    assert "[sizeof(T) == 2][p.resident != 0][p.splits - 1]" in src
    with open(os.path.join(ROOT, "sr3_tpu_torch", "csrc",
                           "common.cuh")) as f:
        assert f"kGnMaxCluster = {MAX_CLUSTER};" in f.read()
    lib = _FakeClusterCounts({0: 3, (1 * 2 + 1) * 16 + 3: 5, 31: 1, 63: 2})
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    want = {("float32", 1, False): 3, ("bfloat16", 4, True): 5,
            ("float32", 16, True): 1, ("bfloat16", 16, True): 2}
    assert groupnorm.cluster_launches() == want
    assert groupnorm.cluster_launches(reset=True) == want
    assert groupnorm.cluster_launches() == {}
