"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``: the kernels have no CPU mode, so these tests skip without a
CUDA device. On a machine with a card and without JAX (tests/conftest.py
imports it), run them with

  python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py

Tolerances, relative to max|plain|: float32 1e-4 for K1, K4, K5 and K6 and
1e-5 for K2 and the statistics route (float32 sums in another order);
bfloat16 2e-2 for K1, K2 and the route (the plain version rounds
intermediate results to bf16, 2^-8 relative each, where a kernel rounds
once), 2e-2 for K4's output, K5's dk, dv and K6's dq (their tensor-core
routes round P, dO, P, dS, and dO, dS to bf16 before the products; each
bf16 K4 / K5 / K6 check also holds the classes it launched against the
plan mirror), and
1e-4 for K4's logsumexp (both sides compute it in float32 from the same
inputs). The reasons are spelled out in each kernel's source header. The autograd
Functions against autograd of the plain versions: float32 1e-4; bfloat16
2e-2 (each side rounds its input
gradients to bf16 once, and K2's hand backward differs from autograd's
composition in where it rounds). K3's sums against float64 sums of the same
inputs: s1 within 1e-5 of sum|x|, s2 within 1e-5 of s2. K1's halo entry
(outside statistics, halo rows) against its plain version: as K1. The
GroupNorm(+SiLU) backward kernel against ``gn_silu_bwd_plain``: float32
1e-4 (sums in another order), bfloat16 dx (and its activation mode's act)
GN_BWD_BF16_TOL, one bf16 step; each output relative to its own
max|plain|.
"""

import pytest
import torch

from sr3_tpu_torch.models.unet import UNet
from sr3_tpu_torch.ops import attention, conv_fused, groupnorm
import torch_port_attention_plan as plan_mirror
import torch_port_conv_plan as conv_mirror

pytestmark = pytest.mark.gpu
CL = torch.channels_last
TOL = {torch.float32: {"k1": 1e-4, "k2": 1e-5, "k4": 1e-4, "lse": 1e-4,
                       "k5": 1e-4, "k6": 1e-4, "grad": 1e-4},
       torch.bfloat16: {"k1": 2e-2, "k2": 2e-2, "k4": 2e-2, "lse": 1e-4,
                        "k5": 2e-2, "k6": 2e-2, "grad": 2e-2}}


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
    (2, 48, 200, 12, 20, True),     # ragged C_out past one N-tile
    (2, 64, 3, 12, 20, False),      # C_out 3 on a ragged map
    (1, 1024, 512, 8, 8, True),
    (3, 1024, 512, 8, 8, False),    # 8^2 maps: two images a tile, odd batch
    (1, 64, 64, 256, 256, True),    # the 64->512 UNet's maps
    (1, 128, 64, 512, 512, False),
    (1, 64, 3, 512, 512, False),    # final_conv at 512^2
    # bf16: 128 output channels a block, 2 and 4 channel blocks
    (2, 128, 256, 128, 128, True),
    (8, 512, 512, 64, 64, False),
])
def test_k1_matches_plain(gen, dtype, b, cin, cout, h, w, film):
    args, kw = _k1_inputs(gen, dtype, b, cin, cout, h, w, film)
    n = conv_fused.counter.n
    out = conv_fused.gn_silu_conv3x3(*args, **kw)
    assert conv_fused.counter.n == n + 1
    assert out.is_contiguous(memory_format=CL) and out.dtype == dtype
    ref = conv_fused.gn_silu_conv3x3_plain(*args, **kw)
    assert rel(out, ref) <= TOL[dtype]["k1"]


# one shape per bfloat16 class of K1's conv launch, and BN 192 and 256 over
# several N-tiles (C_out 384, 768, 1536 -> 768, 512)
@pytest.mark.parametrize("b,cin,cout,hw,tile", [
    (2, 128, 256, 128, "<16,1,256>"),
    (2, 192, 192, 128, "<16,1,192>"),   # the ADM's 192 channels: one N-tile
    (8, 128, 128, 64, "<16,1,128>"),
    (1, 128, 256, 64, "<16,1,64>"),     # 32 pixel tiles: narrow N-tiles
    (128, 512, 512, 8, "<8,2,128>"),    # 8^2 maps: two images a tile
    (2, 512, 512, 8, "<8,2,64>"),
    (2, 64, 3, 32, "<16,1,8>"),
    (3, 64, 3, 8, "<16,1,8>"),          # C_out 3 on an 8^2 map: one image a tile
    (8, 192, 384, 64, "<16,1,192>"),    # 2 N-tiles
    (64, 256, 768, 32, "<16,1,256>"),   # 3 N-tiles
    (8, 1536, 768, 32, "<16,1,192>"),   # 4 N-tiles, the ADM's up path
    (128, 512, 512, 16, "<16,1,256>"),  # 2 N-tiles, SR3 16->128 at 16^2
])
def test_k1_bf16_tile_choice(gen, b, cin, cout, hw, tile):
    """The class the plan mirror picks launches, matches the plain version
    and gives the same bits twice."""
    args, kw = _k1_inputs(gen, torch.bfloat16, b, cin, cout, hw, hw, True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mirror = conv_mirror.conv_plan(b, hw, hw, cout, sms)
    assert conv_fused.bf16_plan(b, hw, hw, cout) == mirror
    if sms == conv_mirror.SMS:
        assert conv_fused.BF16_TILES[mirror["cls"]] == tile
    conv_fused.bf16_tile_launches(reset=True)
    out = conv_fused.gn_silu_conv3x3(*args, **kw)
    taken = {k: n for k, n in conv_fused.bf16_tile_launches().items() if n}
    assert taken == {conv_fused.BF16_TILES[mirror["cls"]]: 1}
    ref = conv_fused.gn_silu_conv3x3_plain(*args, **kw)
    assert rel(out, ref) <= TOL[torch.bfloat16]["k1"]
    again = conv_fused.gn_silu_conv3x3(*args, **kw)
    assert torch.equal(out.view(torch.int16), again.view(torch.int16))


@pytest.mark.parametrize("name,batch", [("sr3_16_128", 128),
                                        ("sr3_64_512", 8),
                                        ("adm_128_512", 8)])
def test_k1_forward_classes_follow_the_plan(gen, name, batch):
    """A bf16 serving forward of each benchmark configuration at its cell's
    batch launches, by the tile counters, the classes the plan mirror gives
    its K1 sites, and the library's plan is the mirror's at each site."""
    import json
    import os
    from collections import Counter

    from portbench import costs
    from portbench.reference import adm as ref
    from sr3_tpu_torch.models import adm_unet
    from sr3_tpu_torch.models.networks import define_G

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "portbench", "configs", name + ".json")) as f:
        opt = json.load(f)["opt"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    if name == "adm_128_512":
        sites = ref.k1_sites(opt, batch)
        with torch.device("cuda"):
            net = adm_unet.adm_from_opt(opt["model"], torch.bfloat16)
        net = net.to(memory_format=CL).eval()
        inputs = (r(batch, 3, 512, 512),
                  torch.full((batch,), 999, device="cuda"),
                  r(batch, 3, 128, 128).clamp(-1, 1),
                  torch.arange(batch, device="cuda"))
    else:
        sites = costs.k1_sites(opt, batch, False)
        net = define_G(opt, device="cuda").denoise_fn.eval()
        size = opt["model"]["diffusion"]["image_size"]
        inputs = (r(batch, net.in_channel, size, size).contiguous(
            memory_format=CL), torch.rand(batch, device="cuda", generator=gen))
    want = Counter()
    for s in sites:
        p = conv_mirror.conv_plan(s["b"], s["h"], s["w"], s["cout"], sms)
        assert conv_fused.bf16_plan(s["b"], s["h"], s["w"], s["cout"]) == p
        want[conv_fused.BF16_TILES[p["cls"]]] += 1
    conv_fused.bf16_tile_launches(reset=True)
    with torch.inference_mode():
        out = net(*inputs)
    torch.cuda.synchronize()
    taken = {k: n for k, n in conv_fused.bf16_tile_launches(reset=True).items()
             if n}
    print(f"{name} batch {batch}: {taken}")
    assert taken == dict(want)
    assert torch.isfinite(out).all()


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


# K1 with the scale-shift after the norm (guided-diffusion's ResBlocks) at
# the ADM 128->512 cell's shapes: an out_layers call at 512^2 and at 16^2,
# an up-path in_layers call over 1536 and 1152 concatenated channels (K1's
# statistics launch takes up to 2048), and the head (C_out 6). The worst
# bf16 readings on the card were 4.8e-3 of max|plain| at the cell's shapes
# and 5.6e-3 on the ragged one (limit 2e-2), float32 7.5e-7 (limit 1e-4).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,cin,cout,h,post", [
    (8, 192, 192, 512, True),
    (8, 768, 768, 16, True),
    (8, 1536, 768, 16, False),
    (8, 1152, 384, 64, False),
    (8, 192, 6, 512, False),
    (2, 48, 40, 12, True),        # ragged C_out and tiles
])
def test_k1_scale_shift_matches_plain(gen, dtype, b, cin, cout, h, post):
    if dtype == torch.float32 and h == 512:
        b = 2  # the float32 plain version's intermediates at batch 8
    args, _ = _k1_inputs(gen, dtype, b, cin, cout, h, h, False)
    args = args[:5] + (32 if cin % 32 == 0 else 8,)
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    kw = {}
    if post:
        kw = dict(post_scale=0.3 * r(b, cin), post_shift=0.5 * r(b, cin),
                  residual=r(b, cout, h, h).to(dtype).contiguous(
                      memory_format=CL))
    n = conv_fused.counter.n
    out = conv_fused.gn_silu_conv3x3(*args, **kw)
    assert conv_fused.counter.n == n + 1
    assert out.is_contiguous(memory_format=CL) and out.dtype == dtype
    ref = conv_fused.gn_silu_conv3x3_plain(*args, **kw)
    got = rel(out, ref)
    print(f"k1 scale-shift {dtype} {(b, cin, cout, h, post)}: {got:.3e}")
    assert got <= TOL[dtype]["k1"]


def test_k1_scale_shift_leaves_the_pre_affine_route_alone(gen):
    """A zero scale and shift give the kernel's own route's bits, and the
    pre-affine route's output does not depend on a scale-shift call before
    it."""
    args, kw = _k1_inputs(gen, torch.bfloat16, 2, 128, 64, 64, 64, True)
    first = conv_fused.gn_silu_conv3x3(*args, **kw)
    zero = torch.zeros(2, 128, device="cuda")
    conv_fused.gn_silu_conv3x3(*args, residual=kw["residual"],
                               post_scale=zero + 0.5, post_shift=zero)
    again = conv_fused.gn_silu_conv3x3(*args, **kw)
    assert torch.equal(first, again)
    plain = conv_fused.gn_silu_conv3x3(*args, residual=kw["residual"])
    posted = conv_fused.gn_silu_conv3x3(*args, residual=kw["residual"],
                                        post_scale=zero, post_shift=zero)
    assert torch.equal(plain, posted)


def _halo_inputs(gen, dtype, b, cin, cout, h, w, top, bottom):
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    row = lambda on: (r(b, cin, 1, w).to(dtype).contiguous(memory_format=CL)
                      if on else None)
    wt = (r(cout, cin, 3, 3) / (3 * cin ** 0.5)).to(dtype)
    return (r(b, cin, h, w).to(dtype).contiguous(memory_format=CL),
            row(top), row(bottom), 1 + 0.3 * r(b, cin), 0.2 * r(b, cin),
            wt.contiguous(memory_format=CL), 0.1 * r(cout),
            r(b, cout, h, w).to(dtype).contiguous(memory_format=CL))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,cin,cout,h,w,top,bottom", [
    (2, 64, 64, 64, 128, False, True),    # 16->128 stem level, first shard
    (2, 128, 64, 32, 64, True, True),     # an inner shard
    (2, 512, 512, 4, 8, True, False),     # an 8^2 map, last shard (2 rows
    (1, 64, 3, 256, 512, True, False),    # of 4); final_conv at 512^2
    (2, 48, 40, 5, 20, True, True),       # ragged
    (2, 64, 128, 16, 32, False, False),   # a shard with no halo row given
])
def test_k1_halo_entry_matches_plain(gen, dtype, b, cin, cout, h, w, top,
                                     bottom):
    args = _halo_inputs(gen, dtype, b, cin, cout, h, w, top, bottom)
    n = conv_fused.halo_counter.n
    out = conv_fused.gn_silu_conv3x3_halo(*args)
    assert conv_fused.halo_counter.n == n + 1
    assert out.is_contiguous(memory_format=CL) and out.dtype == dtype
    ref = conv_fused.gn_silu_conv3x3_halo_plain(*args)
    assert rel(out, ref) <= TOL[dtype]["k1"]


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
    # the 16->128 and 64->512 training sites, a ragged 10x10 map, a slice
    # too large for a 16-block cluster's shared memory, and odd channels
    (4, 64, 128, 32, True), (2, 512, 64, 16, False), (2, 512, 32, 16, True),
    (2, 96, 10, 32, True), (1, 256, 128, 2, True), (3, 6, 7, 3, True),
    # the attention pre-norms of both serving paths at batch 8
    (8, 512, 16, 32, False), (8, 512, 8, 32, False), (8, 512, 64, 16, False),
    (8, 512, 32, 16, False),
])
def test_k2_matches_plain(gen, dtype, b, c, hw, groups, swish):
    x = 3 * torch.randn(b, c, hw, hw, device="cuda", generator=gen) + 1
    x = x.to(dtype).contiguous(memory_format=CL)
    s = 1 + 0.2 * torch.randn(c, device="cuda", generator=gen)
    t = 0.1 * torch.randn(c, device="cuda", generator=gen)
    n = groupnorm.counter.n
    groupnorm.cluster_launches(reset=True)
    out = groupnorm.group_norm(x, s, t, groups, swish=swish)
    assert groupnorm.counter.n == n + 1
    plan = groupnorm.gn_plan(x.shape, groups, dtype)
    name = str(dtype).split(".")[-1]
    assert groupnorm.cluster_launches() == {
        (name, plan["splits"], bool(plan["resident"])): 1}
    ref = groupnorm.group_norm_plain(x, s, t, groups, swish=swish)
    assert rel(out, ref) <= TOL[dtype]["k2"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupnorm_kernels_are_bit_identical_across_calls(gen, dtype):
    """K2 and K1 (its statistics: many blocks a slice at 512^2, folded by
    the last one) give the same bits twice; K1's tickets are 0 after."""
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    x = (3 * torch.randn(2, 512, 64, 64, device="cuda", generator=gen) + 1)
    x = x.to(dtype).contiguous(memory_format=CL)
    s = 1 + 0.2 * torch.randn(512, device="cuda", generator=gen)
    t = 0.1 * torch.randn(512, device="cuda", generator=gen)
    a, b = (groupnorm.group_norm(x, s, t, 16, swish=True) for _ in range(2))
    assert torch.equal(a.view(bits), b.view(bits))
    args, kw = _k1_inputs(gen, dtype, 2, 64, 64, 512, 512, True)
    a, b = (conv_fused.gn_silu_conv3x3(*args, **kw) for _ in range(2))
    assert torch.equal(a.view(bits), b.view(bits))
    assert groupnorm.gn_plan(args[0].shape, 8, dtype, "stats")["splits"] > 1
    for tickets in groupnorm._tickets.values():
        assert int(torch.count_nonzero(tickets)) == 0


def test_k1_tickets_are_kept_per_stream(gen):
    """K1 calls on two streams take two sets of ticket counters, give the
    same bits, and leave both at 0."""
    args, kw = _k1_inputs(gen, torch.bfloat16, 2, 64, 64, 512, 512, True)
    assert groupnorm.gn_plan(args[0].shape, 8, torch.bfloat16,
                             "stats")["splits"] > 1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    a = conv_fused.gn_silu_conv3x3(*args, **kw)
    with torch.cuda.stream(side):
        b = conv_fused.gn_silu_conv3x3(*args, **kw)
    torch.cuda.current_stream().wait_stream(side)
    streams = {key[1] for key in groupnorm._tickets}
    assert {torch.cuda.current_stream().cuda_stream,
            side.cuda_stream} <= streams
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    for tickets in groupnorm._tickets.values():
        assert int(torch.count_nonzero(tickets)) == 0


def test_gn_plan_matches_the_cpu_emulation(gen):
    """The C library's plans are the ones tests/test_torch_port_gn_cluster
    emulates on the CPU (its mirror, at this card's SM count)."""
    import test_torch_port_gn_cluster as mirror

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [(b, h * h, c, g) for name in mirror.SITES
              for b in (mirror.train_batch(name), 8)
              for c, h, g, _ in mirror.SITES[name]]
    shapes += [(2, 100, 96, 32), (1, 16384, 256, 2), (3, 49, 6, 3),
               (2, 262144, 64, 16), (8, 64, 1024, 32), (2, 64, 40, 8)]
    for route, plan in (("cluster", mirror.cluster_plan),
                        ("stats", mirror.stats_plan)):
        for dtype, elem in ((torch.float32, 4), (torch.bfloat16, 2)):
            for b, hw, c, g in shapes:
                got = groupnorm.gn_plan((b, c, hw, 1), g, dtype, route)
                want = plan(b, hw, c, g, elem, sms)
                keys = ["vec", "cb", "threads", "splits", "per",
                        "smem_bytes"] + (["resident"] if route == "cluster"
                                         else [])
                assert got["sms"] == sms
                assert {k: got[k] for k in keys} == \
                    {k: want[k] for k in keys}, (route, dtype, b, hw, c, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,h,w", [(2, 64, 512, 512), (2, 128, 256, 256),
                                     (2, 96, 300, 300)])
def test_k3_and_statistics_route_match_plain(gen, dtype, b, c, h, w):
    """K3 against float64 sums and gn_stats_plain; group_norm on these maps
    takes the statistics route and matches group_norm_plain."""
    x = 3 * torch.randn(b, c, h, w, device="cuda", generator=gen) + 1
    x = x.to(dtype).contiguous(memory_format=CL)
    n = groupnorm.stats_counter.n
    s1, s2 = groupnorm.gn_stats(x)
    assert groupnorm.stats_counter.n == n + 1
    p1, p2 = groupnorm.gn_stats_plain(x)
    torch.cuda.synchronize()
    xd = x.double()
    r1, r2 = xd.sum(dim=(2, 3)), xd.square().sum(dim=(2, 3))
    for got, plain, ref, scale in ((s1, p1, r1, xd.abs().sum(dim=(2, 3))),
                                   (s2, p2, r2, r2)):
        assert got.dtype == torch.float32 and got.shape == (b, c)
        assert ((got.double() - ref).abs() / scale).max().item() <= 1e-5
        assert ((got.double() - plain.double()).abs() / scale).max().item() \
            <= 1e-5
    s = 1 + 0.2 * torch.randn(c, device="cuda", generator=gen)
    t = 0.1 * torch.randn(c, device="cuda", generator=gen)
    out = groupnorm.group_norm(x, s, t, 16, swish=True)
    assert groupnorm.stats_counter.n == n + 2
    assert out.is_contiguous(memory_format=CL) and out.dtype == dtype
    ref = groupnorm.group_norm_plain(x, s, t, 16, swish=True)
    assert rel(out, ref) <= TOL[dtype]["k2"]


def test_k3_rejects_what_it_does_not_take(gen):
    x = torch.randn(1, 20, 256, 256, device="cuda", generator=gen)
    x = x.to(torch.bfloat16).contiguous(memory_format=CL)  # 20 % 8 != 0
    n = groupnorm.stats_counter.n
    with pytest.raises(ValueError, match="multiple of 8"):
        groupnorm.gn_stats(x)
    assert groupnorm.stats_counter.n == n


# K4 shapes: every bf16 class <DC, BK> with and without a key split, a
# ragged seq, and head_dims under their class's width (80, 192, 16, 384)
K4_CASES = [(2, 256, 512), (2, 64, 512), (3, 100, 64), (8, 256, 128),
            (8, 16, 256), (2, 100, 80), (2, 300, 192), (1, 77, 16),
            (2, 130, 384), (2, 1024, 512), (8, 1024, 512), (4, 700, 128),
            (2, 1000, 512), (1, 2048, 256)]


def _k4_launched(bh, seq, d):
    """K4's bf16 launches the mirror's plan expects for one call."""
    p = plan_mirror.fwd_plan(bh, seq, d)
    want = {name: 0 for name in attention.BF16_TILES}
    want[attention.BF16_TILES[p["cls"]]] = 1
    want["merge"] = int(p["splits"] > 1)
    return want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,seq,d", K4_CASES)
def test_k4_matches_plain(gen, dtype, bh, seq, d):
    q, k, v = (torch.randn(bh, seq, d, device="cuda", generator=gen)
               .to(dtype) for _ in range(3))
    n = attention.counter.n
    attention.bf16_tile_launches(reset=True)
    out = attention.attention(q, k, v, d ** -0.5)
    assert attention.counter.n == n + 1 and out.dtype == torch.float32
    launched = attention.bf16_tile_launches(reset=True)
    if dtype == torch.bfloat16:
        assert launched == _k4_launched(bh, seq, d)
    else:
        assert not any(launched.values())
    ref = attention.attention_plain(q, k, v, d ** -0.5)
    assert rel(out, ref) <= TOL[dtype]["k4"]
    # a key split merges in a fixed order: two calls give the same bits
    assert torch.equal(out, attention.attention(q, k, v, d ** -0.5))


def test_k4_plan_matches_the_cpu_emulation(gen):
    """The C library's plan is the one tests/torch_port_attention_plan.py
    mirrors, on this card's SM count."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for bh, seq, d in K4_CASES + [(8, 4096, 512), (2, 4096, 512),
                                  (1, 16384, 256), (8, 64, 512)]:
        assert attention.fwd_plan(bh, seq, d) == plan_mirror.fwd_plan(
            bh, seq, d, sms), (bh, seq, d)


# K5 / K6 shapes: every bf16 class of both (head_dim 64, 128, 256, 512 and
# under their widths: 80, 192, 384), with and without a split of the
# streamed tiles (4x256x512, 2x1024x512, 4x700x128, 1x2048x256), ragged
# lengths, the 16->128 train step's shapes at batch 4 and 16, and 8x16x256
BWD_CASES = [(4, 256, 512), (4, 64, 512), (3, 100, 64), (2, 4096, 512),
             (1, 16384, 256), (8, 256, 128), (2, 300, 192), (2, 100, 80),
             (8, 16, 256), (2, 1024, 512), (4, 700, 128), (1, 2048, 256),
             (2, 130, 384), (16, 256, 512), (16, 64, 512), (2, 1000, 512)]


def _bwd_launched(bh, seq, d):
    """K5's and K6's bf16 launches the mirror's plans expect for one
    attention_bwd."""
    want = {name: 0 for name in attention.BWD_TILES}
    for kernel in (0, 1):
        p = plan_mirror.bwd_plan(bh, seq, d, kernel)
        want[attention.BWD_TILES[4 * kernel + p["cls"]]] += 1
        want["merge"] += int(p["splits"] > 1)
    return want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,seq,d", BWD_CASES)
def test_k4_lse_k5_k6_match_plain(gen, dtype, bh, seq, d):
    q, k, v = (torch.randn(bh, seq, d, device="cuda", generator=gen)
               .to(dtype) for _ in range(3))
    g = torch.randn(bh, seq, d, device="cuda", generator=gen)
    n = (attention.counter.n, attention.dkv_counter.n, attention.dq_counter.n)
    o, lse = attention.attention_fwd(q, k, v, d ** -0.5)
    ref_o, ref_lse = attention.attention_fwd_plain(q, k, v, d ** -0.5)
    assert rel(o, ref_o) <= TOL[dtype]["k4"]
    assert rel(lse, ref_lse) <= TOL[dtype]["lse"]
    dsum = (g * o).sum(-1)
    attention.bwd_tile_launches(reset=True)
    grads = attention.attention_bwd(q, k, v, g, lse, dsum, d ** -0.5)
    launched = attention.bwd_tile_launches(reset=True)
    if dtype == torch.bfloat16:
        assert launched == _bwd_launched(bh, seq, d)
    else:
        assert not any(launched.values())
    refs = attention.attention_bwd_plain(q, k, v, g, lse, dsum, d ** -0.5)
    assert (attention.counter.n, attention.dkv_counter.n,
            attention.dq_counter.n) == (n[0] + 1, n[1] + 1, n[2] + 1)
    for out, ref, kernel in zip(grads, refs, ("k6", "k5", "k5")):
        assert out.dtype == torch.float32
        assert rel(out, ref) <= TOL[dtype][kernel]


@pytest.mark.parametrize("bh,seq,d", [(4, 256, 512), (2, 1024, 512),
                                      (1, 2048, 256), (4, 700, 128),
                                      (2, 4096, 512), (8, 16, 256)])
def test_k5_k6_two_calls_bit_identical(gen, bh, seq, d):
    """The bf16 routes sum in a fixed order, splits and merges included:
    two calls on the same inputs give the same bits of dq, dk and dv."""
    q, k, v = (torch.randn(bh, seq, d, device="cuda", generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    g = torch.randn(bh, seq, d, device="cuda", generator=gen)
    o, lse = attention.attention_fwd(q, k, v, d ** -0.5)
    dsum = (g * o).sum(-1)
    first = attention.attention_bwd(q, k, v, g, lse, dsum, d ** -0.5)
    second = attention.attention_bwd(q, k, v, g, lse, dsum, d ** -0.5)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)


def test_bwd_plan_matches_the_cpu_emulation(gen):
    """The C library's K5 and K6 plans are the ones
    tests/torch_port_attention_plan.py mirrors, on this card's SM count."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for bh, seq, d in BWD_CASES + [(8, 1024, 512), (8, 4096, 512),
                                   (1, 77, 16), (5, 1000, 512)]:
        for kernel in (0, 1):
            assert attention.bwd_plan(bh, seq, d, kernel) == \
                plan_mirror.bwd_plan(bh, seq, d, kernel, sms), \
                (bh, seq, d, kernel)


def _function_case(gen, op, dtype):
    """(wrapper call, plain call, inputs) of one autograd Function."""
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    if op == "k1":
        args, kw = _k1_inputs(gen, dtype, 2, 64, 64, 16, 16, True)
        kw.pop("pre_scale")
        inputs = [args[0], args[1], args[2], args[3], args[4], kw["pre_bias"],
                  kw["residual"]]
        call = lambda f, t: f(*t[:5], 8, pre_bias=t[5], residual=t[6])
        return call, conv_fused.gn_silu_conv3x3, \
            conv_fused.gn_silu_conv3x3_plain, inputs
    if op == "k1_post":
        args, kw = _k1_inputs(gen, dtype, 2, 64, 64, 16, 16, True)
        inputs = [*args[:5], 0.3 * r(2, 64), 0.5 * r(2, 64), kw["residual"]]
        call = lambda f, t: f(*t[:5], 8, post_scale=t[5], post_shift=t[6],
                              residual=t[7])
        return call, conv_fused.gn_silu_conv3x3, \
            conv_fused.gn_silu_conv3x3_plain, inputs
    if op == "k2":
        x = (3 * r(2, 96, 12, 12) + 1).to(dtype).contiguous(memory_format=CL)
        inputs = [x, 1 + 0.2 * r(96), 0.1 * r(96)]
        call = lambda f, t: f(*t, 8, swish=True)
        return call, groupnorm.group_norm, groupnorm.group_norm_plain, inputs
    inputs = [r(2, 100, 64).to(dtype) for _ in range(3)]
    call = lambda f, t: f(*t, 0.125)
    return call, attention.attention, attention.attention_plain, inputs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["k1", "k2", "k4", "k1_post"])
def test_autograd_functions_match_plain_autograd(gen, op, dtype):
    call, wrapper, plain, inputs = _function_case(gen, op, dtype)
    grads = []
    for f in (wrapper, plain):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        out = call(f, leaves)
        w = torch.randn(out.shape, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(1))
        (out.float() * w).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, ref in zip(*grads):
        assert got.dtype == ref.dtype
        assert rel(got, ref) <= TOL[dtype]["grad"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_statistics_route_function_matches_plain_autograd(gen, dtype):
    x = (3 * torch.randn(2, 64, 256, 256, device="cuda", generator=gen) + 1)
    inputs = [x.to(dtype).contiguous(memory_format=CL),
              1 + 0.2 * torch.randn(64, device="cuda", generator=gen),
              0.1 * torch.randn(64, device="cuda", generator=gen)]
    grads = []
    for f in (groupnorm.group_norm, groupnorm.group_norm_plain):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        out = f(*leaves, 16, swish=True)
        w = torch.randn(out.shape, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(1))
        (out.float() * w).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, ref in zip(*grads):
        assert got.dtype == ref.dtype
        assert rel(got, ref) <= TOL[dtype]["grad"]


# bf16 dx of the GroupNorm backward: both sides compute in float32 from the
# same bf16 inputs and round dx once, so they differ by at most one bf16
# step, 2^-7 of an element (7.8e-3 of max|plain| at most). chip_smoke.py
# read at most 3.3e-3 for dx and 2.2e-3 for act at the same seven shapes
# on an H100
GN_BWD_BF16_TOL = 8e-3


def _bwd_inputs(gen, dtype, b, c, hw, pre=False):
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    x = (3 * r(b, c, hw, hw) + 1).to(dtype).contiguous(memory_format=CL)
    dy = r(b, c, hw, hw).to(dtype).contiguous(memory_format=CL)
    affine = dict(pre_scale=1 + 0.3 * r(b, c), pre_bias=0.5 * r(b, c)) \
        if pre else {}
    return x, dy, 1 + 0.2 * r(c), 0.1 * r(c), affine


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,hw,groups,swish,pre,given", [
    # the main path's shapes: K2 at 16->128 (and K1's 192-channel input),
    # its smallest maps, the 512^2 statistics route, a 1024^2 map
    (128, 192, 128, 32, True, False, False),
    (128, 512, 8, 32, True, False, True),
    (16, 64, 512, 16, True, False, True),
    (2, 64, 1024, 32, True, False, False),
    # swish off (the attention pre-norm), K1's pre-affine, a ragged map
    (4, 512, 16, 32, False, False, False),
    (2, 64, 32, 32, True, True, True),
    (3, 96, 10, 8, True, True, False),
])
def test_gn_bwd_kernel_matches_plain(gen, dtype, b, c, hw, groups, swish,
                                     pre, given):
    """dx, dgamma, dbeta (and the pre-affine's gradients) of the backward
    kernel against gn_silu_bwd_plain, with the statistics taken by the
    kernel or given (by gn_silu_act's launches, as K1 gives them)."""
    x, dy, s, t, affine = _bwd_inputs(gen, dtype, b, c, hw, pre)
    stats = None
    if given:
        n = groupnorm.act_counter.n
        act, stats = groupnorm.gn_silu_act(x, s, t, groups, **affine)
        assert groupnorm.act_counter.n == n + 1
        ref_act, ref_stats = groupnorm.gn_silu_act_plain(x, s, t, groups,
                                                         **affine)
        assert rel(act, ref_act) <= (TOL[dtype]["k2"]
                                     if dtype == torch.float32
                                     else GN_BWD_BF16_TOL)
        for got, ref in zip(stats, ref_stats):
            assert rel(got, ref) <= 1e-5
    n = groupnorm.bwd_counter.n
    got = groupnorm.gn_silu_bwd(x, dy, s, t, groups, swish=swish, stats=stats,
                                **affine)
    assert groupnorm.bwd_counter.n == n + 1
    want = groupnorm.gn_silu_bwd_plain(x, dy, s, t, groups, swish=swish,
                                       stats=stats, **affine)
    assert got[0].dtype == dtype and got[0].is_contiguous(memory_format=CL)
    tol = {torch.float32: 1e-4, torch.bfloat16: GN_BWD_BF16_TOL}[dtype]
    for name, g, w in zip(["dx", "dgamma", "dbeta", "dpre_scale",
                           "dpre_bias"], got, want):
        assert (g is None) == (w is None), name
        if g is not None:
            assert rel(g, w) <= (tol if name == "dx" else 1e-4), name


@pytest.mark.parametrize("b,c,hw,groups", [(16, 64, 512, 16),
                                           (2, 64, 1024, 32),
                                           (128, 512, 8, 32)])
def test_gn_bwd_two_calls_bit_identical(gen, b, c, hw, groups):
    """Slices split over pixels and folded (16 blocks a slice at 16x64x512^2
    and 132 at 2x64x1024^2 on a 132-SM H100), one block a slice at 8^2:
    every output the same bits twice."""
    x, dy, s, t, _ = _bwd_inputs(gen, torch.bfloat16, b, c, hw)
    one, two = (groupnorm.gn_silu_bwd(x, dy, s, t, groups) for _ in range(2))
    assert torch.equal(one[0].view(torch.int16), two[0].view(torch.int16))
    for a, b_ in zip(one[1:3], two[1:3]):
        assert torch.equal(a.view(torch.int32), b_.view(torch.int32))


def _config_net(name):
    """The UNet of portbench's configuration ``name`` in training mode, on
    the card, with its image size."""
    import json
    import os

    from sr3_tpu_torch.models.networks import define_G

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "portbench", "configs", name + ".json")) as f:
        opt = json.load(f)["opt"]
    opt["phase"] = "train"
    diffusion = define_G(opt, device="cuda")
    return diffusion.denoise_fn.train(), opt["model"]["diffusion"][
        "image_size"]


@pytest.mark.parametrize("name,calls,k1", [("sr3_16_128", 61, 28),
                                           ("sr3_64_512", 36, None)])
def test_gn_bwd_calls_a_train_step_and_no_k1_statistics(gen, name, calls, k1):
    """One train step (forward, backward) of each benchmark configuration
    at batch 1 calls the backward kernel's wrapper once per K1 and K2 call
    (16->128: 28 K1 + 33 K2), no plain backward, and launches K1's
    statistics kernel in the backward only where remat replays the forward
    (at most as often as in that forward)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    net, size = _config_net(name)
    x = torch.randn(1, net.in_channel, size, size, device="cuda",
                    generator=gen).contiguous(memory_format=CL)
    level = torch.tensor([0.5], device="cuda")

    def stats_launches(prof):
        return sum(1 for e in prof.profiler.kineto_results.events()
                   if e.device_type() != DeviceType.CPU
                   and "gn_stats_kernel" in e.name())

    n, a = groupnorm.bwd_counter.n, groupnorm.act_counter.n
    with profile(activities=[ProfilerActivity.CUDA]) as fwd:
        out = net(x, level, generator=gen)
        torch.cuda.synchronize()
    loss = out.float().square().mean()
    with profile(activities=[ProfilerActivity.CUDA]) as bwd:
        loss.backward()
        torch.cuda.synchronize()
    assert groupnorm.bwd_counter.n - n == calls
    if k1 is not None:
        assert groupnorm.act_counter.n - a == k1
    if net.remat:
        assert 0 < stats_launches(bwd) <= stats_launches(fwd)
    else:
        assert stats_launches(bwd) == 0 < stats_launches(fwd)
    assert all(p.grad is not None for p in net.parameters())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unet_every_parameter_gets_a_gradient_on_cuda(gen, dtype):
    """Each kernel's autograd Function hands gradients back to the conv,
    norm, FiLM, attention and noise-MLP parameters."""
    net = UNet(in_channel=6, out_channel=3, inner_channel=16, norm_groups=8,
               channel_mults=(1, 2), attn_res=(8,), res_blocks=1, dropout=0.2,
               image_size=16, dtype=dtype)
    net = net.to(device="cuda", memory_format=CL).train()
    x = torch.randn(2, 6, 16, 16, device="cuda", generator=gen)
    before = [c.n for c in (conv_fused.counter, groupnorm.counter,
                            attention.counter, attention.dkv_counter,
                            attention.dq_counter)]
    out = net(x, torch.tensor([0.3, 0.8], device="cuda"), generator=gen)
    out.square().mean().backward()
    after = [c.n for c in (conv_fused.counter, groupnorm.counter,
                           attention.counter, attention.dkv_counter,
                           attention.dq_counter)]
    assert all(a > b for a, b in zip(after, before)), (before, after)
    for name, p in net.named_parameters():
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0, name


def _adm_opt(**unet):
    import json
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "portbench", "configs",
                           "adm_128_512.json")) as f:
        opt = json.load(f)["opt"]
    opt["model"]["unet"].update(unet)
    return opt


def test_adm_forward_launches_k1_at_every_site_of_the_reference(gen):
    """One bf16 forward of the 128->512 ADM at batch 1: K1 runs once at each
    site of the benchmark reference's list (every ResBlock's out_layers with
    the scale-shift, the in_layers of the non-resampling ones, the head) and
    every out_layers takes K1's scale-shift route."""
    from portbench.reference import adm as ref
    from sr3_tpu_torch.models import adm_unet

    opt = _adm_opt()
    with torch.device("cuda"):
        net = adm_unet.adm_from_opt(opt["model"], torch.bfloat16)
    net = net.to(memory_format=CL).eval()
    x = torch.randn(1, 3, 512, 512, device="cuda", generator=gen)
    low = torch.rand(1, 3, 128, 128, device="cuda", generator=gen) * 2 - 1
    k1, ss = conv_fused.counter.n, adm_unet.scale_shift_blocks.n
    with torch.inference_mode():
        out = net(x, torch.tensor([999], device="cuda"), low,
                  torch.tensor([7], device="cuda"))
    sites = ref.k1_sites(opt, 1)
    assert conv_fused.counter.n - k1 == len(sites) == 75
    assert adm_unet.scale_shift_blocks.n - ss == sum(s["post"]
                                                     for s in sites) == 42
    assert out.shape == (1, 6, 512, 512) and torch.isfinite(out).all()


def test_adm_float32_forward_matches_the_cpu(gen):
    """A small ADM in float32: the kernels' forward on the card against the
    plain versions' on the CPU, 1e-4 of max|CPU|."""
    from sr3_tpu_torch.models import adm_unet

    opt = _adm_opt(inner_channel=64, channel_multiplier=[1, 2],
                   attn_res=[16], res_blocks=1, num_head_channels=64)
    opt["model"]["diffusion"]["image_size"] = 32
    torch.manual_seed(0)
    net = adm_unet.adm_from_opt(opt["model"], torch.float32)
    net = net.to(memory_format=CL).eval()
    x, low = torch.randn(2, 3, 32, 32), torch.rand(2, 3, 8, 8) * 2 - 1
    t, y = torch.tensor([3, 500]), torch.tensor([1, 999])
    with torch.inference_mode():
        want = net(x, t, low, y)
        net = net.cuda()
        got = net(x.cuda(), t.cuda(), low.cuda(), y.cuda())
    assert rel(got, want.cuda()) <= 1e-4


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


def test_device_prefetch_on_the_card(gen):
    """device_prefetch's CUDA route (pinned memory, a side stream, a wait
    event): each batch lands on the card in feed_data's layout, in order,
    with its other values, equal to the host arrays."""
    import numpy as np

    from sr3_tpu_torch.data.prefetch import device_prefetch

    rng = np.random.default_rng(0)
    batches = [{"HR": rng.standard_normal((4, 32, 24, 3)).astype(np.float32),
                "_epoch": i // 2} for i in range(6)]
    out = list(device_prefetch(iter(batches), "cuda", size=2))
    assert [b["_epoch"] for b in out] == [b["_epoch"] for b in batches]
    for b, src in zip(out, batches):
        x = b["HR"]
        assert x.is_cuda and x.dtype == torch.float32
        assert x.is_contiguous(memory_format=CL) and x.shape == (4, 3, 32, 24)
        # read on the consumer's stream, as the trainer does
        assert np.array_equal((x * 1).permute(0, 2, 3, 1).cpu().numpy(),
                              src["HR"])


def test_device_prefetch_pins_off_the_consumer_thread(gen, monkeypatch):
    """The pinning runs on device_prefetch's own thread, the batches are
    pulled on the consumer's; an error while pinning is raised in the
    consumer; closing the generator early ends the thread."""
    import threading

    import numpy as np

    from sr3_tpu_torch.data import prefetch

    pinned_on, pulled_on = set(), set()
    pin = prefetch._pinned

    def recorded(batch):
        pinned_on.add(threading.get_ident())
        return pin(batch)

    monkeypatch.setattr(prefetch, "_pinned", recorded)

    def source(n, bad=None):
        for i in range(n):
            pulled_on.add(threading.get_ident())
            x = np.full((2, 8, 8, 3), i, np.float32)
            yield {"HR": np.full(x.shape, "?", object) if i == bad else x}

    before = threading.active_count()
    it = prefetch.device_prefetch(source(6), "cuda", size=2)
    assert float(next(it)["HR"].sum()) == 0
    it.close()
    assert threading.active_count() == before
    assert pulled_on == {threading.get_ident()}
    assert pinned_on and threading.get_ident() not in pinned_on
    with pytest.raises(ValueError):
        list(prefetch.device_prefetch(source(4, bad=2), "cuda", size=1))
    assert threading.active_count() == before


def test_spans_time_the_stream_and_add_no_device_activity(gen):
    """A span's device ms is its stream's time between its two events; the
    events come back to the pool once read, none are recorded while the
    stream is captured, and the profiler sees the same device activities
    with the spans as without."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sr3_tpu_torch.utils import profiler

    a = torch.randn(2048, 2048, device="cuda", generator=gen)

    def work(with_spans):
        for _ in range(4):
            if with_spans:
                with profiler.span("chain.step", a, t=0):
                    a @ a
            else:
                a @ a
        torch.cuda.synchronize()

    def device_events(with_spans):
        work(with_spans)  # warm
        profiler.reset_spans()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            work(with_spans)
        return sorted(e.name() for e in prof.profiler.kineto_results.events()
                      if e.device_type() != DeviceType.CPU)

    without = device_events(False)
    assert device_events(True) == without
    recorded = profiler.spans()
    assert len(recorded) == 4
    ms = [s.device_ms for s in recorded]
    assert all(t > 0 for t in ms), ms
    pool = profiler._event_pool[torch.cuda.current_device()]
    n = len(pool)
    assert n >= 2
    with profile(activities=[ProfilerActivity.CPU]):
        with profiler.span("chain.step", a) as s:
            assert len(pool) == n - 2  # the pair is reused
            a @ a
        assert s.device_ms > 0 and len(pool) == n
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            with profiler.span("chain.step", a) as captured:
                a @ a
    assert captured.device_ms is None
    profiler.reset_spans()
