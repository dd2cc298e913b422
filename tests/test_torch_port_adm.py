"""guided-diffusion's ADM super-resolution model on the port
(``models/adm_unet.py``, the scale-shift route of K1's plain version, the
respaced schedule and the learned-variance step) against the benchmark's
plain float32 reference (``portbench/reference/adm.py``) on the CPU, at a
tiny width with seeded random weights.

Tolerances, relative to max|reference| unless said otherwise, all float32
with TF32 off: the forward 1e-4 (the port's convs run channels_last and
its GroupNorm takes one-pass statistics, the reference's F.group_norm two
passes: float32 sums in another order, compounded over ~20 layers); K1's
scale-shift route and its gradients 1e-5 (one layer: only the order of the
GroupNorm and conv sums differs); a step and a 10-step chain through the
trainer 5e-4 (the network's gap passed through 1/sqrt(abar) into x0 and
compounded over the steps).
"""

import numpy as np
import pytest
import torch

from portbench.kinds import adm_sample
from portbench.reference import adm as ref
from portbench.inputs import load_weights
from sr3_tpu_torch.models import adm_unet
from sr3_tpu_torch.models.diffusion import GaussianDiffusion, SRCondition
from sr3_tpu_torch.models.schedule import make_schedule, space_timesteps
from sr3_tpu_torch.ops import conv_fused
from torch_port_adm_tiny import tiny_opt

CL = torch.channels_last
SEED = 2 ** 33 + 17


def rel(got, want):
    return float((got.float() - want).abs().max() / want.abs().max())


@pytest.fixture(scope="module")
def nets():
    opt = tiny_opt()
    weights = adm_sample.adm_weights(opt, SEED, "cpu")
    port = adm_unet.adm_from_opt(opt["model"], torch.float32)
    load_weights(port, weights)
    reference = ref.build(opt)
    load_weights(reference, weights)
    return opt, port.to(memory_format=CL).eval(), reference


def _inputs(b=3, size=16, low=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, 3, size, size, generator=g)
    lr = torch.rand(b, 3, low, low, generator=g) * 2 - 1
    return x, lr, torch.tensor([999, 4, 0][:b]), torch.tensor([3, 0, 1][:b])


def test_unet_forward_matches_the_reference(nets):
    _, port, reference = nets
    x, lr, t, y = _inputs()
    with torch.no_grad():
        got = port(x, t, lr, y)
        want = reference(x, t, lr, y)
    assert got.shape == (3, 6, 16, 16) and got.dtype == torch.float32
    assert rel(got, want) <= 1e-4
    # the labels and the timestep reach the output
    with torch.no_grad():
        assert rel(port(x, t, lr, y.flip(0)), want) > 1e-3
        assert rel(port(x, t.flip(0), lr, y), want) > 1e-3


def test_k1_scale_shift_plain_route_matches_the_reference():
    """K1's scale-shift route against the reference's out_layers
    composition: output and the gradients of x, the GroupNorm affine, the
    scale, the shift, the conv weight and bias."""
    g = torch.Generator().manual_seed(5)
    r = lambda *s: torch.randn(*s, generator=g)
    b, c, h = 2, 64, 8
    block = ref.ResBlock(c, 16)
    norm, conv = block.out_layers[0], block.out_layers[3]
    leaves = [r(b, c, h, h), 1 + 0.1 * r(c), 0.1 * r(c), 0.3 * r(b, c),
              0.5 * r(b, c), r(c, c, 3, 3) / 24, 0.1 * r(c)]
    w = r(b, c, h, h)
    grads = []
    for side in ("port", "reference"):
        ts = [t.clone().requires_grad_() for t in leaves]
        x, gw, gb, s, sh, cw, cb = ts
        if side == "port":
            out = conv_fused.gn_silu_conv3x3(
                x.contiguous(memory_format=CL), gw, gb,
                cw.contiguous(memory_format=CL), cb, 32, post_scale=s,
                post_shift=sh)
        else:
            norm.weight, norm.bias = torch.nn.Parameter(gw), \
                torch.nn.Parameter(gb)
            z = ref.norm(norm, x) * (1 + s[:, :, None, None]) \
                + sh[:, :, None, None]
            out = torch.nn.functional.conv2d(torch.nn.functional.silu(z),
                                             cw, cb, padding=1)
            gw, gb = norm.weight, norm.bias
            ts[1:3] = [gw, gb]
        (out * w).sum().backward()
        grads.append((out.detach(), [t.grad for t in ts]))
    (got, dgot), (want, dwant) = grads
    assert rel(got, want) <= 1e-5
    for a, e in zip(dgot, dwant):
        assert rel(a, e) <= 1e-5


def test_a_training_resblock_with_dropout_raises():
    """ADM training is not ported, so a ResBlock in training mode with
    dropout raises; in eval mode, or with dropout 0, it runs the scale-shift
    in ``gn_silu_conv3x3`` and counts ``block.scale_shift``."""
    g = torch.Generator().manual_seed(3)
    block = adm_unet.ResBlock(32, 16, 0.5, 64).train()
    x = torch.randn(2, 32, 8, 8, generator=g).contiguous(memory_format=CL)
    emb = torch.randn(2, 16, generator=g)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="dropout"):
        block(x, emb)
    n = adm_unet.scale_shift_blocks.n
    with torch.no_grad():
        evaluated = block.eval()(x, emb)
        block.dropout = 0.0
        trained = block.train()(x, emb)
    assert adm_unet.scale_shift_blocks.n == n + 2
    assert torch.equal(evaluated, trained)


def test_the_respaced_schedule_is_guided_diffusions():
    kept = space_timesteps(1000, "250")
    assert len(kept) == 250 and kept[:3] == [0, 4, 8] and kept[-1] == 999
    # round(i * 999 / 249), as a hand computation gives it
    assert kept == sorted({round(i * 999 / 249) for i in range(250)})
    assert kept == ref.space_timesteps(1000, 250)
    opt = tiny_opt("250")["model"]["beta_schedule"]["val"]
    ours, theirs = make_schedule(opt), ref.Schedule(opt, "cpu")
    assert ours.num_timesteps == 250
    assert torch.equal(ours.timestep_map, theirs.timestep_map)
    for a, b in (("sqrt_recip_alphas_cumprod", "sqrt_recip"),
                 ("sqrt_recipm1_alphas_cumprod", "sqrt_recipm1"),
                 ("posterior_mean_coef1", "coef1"),
                 ("posterior_mean_coef2", "coef2"), ("log_betas", "max_log")):
        np.testing.assert_allclose(getattr(ours, a), getattr(theirs, b),
                                   rtol=1e-6)
    # the learned range's lower end; step 0 adds no noise
    np.testing.assert_allclose(ours.posterior_log_variance_clipped[1:],
                               theirs.min_log[1:], rtol=1e-6)
    # the first respaced beta is the first of the 1000
    assert float(ours.betas[0]) == pytest.approx(1e-4)


def test_one_learned_variance_step_matches_the_reference(nets):
    opt, port, reference = nets
    sched_opt = opt["model"]["beta_schedule"]["val"]
    ours, theirs = make_schedule(sched_opt), ref.Schedule(sched_opt, "cpu")
    diffusion = GaussianDiffusion(port, 16, cond_mode="adm")
    x, lr, _, y = _inputs()
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
    for t in (7, 0):
        with torch.no_grad():
            got = diffusion.p_sample_step(port, ours, x, t,
                                          SRCondition(lr, y), noise=noise)
            out = ref.chain_out(reference, theirs, lr, y, x, t, ref.FP32)
            want = ref.chain_step(theirs, x, t, out, noise)
        assert rel(got, want) <= 5e-4, t


def test_a_chain_through_the_trainer_matches_the_reference(nets):
    """Trainer.test_batched with labels: T = 10 respaced steps, one
    generator an image, against the reference stepping the same draws."""
    from sr3_tpu_torch.training.trainer import Trainer

    opt, _, reference = nets
    trainer = Trainer(opt, device="cpu")
    load_weights(trainer.netG, adm_sample.adm_weights(opt, SEED, "cpu"))
    sched_opt = opt["model"]["beta_schedule"]["val"]
    trainer.set_new_noise_schedule(sched_opt, "val")
    _, lr, _, y = _inputs(b=2)
    gens = [torch.Generator().manual_seed(100 + i) for i in range(2)]
    got = trainer.test_batched(lr.permute(0, 2, 3, 1).numpy(), gens,
                               labels=y.numpy())
    theirs = ref.Schedule(sched_opt, "cpu")
    gens = [torch.Generator().manual_seed(100 + i) for i in range(2)]
    draw = lambda: torch.cat([torch.randn(1, 3, 16, 16, generator=g)
                              for g in gens])
    x = draw()
    with torch.no_grad():
        for t in range(theirs.T - 1, -1, -1):
            out = ref.chain_out(reference, theirs, lr, y, x, t, ref.FP32)
            x = ref.chain_step(theirs, x, t, out, draw() if t else None)
    assert got.shape == (2, 16, 16, 3)
    assert rel(torch.from_numpy(got), x.permute(0, 2, 3, 1)) <= 5e-4
    with pytest.raises(ValueError, match="labels"):
        trainer.netG(torch.zeros(1, 3, 16, 16), torch.zeros(1),
                     torch.zeros(1, 3, 4, 4))


def test_full_width_names_shapes_and_count():
    """The 128->512 upsampler on the meta device: guided-diffusion's state
    dict names and shapes, 308,835,270 parameters, 42 ResBlocks (5 down,
    5 up) and 11 attention blocks of 12 heads."""
    from portbench import cells

    opt = cells.config("adm_128_512")["opt"]
    with torch.device("meta"):
        net = adm_unet.adm_from_opt(opt["model"], torch.bfloat16)
    shapes = {n: tuple(p.shape) for n, p in net.named_parameters()}
    assert sum(p.numel() for p in net.parameters()) == 308_835_270
    assert shapes == {n: tuple(p.shape) for n, p in
                      ref.build(opt, "meta").named_parameters()}
    want = {
        "time_embed.0.weight": (768, 192), "time_embed.2.weight": (768, 768),
        "label_emb.weight": (1000, 768),
        "input_blocks.0.0.weight": (192, 6, 3, 3),
        "input_blocks.1.0.in_layers.2.weight": (192, 192, 3, 3),
        "input_blocks.1.0.emb_layers.1.weight": (384, 768),
        "input_blocks.3.0.out_layers.3.weight": (192, 192, 3, 3),
        "input_blocks.7.0.skip_connection.weight": (384, 192, 1, 1),
        "input_blocks.13.1.qkv.weight": (2304, 768, 1),
        "input_blocks.13.1.proj_out.weight": (768, 768, 1),
        "middle_block.1.norm.weight": (768,),
        "middle_block.2.out_layers.0.weight": (768,),
        "output_blocks.0.0.in_layers.0.weight": (1536,),
        "output_blocks.2.2.in_layers.2.weight": (768, 768, 3, 3),
        "output_blocks.8.1.out_layers.3.weight": (384, 384, 3, 3),
        "output_blocks.17.0.skip_connection.weight": (192, 384, 1, 1),
        "out.0.weight": (192,), "out.2.weight": (6, 192, 3, 3),
    }
    assert {n: shapes.get(n) for n in want} == want
    blocks = list(net.modules())
    res = [m for m in blocks if isinstance(m, adm_unet.ResBlock)]
    attn = [m for m in blocks if isinstance(m, adm_unet.AttentionBlock)]
    assert len(res) == 42 and len(attn) == 11
    assert sum(m.down for m in res) == 5 and sum(m.up for m in res) == 5
    assert {m.num_heads for m in attn} == {12}
