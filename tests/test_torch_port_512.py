"""The port's SR3 64->512 training path on the CPU against the JAX package.

A tiny UNet shaped like configs/sr_sr3_64_512_attn.json (five levels, mults
1-2-4-8-8, 1 res block, attention at 32x32, dropout 0.2) at image 256, so
that the dropout Blocks of the top level see a 256^2 map and take the
GroupNorm statistics route (kernel K3's plain version on the CPU), while
the mid block stays at 16x16; inner_channel 8 and 4 norm groups keep it
small. The JAX package builds and initialises it, its 1-D parameters are
perturbed from a numpy seed, and the port loads it through its own
``build_key_map`` with a strict state_dict load. Both sides get the same
numpy inputs, noise, sqrt-gamma and dropout masks (each side's mask draw is
replaced by numpy masks handed out in call order).

Tolerances: forward atol 1e-4 (float32 through ~30 layers); the train
step's loss rtol 1e-5 and every gradient within 1e-4 of its max|grad| (as
tests/test_torch_port_train.py); remat on against remat off in the port
atol 1e-6 (the same float32 operations on the same values).
"""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr3_tpu.models.unet as jax_unet
import sr3_tpu.utils.torch_compat as jax_compat
from sr3_tpu.data.lrhr import LRHRDataset as JaxLRHRDataset
from sr3_tpu.models.networks import define_G as jax_define_G
from sr3_tpu.models.networks import init_params
from sr3_tpu.models.schedule import make_schedule as jax_make_schedule
from sr3_tpu_torch.data.loader import create_dataset
from sr3_tpu_torch.models import unet as port_unet
from sr3_tpu_torch.models.networks import count_params, define_G
from sr3_tpu_torch.ops import dropout as port_dropout
from sr3_tpu_torch.ops import groupnorm
from sr3_tpu_torch.utils import torch_compat

from test_torch_port_train import _JAX_MASKS, MaskFeed, jax_dropout

SCHED = {"schedule": "linear", "n_timestep": 10, "linear_start": 1e-6,
         "linear_end": 1e-2}
IMAGE = 256
FIXTURES = "dataset/fixtures_64_512"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_opt(remat=False):
    return {
        "name": "tiny512", "phase": "train", "seed": 0,
        "path": {"resume_state": None},
        "model": {
            "which_model_G": "sr3", "dtype": "float32",
            "unet": {"in_channel": 6, "out_channel": 3, "inner_channel": 8,
                     "norm_groups": 4, "channel_multiplier": [1, 2, 4, 8, 8],
                     "attn_res": [32], "res_blocks": 1, "dropout": 0.2,
                     "remat": remat},
            "beta_schedule": {"train": dict(SCHED), "val": dict(SCHED)},
            "diffusion": {"image_size": IMAGE, "channels": 3,
                          "conditional": True},
        },
        "train": {"optimizer": {"type": "adam", "lr": 1e-4}},
    }


@functools.lru_cache(maxsize=None)
def jax_model():
    """JAX diffusion + perturbed parameters (numpy leaves; not mutated)."""
    diffusion = jax_define_G(tiny_opt())
    params = jax.tree_util.tree_map(
        np.asarray, init_params(diffusion, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(200)
    params = jax.tree_util.tree_map(
        lambda p: (p + 0.1 * rng.standard_normal(p.shape)).astype(np.float32)
        if p.ndim == 1 else p, params)
    return diffusion, params


def port_diffusion(remat=False):
    diffusion = define_G(tiny_opt(remat), device="cpu")
    torch_compat.load_flax_params(diffusion.denoise_fn, jax_model()[1])
    return diffusion


def test_weights_carry_through_the_ports_key_map():
    """The port's build_key_map names every parameter of the 64->512-shaped
    UNet: a strict load, and the counts agree."""
    net = port_diffusion().denoise_fn
    _, params = jax_model()
    assert count_params(net) == sum(
        p.size for p in jax.tree_util.tree_leaves(params))
    keys = [k for _, k, _ in torch_compat.build_key_map(
        **torch_compat.unet_key_config(net))]
    assert sorted(keys) == sorted(net.state_dict())


def test_flax_export_equals_the_jax_packages():
    _, params = jax_model()
    cfg = torch_compat.unet_key_config(port_diffusion().denoise_fn)
    ours = torch_compat.flax_params_to_torch_state_dict(params, **cfg)
    ref = jax_compat.flax_params_to_torch_state_dict(params, **cfg)
    assert list(ours) == list(ref)
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        np.testing.assert_array_equal(ours[k], v, err_msg=k)


def test_forward_matches_jax_unet():
    diffusion, params = jax_model()
    net = port_diffusion().denoise_fn.eval()
    rng = np.random.default_rng(201)
    x = rng.standard_normal((1, IMAGE, IMAGE, 6)).astype(np.float32)
    cond = np.asarray([0.6], np.float32)
    ref = jax.jit(functools.partial(diffusion.denoise_fn.apply, train=False))(
        params, x, cond)
    with torch.inference_mode():
        out = net(torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(cond))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=1e-4, rtol=0)


def test_train_step_loss_and_gradients_match_jax(monkeypatch):
    """One p_losses + backward on the same batch, noise, sqrt-gamma and
    masks; the port's dropout Blocks at 256^2 take the statistics route."""
    diffusion, params = jax_model()
    port = port_diffusion()
    net = port.denoise_fn.train()
    feed = MaskFeed(202)
    monkeypatch.setattr(port_dropout, "dropout_mask", feed.port_mask)
    monkeypatch.setattr(jax_unet, "dropout", jax_dropout)
    route = []
    stats = groupnorm.group_norm_stats

    def recording_stats(x, *a, **k):
        route.append(tuple(x.shape))
        return stats(x, *a, **k)

    monkeypatch.setattr(groupnorm, "group_norm_stats", recording_stats)

    rng = np.random.default_rng(203)
    b = 1
    data = {k: rng.uniform(-1, 1, (b, IMAGE, IMAGE, 3)).astype(np.float32)
            for k in ("HR", "SR")}
    noise = rng.standard_normal((b, IMAGE, IMAGE, 3)).astype(np.float32)
    gamma = np.asarray([[0.8]], np.float32)
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    sched = port_sched()
    loss_t = port.p_losses(net, sched, {k: nchw(v) for k, v in data.items()},
                           injected={"noise": nchw(noise),
                                     "sqrt_gamma": torch.from_numpy(gamma)})
    loss_t.backward()
    # one mask per ResnetBlock's block2 (5 down, 2 mid, 10 up); the three
    # on 256^2 maps take the statistics route
    assert len(feed.drawn) == 17
    assert route == [(b, 8, IMAGE, IMAGE)] * 3

    jbatch = {k: jnp.asarray(v) for k, v in data.items()}

    @jax.jit
    def loss_and_grads(p, masks):
        _JAX_MASKS[:] = [iter(masks)]
        return jax.value_and_grad(lambda q: diffusion.p_losses(
            q, jax_make_schedule(SCHED), jbatch, jax.random.PRNGKey(0),
            train=True, injected={"noise": noise, "sqrt_gamma": gamma}))(p)

    loss_j, grads = loss_and_grads(params, feed.drawn)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    ref = torch_compat.strip_reference_keys(
        torch_compat.flax_params_to_torch_state_dict(
            jax.tree_util.tree_map(np.asarray, grads),
            **torch_compat.unet_key_config(net)))
    for name, p in net.named_parameters():
        r = ref[name]
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max(), err_msg=name)


def port_sched():
    from sr3_tpu_torch.models.schedule import make_schedule

    return make_schedule(SCHED, "cpu")


def _loss_and_grads(diffusion, seed):
    net = diffusion.denoise_fn.train()
    net.zero_grad(set_to_none=True)
    g = torch.Generator().manual_seed(seed)
    hr = torch.rand(2, 3, IMAGE, IMAGE, generator=g) * 2 - 1
    loss = diffusion.p_losses(net, port_sched(), {"HR": hr, "SR": hr.flip(3)},
                              g)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in net.named_parameters()}, g


def test_remat_equals_no_remat_and_replays_the_dropout_draws(monkeypatch):
    """The same generator seed gives the same loss and gradients with remat
    on and off, and leaves the generator in the same state; every block's
    forward runs again in the backward. A checkpoint that let the recompute
    draw fresh masks would change the gradients."""
    on, off = port_diffusion(remat=True), port_diffusion(remat=False)
    calls = []
    block = on.denoise_fn.downs[1]
    block.register_forward_pre_hook(lambda *a: calls.append(1))
    loss_on, grads_on, g_on = _loss_and_grads(on, 204)
    assert len(calls) == 2  # the forward and its recompute
    loss_off, grads_off, g_off = _loss_and_grads(off, 204)
    torch.testing.assert_close(loss_on, loss_off, rtol=0, atol=1e-6)
    for name, g in grads_off.items():
        torch.testing.assert_close(grads_on[name], g, rtol=0, atol=1e-6,
                                   msg=name)
    assert torch.equal(g_on.get_state(), g_off.get_state())

    def fresh_draws(layer, x, emb, generator=None):
        return torch.utils.checkpoint.checkpoint(layer, x, emb, generator,
                                                 use_reentrant=False)

    monkeypatch.setattr(port_unet, "remat_block", fresh_draws)
    _, grads_naive, _ = _loss_and_grads(on, 204)
    worst = max((grads_naive[n] - g).abs().max().item()
                for n, g in grads_off.items())
    assert worst > 1e-3


@pytest.mark.parametrize("phase,mode", [("train", "HR"), ("val", "LRHR")])
def test_dataset_items_equal_the_jax_packages(phase, mode):
    """The port's LRHRDataset (through create_dataset) gives the JAX
    package's items, flips included, from the same ``random`` seed."""
    opt = {"name": "fix", "dataroot": FIXTURES, "datatype": "img",
           "l_resolution": 64, "r_resolution": 512, "mode": mode,
           "data_len": -1}
    ours = create_dataset(opt, phase)
    ref = JaxLRHRDataset(FIXTURES, "img", 64, 512, split=phase,
                         need_LR=mode == "LRHR")
    assert len(ours) == len(ref) == 4
    for i in range(len(ref)):
        random.seed(300 + i)
        a = ours[i]
        random.seed(300 + i)
        r = ref[i]
        assert set(a) == set(r)
        assert a["Index"] == r["Index"] == i
        for k in set(r) - {"Index"}:
            assert a[k].dtype == np.float32 and a[k].shape == r[k].shape
            np.testing.assert_array_equal(a[k], r[k], err_msg=k)
