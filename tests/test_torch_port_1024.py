"""The port's SR3 128->1024 model (configs/sr_sr3_128_1024.json) on the CPU
against the JAX package.

A tiny UNet shaped like the config: six levels (mults 1-2-4-8-8-8), one res
block a level, attention at the lowest level (the config's 32x32 of 1024 is
1/32 of the image; here 2x2 of 64) and in the mid block, dropout 0.2, remat
on; inner_channel 8 and 4 norm groups keep it small. The JAX package builds
and initialises it, its 1-D parameters are perturbed from a numpy seed, and
the port loads it with a strict state_dict load.

Tolerances: the forward atol 1e-4 (float32 through ~25 layers); a T=10
chain's process frames atol 5e-4 (ten chained float32 UNet steps, the same
numpy noise stream on both sides); one p_losses train step with remat on,
injected noise and sqrt-gamma, and the same dropout masks, the loss within
1e-5 and every gradient within 1e-4 of its max|grad| (as
tests/test_torch_port_train.py). The dropout masks are the port's own
draws, recorded in the forward and replayed by the JAX side; the remat
recompute in the port's backward draws them again from its replayed
generator, so a mask the recompute did not replay would show in the
gradients.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr3_tpu.models.unet as jax_unet
from sr3_tpu.models.networks import define_G as jax_define_G
from sr3_tpu.models.networks import init_params
from sr3_tpu.models.schedule import make_schedule as jax_make_schedule
from sr3_tpu_torch.models.networks import count_params, define_G
from sr3_tpu_torch.models.schedule import make_schedule
from sr3_tpu_torch.models.unet import SelfAttention
from sr3_tpu_torch.ops import dropout as port_dropout
from sr3_tpu_torch.utils import torch_compat
from sr3_tpu_torch.utils.config import load_config

from test_torch_port_train import _JAX_MASKS, jax_dropout

T = 10
SCHED = {"schedule": "linear", "n_timestep": T, "linear_start": 1e-6,
         "linear_end": 1e-2}
IMAGE = 64
CONFIG = "configs/sr_sr3_128_1024.json"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_opt(remat=True):
    return {
        "name": "tiny1024", "phase": "train", "seed": 0,
        "path": {"resume_state": None},
        "model": {
            "which_model_G": "sr3", "dtype": "float32",
            "unet": {"in_channel": 6, "out_channel": 3, "inner_channel": 8,
                     "norm_groups": 4,
                     "channel_multiplier": [1, 2, 4, 8, 8, 8],
                     "attn_res": [IMAGE // 32], "res_blocks": 1,
                     "dropout": 0.2, "remat": remat},
            "beta_schedule": {"train": dict(SCHED), "val": dict(SCHED)},
            "diffusion": {"image_size": IMAGE, "channels": 3,
                          "conditional": True},
        },
        "train": {"optimizer": {"type": "adam", "lr": 3e-6}},
    }


@functools.lru_cache(maxsize=None)
def jax_model():
    """JAX diffusion + perturbed parameters (numpy leaves; not mutated)."""
    diffusion = jax_define_G(tiny_opt())
    params = jax.tree_util.tree_map(
        np.asarray, init_params(diffusion, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(300)
    params = jax.tree_util.tree_map(
        lambda p: (p + 0.1 * rng.standard_normal(p.shape)).astype(np.float32)
        if p.ndim == 1 else p, params)
    return diffusion, params


def port_diffusion(remat=True):
    diffusion = define_G(tiny_opt(remat), device="cpu")
    torch_compat.load_flax_params(diffusion.denoise_fn, jax_model()[1])
    return diffusion


nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def test_config_builds_the_91_6m_model_with_attention_at_32():
    """configs/sr_sr3_128_1024.json: 91,564,227 parameters, attention only
    at 32x32 (one down block, the mid block's first, two up blocks)."""
    opt = load_config(CONFIG)
    net = define_G(opt, device="meta").denoise_fn
    assert count_params(net) == 91_564_227
    assert net.remat and net.image_size == 1024
    attn = [m for m in net.modules() if isinstance(m, SelfAttention)]
    assert len(attn) == 4
    assert all(m.qkv.weight.shape[1] == 512 for m in attn)


def test_forward_matches_jax_unet():
    diffusion, params = jax_model()
    net = port_diffusion().denoise_fn.eval()
    assert count_params(net) == sum(
        p.size for p in jax.tree_util.tree_leaves(params))
    rng = np.random.default_rng(301)
    x = rng.standard_normal((2, IMAGE, IMAGE, 6)).astype(np.float32)
    cond = np.asarray([0.3, 0.9], np.float32)
    ref = jax.jit(functools.partial(diffusion.denoise_fn.apply, train=False))(
        params, x, cond)
    with torch.inference_mode():
        out = net(nchw(x), torch.from_numpy(cond))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=1e-4, rtol=0)


def test_chain_frames_match_jax():
    diffusion, params = jax_model()
    port = port_diffusion()
    rng = np.random.default_rng(302)
    cond = (0.5 * rng.standard_normal((2, IMAGE, IMAGE, 3))).astype(
        np.float32)
    init = rng.standard_normal((2, IMAGE, IMAGE, 3)).astype(np.float32)
    steps = rng.standard_normal((T, 2, IMAGE, IMAGE, 3)).astype(np.float32)
    jsched = jax_make_schedule(SCHED)
    ref = np.asarray(jax.jit(
        lambda p, x, ns: diffusion.p_sample_loop(
            p, jsched, x, jax.random.PRNGKey(0), continuous=True,
            noise_stream=ns))(params, cond, (init, steps)))
    ns = (nchw(init), torch.from_numpy(steps).permute(0, 1, 4, 2, 3))
    with torch.inference_mode():
        frames = port.p_sample_loop(port.denoise_fn.eval(),
                                    make_schedule(SCHED), nchw(cond),
                                    continuous=True, noise_stream=ns)
    frames = frames.permute(0, 2, 3, 1).numpy()
    assert frames.shape == ref.shape == ((1 + T) * 2, IMAGE, IMAGE, 3)
    np.testing.assert_allclose(frames, ref, atol=5e-4, rtol=0)


def test_train_step_with_remat_matches_jax(monkeypatch):
    diffusion, params = jax_model()
    port = port_diffusion(remat=True)
    net = port.denoise_fn.train()
    drawn, recording = [], [True]
    real_mask = port_dropout.dropout_mask

    def recorded_mask(x, keep, generator=None):
        m = real_mask(x, keep, generator)
        if recording[0]:
            drawn.append(m.permute(0, 2, 3, 1).numpy().copy())
        return m

    monkeypatch.setattr(port_dropout, "dropout_mask", recorded_mask)
    monkeypatch.setattr(jax_unet, "dropout", jax_dropout)
    rng = np.random.default_rng(303)
    b = 2
    data = {k: rng.uniform(-1, 1, (b, IMAGE, IMAGE, 3)).astype(np.float32)
            for k in ("HR", "SR")}
    noise = rng.standard_normal((b, IMAGE, IMAGE, 3)).astype(np.float32)
    gamma = np.asarray([[0.8], [0.55]], np.float32)
    g = torch.Generator().manual_seed(304)
    loss_t = port.p_losses(net, make_schedule(SCHED),
                           {k: nchw(v) for k, v in data.items()}, g,
                           injected={"noise": nchw(noise),
                                     "sqrt_gamma": torch.from_numpy(gamma)})
    recording[0] = False
    loss_t.backward()
    # one mask per ResnetBlock's block2: 6 down, 2 mid, 12 up
    assert len(drawn) == 20

    jbatch = {k: jnp.asarray(v) for k, v in data.items()}

    @jax.jit
    def loss_and_grads(p, masks):
        _JAX_MASKS[:] = [iter(masks)]
        return jax.value_and_grad(lambda q: diffusion.p_losses(
            q, jax_make_schedule(SCHED), jbatch, jax.random.PRNGKey(0),
            train=True, injected={"noise": noise, "sqrt_gamma": gamma}))(p)

    loss_j, grads = loss_and_grads(params, drawn)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=0,
                               atol=1e-5)
    ref = torch_compat.strip_reference_keys(
        torch_compat.flax_params_to_torch_state_dict(
            jax.tree_util.tree_map(np.asarray, grads),
            **torch_compat.unet_key_config(net)))
    for name, p in net.named_parameters():
        r = ref[name]
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max(), err_msg=name)
