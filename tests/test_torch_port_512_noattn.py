"""configs/sr_sr3_64_512.json, the reference's own 512^2 config, in the port
on the CPU against the JAX package.

The config's structure as it stands (image 512, five levels 1-2-4-8-8, one
res block, 16 norm groups, no attention but the mid block's, remat,
dropout 0.2) at a narrow width: inner_channel 16. The JAX package builds
and initialises it, its 1-D parameters are perturbed from a numpy seed, and
the port loads it through ``torch_compat`` (a strict load).

Tolerances: the forward within 1e-4 of the JAX package's (float32 through
~30 layers, as tests/test_torch_port_512.py); remat on against remat off in
the port, the same seed and dropout draws: the loss within 1e-5 and every
gradient within 1e-5 of its max|grad| (the same float32 operations).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from sr3_tpu.models.networks import define_G as jax_define_G
from sr3_tpu.models.networks import init_params
from sr3_tpu.utils.config import dict_to_nonedict, load_json_with_comments
from sr3_tpu_torch.models.networks import count_params, define_G
from sr3_tpu_torch.models.schedule import make_schedule
from sr3_tpu_torch.models.unet import SelfAttention
from sr3_tpu_torch.ops.groupnorm import STATS_MIN_HW
from sr3_tpu_torch.utils import torch_compat

CONFIG = "configs/sr_sr3_64_512.json"
IMAGE = 512


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def narrow_opt():
    opt = load_json_with_comments(CONFIG)
    opt["model"]["unet"]["inner_channel"] = 16
    opt["model"]["dtype"] = "float32"
    opt["path"]["resume_state"] = None
    return dict_to_nonedict(opt)


@functools.lru_cache(maxsize=None)
def jax_model():
    """JAX diffusion + perturbed parameters (numpy leaves; not mutated)."""
    diffusion = jax_define_G(narrow_opt())
    params = jax.tree_util.tree_map(
        np.asarray, init_params(diffusion, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(300)
    params = jax.tree_util.tree_map(
        lambda p: (p + 0.1 * rng.standard_normal(p.shape)).astype(np.float32)
        if p.ndim == 1 else p, params)
    return diffusion, params


def port_diffusion(remat=True):
    opt = narrow_opt()
    opt["model"]["unet"]["remat"] = remat
    diffusion = define_G(opt, device="cpu")
    torch_compat.load_flax_params(diffusion.denoise_fn, jax_model()[1])
    return diffusion


def test_the_config_is_the_attention_free_512_model():
    """Unchanged but for the width: 16 groups, one res block, no attention
    outside the mid block, remat, dropout 0.2; the same parameter count as
    the JAX package's model, loaded strictly."""
    unet = narrow_opt()["model"]["unet"]
    assert (unet["attn_res"], unet["res_blocks"], unet["norm_groups"],
            unet["remat"], unet["dropout"]) == ([], 1, 16, True, 0.2)
    net = port_diffusion().denoise_fn
    assert net.image_size == IMAGE and net.remat
    assert sum(isinstance(m, SelfAttention) for m in net.modules()) == 1
    assert net.mid[0].attn is not None
    _, params = jax_model()
    assert count_params(net) == sum(
        p.size for p in jax.tree_util.tree_leaves(params))


def test_forward_matches_jax_unet():
    diffusion, params = jax_model()
    net = port_diffusion().denoise_fn.eval()
    rng = np.random.default_rng(301)
    x = rng.standard_normal((1, IMAGE, IMAGE, 6)).astype(np.float32)
    cond = np.asarray([0.6], np.float32)
    ref = jax.jit(functools.partial(diffusion.denoise_fn.apply, train=False))(
        params, x, cond)
    with torch.inference_mode():
        out = net(torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(cond))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=1e-4, rtol=0)


def _loss_and_grads(diffusion):
    net = diffusion.denoise_fn.train()
    g = torch.Generator().manual_seed(302)
    hr = torch.rand(1, 3, IMAGE, IMAGE, generator=g) * 2 - 1
    sched = make_schedule(narrow_opt()["model"]["beta_schedule"]["train"])
    loss = diffusion.p_losses(net, sched, {"HR": hr, "SR": hr.flip(3)},
                              torch.Generator().manual_seed(303))
    loss.backward()
    return loss.item(), {n: p.grad for n, p in net.named_parameters()}


def test_remat_loss_and_gradients_equal_the_plain_ones():
    """Remat on and off draw the same dropout masks (remat_block replays
    them in the recompute); the top level's dropout Blocks (512^2) take the
    GroupNorm statistics route."""
    assert IMAGE * IMAGE >= STATS_MIN_HW
    loss_r, grads_r = _loss_and_grads(port_diffusion(remat=True))
    loss_p, grads_p = _loss_and_grads(port_diffusion(remat=False))
    assert np.isfinite(loss_r)
    np.testing.assert_allclose(loss_r, loss_p, rtol=1e-5)
    for name, gp in grads_p.items():
        np.testing.assert_allclose(grads_r[name], gp, rtol=0,
                                   atol=1e-5 * gp.abs().max().item(),
                                   err_msg=name)
