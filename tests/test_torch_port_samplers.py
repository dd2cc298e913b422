"""The port's strided chains (DDIM, DPM-Solver++(2M) ODE and SDE) against
the JAX package's, the sampler choice of the trainer, and the grouping
invariance of the unconditional and strided evaluator paths.

A small sr3 UNet (inner_channel 16, mults [1, 2], 8 norm groups, image 16,
attention at 8x8), conditional and unconditional, built and initialised by
the JAX package and carried into the port; T = 20, S = 5 steps, float32 on
the CPU. The JAX loops draw their own noise: the test makes the same
``jax.random`` calls (``split(rng)`` -> key_init, key_chain; then
``split(key)`` at each step) and feeds the draws to the port through
``noise_stream``. Every frame within atol 5e-4 (five chained UNet steps; the
x0 = (x - s*eps)/a of both chains amplifies float32 rounding where abar is
small, by 1/sqrt(abar) <= 1.1 on this schedule). The ancestral chain and
the 50-step DDIM and SDE DPM-Solver++ chains also run at
configs/_traj100k.json's T=2000 train schedule, the one its checkpoints
are scored at, to the same atol.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr3_tpu.models.networks import define_G as jax_define_G
from sr3_tpu.models.networks import init_params
from sr3_tpu.models.schedule import make_schedule as jax_make_schedule
from sr3_tpu_torch.models.diffusion import _snapshot_count, _strided_taus
from sr3_tpu_torch.models.networks import define_G
from sr3_tpu_torch.models.schedule import make_schedule
from sr3_tpu_torch.training.evaluation import GroupedEvaluator
from sr3_tpu_torch.training.trainer import create_model
from sr3_tpu_torch.utils.torch_compat import load_flax_params

T, S = 20, 5
SCHED = {"schedule": "linear", "n_timestep": T, "linear_start": 1e-6,
         "linear_end": 1e-2}
SHAPE = (2, 16, 16, 3)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_opt(conditional=True, diffusion=None):
    return {
        "name": "tiny", "phase": "val", "seed": 0,
        "path": {"resume_state": None},
        "model": {
            "which_model_G": "sr3", "dtype": "float32",
            "unet": {"in_channel": 6 if conditional else 3, "out_channel": 3,
                     "inner_channel": 16, "norm_groups": 8,
                     "channel_multiplier": [1, 2], "attn_res": [8],
                     "res_blocks": 1, "dropout": 0.0},
            "beta_schedule": {"val": dict(SCHED)},
            "diffusion": {"image_size": 16, "channels": 3,
                          "conditional": conditional, **(diffusion or {})},
        },
    }


@functools.lru_cache(maxsize=None)
def jax_model(conditional):
    diffusion = jax_define_G(tiny_opt(conditional))
    params = jax.tree_util.tree_map(
        np.asarray, init_params(diffusion, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(100)
    params = jax.tree_util.tree_map(
        lambda p: (p + 0.1 * rng.standard_normal(p.shape)).astype(np.float32)
        if p.ndim == 1 else p, params)
    return diffusion, params


def port_model(conditional):
    diff = define_G(tiny_opt(conditional), device="cpu")
    load_flax_params(diff.denoise_fn, jax_model(conditional)[1])
    return diff


nchw = lambda a: torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)
nhwc = lambda t: t.permute(0, 2, 3, 1).numpy()


def jax_draws(key, n_steps):
    """The JAX strided loops' draws from ``key``: the initial noise and one
    per step, NCHW tensors for the port's noise_stream."""
    key_init, key = jax.random.split(key)
    init = jax.random.normal(key_init, SHAPE, dtype=jnp.float32)
    steps = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        steps.append(np.asarray(jax.random.normal(sub, SHAPE,
                                                  dtype=jnp.float32)))
    return nchw(init), torch.from_numpy(np.stack(steps)).permute(0, 1, 4, 2, 3)


@pytest.mark.parametrize("continuous", [False, True])
@pytest.mark.parametrize("conditional", [True, False])
@pytest.mark.parametrize("eta", [0.0, 1.0])
@pytest.mark.parametrize("sampler", ["ddim", "dpm++"])
def test_strided_chain_matches_jax(sampler, eta, conditional, continuous):
    diffusion, params = jax_model(conditional)
    diff = port_model(conditional)
    rng = np.random.default_rng(6)
    cond = (0.5 * rng.standard_normal(SHAPE)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    jloop = (diffusion.ddim_sample_loop if sampler == "ddim"
             else diffusion.dpmpp_sample_loop)
    loop = diff.ddim_sample_loop if sampler == "ddim" else diff.dpmpp_sample_loop
    jsched = jax_make_schedule(SCHED)
    x_in = cond if conditional else SHAPE
    ref = np.asarray(jax.jit(lambda p: jloop(
        p, jsched, x_in, key, n_steps=S, eta=eta, continuous=continuous))(
            params))
    port_in = nchw(cond) if conditional else (2, 3, 16, 16)
    with torch.inference_mode():
        out = nhwc(loop(diff.denoise_fn, make_schedule(SCHED), port_in,
                        n_steps=S, eta=eta, continuous=continuous,
                        noise_stream=jax_draws(key, S)))
    n_snap, _ = _snapshot_count(S)
    assert out.shape == ref.shape == (
        ((1 + n_snap) * 2,) if continuous else (2,)) + SHAPE[1:]
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=0)
    if continuous and not conditional:  # frame 0: the initial noise
        np.testing.assert_array_equal(out[:2], nhwc(jax_draws(key, S)[0]))


# configs/_traj100k.json's train schedule, at which its checkpoints are
# scored (T=2000, the ancestral chain and 50-step strided chains, eta 1)
TRAJ_SCHED = {"schedule": "linear", "n_timestep": 2000, "linear_start": 1e-6,
              "linear_end": 1e-2}


@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "dpm++"])
def test_chains_at_the_traj100k_schedule_match_jax(sampler):
    """The chains that score a _traj100k checkpoint, on the JAX package's
    draws: the port's final image against the JAX chain's, float32."""
    diffusion, params = jax_model(True)
    diff = port_model(True)
    rng = np.random.default_rng(8)
    cond = (0.5 * rng.standard_normal(SHAPE)).astype(np.float32)
    jsched = jax_make_schedule(TRAJ_SCHED)
    key = jax.random.PRNGKey(12)
    if sampler == "ddpm":
        init = rng.standard_normal(SHAPE).astype(np.float32)
        steps = rng.standard_normal((2000,) + SHAPE).astype(np.float32)
        ref = jax.jit(lambda p, ns: diffusion.p_sample_loop(
            p, jsched, cond, key, noise_stream=ns))(params, (init, steps))
        ns = (nchw(init), torch.from_numpy(steps).permute(0, 1, 4, 2, 3))
        run = lambda: diff.p_sample_loop(diff.denoise_fn,
                                         make_schedule(TRAJ_SCHED),
                                         nchw(cond), noise_stream=ns)
    else:
        jloop = (diffusion.ddim_sample_loop if sampler == "ddim"
                 else diffusion.dpmpp_sample_loop)
        loop = (diff.ddim_sample_loop if sampler == "ddim"
                else diff.dpmpp_sample_loop)
        ref = jax.jit(lambda p: jloop(p, jsched, cond, key, n_steps=50,
                                      eta=1.0))(params)
        run = lambda: loop(diff.denoise_fn, make_schedule(TRAJ_SCHED),
                           nchw(cond), n_steps=50, eta=1.0,
                           noise_stream=jax_draws(key, 50))
    with torch.inference_mode():
        out = nhwc(run())
    np.testing.assert_allclose(out, np.asarray(ref), atol=5e-4, rtol=0)


@pytest.mark.parametrize("clip", [False, True])
def test_ddim_full_sequence_eta1_equals_the_ancestral_chain(clip):
    """S = T, eta = 1: DDIM's update is the ancestral posterior step, and
    steps[i] feeds loop position i in both chains."""
    diff = port_model(True)
    sched = make_schedule(SCHED)
    rng = np.random.default_rng(7)
    cond = nchw((0.3 * rng.standard_normal(SHAPE)).astype(np.float32))
    ns = (torch.from_numpy(rng.standard_normal((2, 3, 16, 16))
                           .astype(np.float32)),
          torch.from_numpy(rng.standard_normal((T, 2, 3, 16, 16))
                           .astype(np.float32)))
    with torch.inference_mode():
        anc = diff.p_sample_loop(diff.denoise_fn, sched, cond,
                                 clip_denoised=clip, noise_stream=ns)
        ddim = diff.ddim_sample_loop(diff.denoise_fn, sched, cond, n_steps=T,
                                     eta=1.0, clip_denoised=clip,
                                     noise_stream=ns)
    np.testing.assert_allclose(ddim.numpy(), anc.numpy(), atol=1e-4, rtol=0)


class CountingNet(torch.nn.Module):
    """A net that counts its forwards."""

    def __init__(self, net):
        super().__init__()
        self.net, self.calls = net, 0

    def forward(self, x, lvl, generator=None):
        self.calls += 1
        return self.net(x, lvl, generator)


@pytest.mark.parametrize("diffusion,chain,knobs,steps", [
    ({}, "p_sample_loop", {}, T),
    ({"sampler": "ddim"}, "ddim_sample_loop", {"n_steps": 50, "eta": 0.0}, T),
    ({"sampler": "ddim", "ddim_steps": 7, "eta": 0.5}, "ddim_sample_loop",
     {"n_steps": 7, "eta": 0.5}, 7),
    ({"sampler": "dpm++"}, "dpmpp_sample_loop", {"n_steps": 25, "eta": 0.0},
     T),
    ({"sampler": "dpmpp", "sampler_steps": 6, "ddim_steps": 9, "eta": 1.0},
     "dpmpp_sample_loop", {"n_steps": 6, "eta": 1.0}, 6),
])
def test_chain_fn_picks_the_configured_sampler(diffusion, chain, knobs, steps,
                                               monkeypatch):
    """sampler / sampler_steps (alias ddim_steps; default 50 for DDIM and
    25 for DPM++, capped at T by the chains) / eta; one net forward per
    step."""
    trainer = create_model(tiny_opt(True, diffusion), device="cpu")
    trainer.set_new_noise_schedule(SCHED, schedule_phase="val")
    called = []
    original = getattr(trainer.diffusion, chain)

    def spy(*a, **k):
        called.append({n: k[n] for n in ("n_steps", "eta") if n in k})
        return original(*a, **k)

    monkeypatch.setattr(trainer.diffusion, chain, spy)
    net = CountingNet(trainer.netG.eval())
    with torch.inference_mode():
        out = trainer._chain_fn(False)(net, torch.zeros(1, 3, 16, 16), None)
    assert called == [knobs] and net.calls == steps
    assert out.shape == (1, 3, 16, 16) and torch.isfinite(out).all()
    assert len(_strided_taus(T, knobs.get("n_steps", T))) == steps


def test_unknown_sampler_raises():
    trainer = create_model(tiny_opt(True, {"sampler": "euler"}), device="cpu")
    with pytest.raises(ValueError, match="sampler"):
        trainer._chain_fn(False)


def _uncond(trainer, n, group, base_seed, continous=False):
    ev = GroupedEvaluator(trainer, group, base_seed=base_seed)
    return list(ev.run_uncond(n, continous=continous))


def test_run_uncond_does_not_depend_on_the_group_size():
    trainer = create_model(tiny_opt(False), device="cpu")
    trainer.set_new_noise_schedule(SCHED, schedule_phase="val")
    one = _uncond(trainer, 3, 1, base_seed=11)
    three = _uncond(trainer, 3, 3, base_seed=11)
    two = _uncond(trainer, 3, 2, base_seed=11)  # the last group is cut
    assert len(one) == len(two) == len(three) == 3
    for a, b, c in zip(one, three, two):
        assert a.shape == (16, 16, 3)
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
        np.testing.assert_allclose(a, c, atol=1e-5, rtol=0)
    assert np.abs(one[0] - one[1]).max() > 1e-3  # each its own stream
    frames = _uncond(trainer, 2, 2, base_seed=11, continous=True)
    assert frames[0].shape == (1 + _snapshot_count(T)[0], 16, 16, 3)
    np.testing.assert_allclose(frames[1][-1], one[1], atol=1e-5, rtol=0)


@pytest.mark.parametrize("sampler", [
    {"sampler": "ddim", "ddim_steps": S, "eta": 1.0},
    {"sampler": "dpm++", "sampler_steps": S, "eta": 1.0},
])
def test_strided_chains_do_not_depend_on_the_group_size(sampler):
    """run_sr and run_uncond through DDIM and the SDE DPM++ (both draw
    noise at every step) give the same images at group sizes 1 and 3."""
    for conditional in (True, False):
        trainer = create_model(tiny_opt(conditional, sampler), device="cpu")
        trainer.set_new_noise_schedule(SCHED, schedule_phase="val")
        if conditional:
            rng = np.random.default_rng(8)
            items = [{"SR": rng.uniform(-1, 1, (16, 16, 3)).astype(np.float32)}
                     for _ in range(3)]
            run = lambda g: [o for _, o in GroupedEvaluator(
                trainer, g, base_seed=5).run_sr(iter(items))]
        else:
            run = lambda g: list(GroupedEvaluator(
                trainer, g, base_seed=5).run_uncond(3))
        for a, b in zip(run(1), run(3)):
            assert np.isfinite(a).all()
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
