"""The port's ddpm conditioning and unconditional chains against the JAX
package, on the CPU in float32.

Small UNets (inner_channel 16, mults [1, 2], 8 norm groups, image 16,
attention at 8x8) are built and initialised by the JAX package, their 1-D
parameters perturbed from a numpy seed, and carried into the port by
``load_flax_params``. Inputs and noise are numpy arrays from a seed; where
the JAX function draws its own noise, the test makes the same
``jax.random`` calls and hands the draws to the port's ``noise_stream``.

Tolerances: the UNet forward atol 1e-4 (float32 through ~20 layers); the
loss atol 1e-5 (a mean of |noise - eps| over 1536 values); chain frames
atol 5e-4 (ten chained UNet steps, each carrying the previous step's float32
rounding); step-locked Adam steps as in tests/test_torch_port_train.py.
"""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sr3_tpu.models.unet as jax_unet
from sr3_tpu.models.networks import define_G as jax_define_G
from sr3_tpu.models.networks import init_params
from sr3_tpu.models.schedule import make_schedule as jax_make_schedule
from sr3_tpu.utils.torch_compat import flax_params_to_torch_state_dict
from sr3_tpu_torch.models.networks import define_G
from sr3_tpu_torch.models.schedule import make_schedule
from sr3_tpu_torch.ops import dropout as port_dropout
from sr3_tpu_torch.training.trainer import create_model
from sr3_tpu_torch.utils.torch_compat import (load_flax_params, load_gen_pth,
                                              strip_reference_keys,
                                              unet_key_config)
from test_torch_port_train import _JAX_MASKS, MaskFeed, jax_dropout

T = 10
SCHED = {"schedule": "linear", "n_timestep": T, "linear_start": 1e-4,
         "linear_end": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_opt(cond_mode="ddpm", conditional=True, phase="val", dropout=0.0,
             inner_channel=16, norm_groups=8, resume_state=None):
    return {
        "name": "tiny", "phase": phase, "seed": 0,
        "path": {"resume_state": resume_state},
        "model": {
            "which_model_G": cond_mode, "dtype": "float32",
            "unet": {"in_channel": 6 if conditional else 3, "out_channel": 3,
                     "inner_channel": inner_channel,
                     "norm_groups": norm_groups, "channel_multiplier": [1, 2],
                     "attn_res": [8], "res_blocks": 1, "dropout": dropout},
            "beta_schedule": {"train": dict(SCHED), "val": dict(SCHED)},
            "diffusion": {"image_size": 16, "channels": 3,
                          "conditional": conditional},
        },
        "train": {"optimizer": {"type": "adam", "lr": 1e-4}},
    }


@functools.lru_cache(maxsize=None)
def jax_model(cond_mode="ddpm", conditional=True, **kw):
    """JAX diffusion + perturbed parameters (numpy leaves; not mutated)."""
    diffusion = jax_define_G(tiny_opt(cond_mode, conditional, **kw))
    params = jax.tree_util.tree_map(
        np.asarray, init_params(diffusion, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(100)
    params = jax.tree_util.tree_map(
        lambda p: (p + 0.1 * rng.standard_normal(p.shape)).astype(np.float32)
        if p.ndim == 1 else p, params)
    return diffusion, params


def port_model(cond_mode="ddpm", conditional=True, **kw):
    diff = define_G(tiny_opt(cond_mode, conditional, **kw), device="cpu")
    load_flax_params(diff.denoise_fn, jax_model(cond_mode, conditional,
                                                **kw)[1])
    return diff


nchw = lambda a: torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)
nhwc = lambda t: t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("conditional", [True, False])
def test_ddpm_forward_matches_jax(conditional):
    """Reference names (time_mlp, mlp.1) and the float-t conditioning: the
    carried ddpm tree gives the JAX forward, t up to T-1 = 1999."""
    diffusion, params = jax_model("ddpm", conditional)
    net = port_model("ddpm", conditional).denoise_fn
    assert net.cond_mode == "ddpm" and unet_key_config(net)["cond_mode"] == "ddpm"
    assert "time_mlp.1.weight" in net.state_dict()
    assert "downs.1.res_block.mlp.1.weight" in net.state_dict()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 16, 16, net.in_channel)).astype(np.float32)
    t = np.asarray([0.0, 917.0, 1999.0], np.float32)
    ref = np.asarray(jax.jit(functools.partial(
        diffusion.denoise_fn.apply, train=False))(params, x, t))
    with torch.inference_mode():
        out = net(nchw(x), torch.from_numpy(t))
    np.testing.assert_allclose(nhwc(out), ref, atol=1e-4, rtol=0)


def test_reference_ddpm_state_dict_loads_through_load_gen_pth(tmp_path):
    """The JAX package's export of a ddpm tree (denoise_fn. prefix,
    time_mlp.0.inv_freq, schedule buffers) loads strictly and equals
    load_flax_params."""
    _, params = jax_model("ddpm", True)
    direct = port_model("ddpm", True).denoise_fn
    sd = flax_params_to_torch_state_dict(
        params, schedule_opt=SCHED, **unet_key_config(direct))
    assert "denoise_fn.time_mlp.0.inv_freq" in sd
    path = tmp_path / "I5_E1_gen.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    net = define_G(tiny_opt("ddpm"), device="cpu").denoise_fn
    load_gen_pth(net, str(path))
    for k, v in direct.state_dict().items():
        assert torch.equal(net.state_dict()[k], v), k
    trainer = create_model(tiny_opt("ddpm", resume_state=str(tmp_path / "I5_E1")),
                           device="cpu")
    for k, v in direct.state_dict().items():
        assert torch.equal(trainer.netG.state_dict()[k], v), k


def test_print_network_reports_the_cond_mode(caplog):
    for mode in ("ddpm", "sr3"):
        trainer = create_model(tiny_opt(mode), device="cpu")
        with caplog.at_level(logging.INFO, logger="base"):
            trainer.print_network()
        assert f"UNet(cond_mode={mode})" in caplog.text
        caplog.clear()


@pytest.mark.parametrize("conditional", [True, False])
def test_ddpm_p_losses_matches_jax(conditional):
    diffusion, params = jax_model("ddpm", conditional)
    diff = port_model("ddpm", conditional)
    rng = np.random.default_rng(2)
    batch = {k: rng.uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)
             for k in ("HR", "SR")}
    noise = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
    t = np.asarray([0, 4, 9], np.int32)
    ref = float(diffusion.p_losses(
        params, jax_make_schedule(SCHED),
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0),
        train=False, injected={"noise": noise, "t": t}))
    with torch.no_grad():
        loss = diff.p_losses(diff.denoise_fn, make_schedule(SCHED),
                             {k: nchw(v) for k, v in batch.items()},
                             injected={"noise": nchw(noise),
                                       "t": torch.from_numpy(t)})
    assert abs(float(loss) - ref) <= 1e-5, (float(loss), ref)


def test_ddpm_t_draw_is_per_sample_in_range():
    diff = define_G(tiny_opt("ddpm"), device="cpu")
    sched = make_schedule(SCHED)
    seen = []

    def net(x, t, generator=None):
        seen.append(t.numpy().copy())
        return torch.zeros_like(x[:, 3:])

    g = torch.Generator().manual_seed(3)
    hr = torch.rand(8, 3, 16, 16) * 2 - 1
    for _ in range(20):
        diff.p_losses(net, sched, {"HR": hr, "SR": hr}, g)
    ts = np.stack(seen)
    assert ts.dtype == np.float32 and ts.shape == (20, 8)
    assert np.all(ts == np.round(ts)) and ts.min() >= 0 and ts.max() <= T - 1
    assert set(np.unique(ts)) == set(range(T))
    assert all(len(set(row)) > 1 for row in ts)  # one t per sample


def test_ddpm_step_locked_training_matches_jax(monkeypatch):
    """5 Adam steps of the port's ddpm Trainer (dropout 0.2) against the
    JAX p_losses + optax adam on carried weights, the same batch, noise,
    integer t and dropout masks."""
    steps, b = 5, 2
    kw = dict(phase="train", dropout=0.2, inner_channel=8, norm_groups=4)
    diffusion, params = jax_model("ddpm", True, **kw)
    trainer = create_model(tiny_opt("ddpm", True, **kw), device="cpu")
    load_flax_params(trainer.netG, params)
    trainer.set_new_noise_schedule(SCHED)
    feed = MaskFeed(30)
    monkeypatch.setattr(port_dropout, "dropout_mask", feed.port_mask)
    monkeypatch.setattr(jax_unet, "dropout", jax_dropout)
    injected = {}
    monkeypatch.setattr(trainer.diffusion, "p_losses", functools.partial(
        trainer.diffusion.p_losses, injected=injected))

    rng = np.random.default_rng(31)
    data = {k: rng.uniform(-1, 1, (b, 16, 16, 3)).astype(np.float32)
            for k in ("HR", "SR")}
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    sched = jax_make_schedule(SCHED)
    tx = optax.adam(1e-4)

    @jax.jit
    def jstep(params, opt_state, inj, masks):
        _JAX_MASKS[:] = [iter(masks)]

        def loss_fn(p):
            return diffusion.p_losses(p, sched, jbatch, jax.random.PRNGKey(0),
                                      train=True, injected=inj)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    opt_state = tx.init(params)
    losses_t, losses_j = [], []
    for _ in range(steps):
        t = rng.integers(0, T, b).astype(np.int32)
        noise = rng.standard_normal((b, 16, 16, 3)).astype(np.float32)
        injected.update(noise=nchw(noise), t=torch.from_numpy(t))
        feed.drawn = []
        trainer.feed_data(data)
        trainer.optimize_parameters()
        losses_t.append(trainer.get_current_log()["l_pix"])
        params, opt_state, lj = jstep(params, opt_state,
                                      {"noise": noise, "t": t}, feed.drawn)
        losses_j.append(float(lj))
    assert len(feed.drawn) == 8  # one mask per ResnetBlock's block2
    np.testing.assert_allclose(losses_t, losses_j, rtol=5e-3, atol=5e-4)
    assert losses_t[0] != losses_t[-1]
    moved = strip_reference_keys(flax_params_to_torch_state_dict(
        jax.tree_util.tree_map(np.asarray, params),
        **unet_key_config(trainer.netG)))
    for name, p in trainer.netG.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), moved[name], rtol=0,
                                   atol=5e-5, err_msg=name)


@pytest.mark.parametrize("cond_mode", ["sr3", "ddpm"])
def test_unconditional_p_sample_loop_matches_jax(cond_mode):
    """Every frame of the unconditional ancestral chain under one numpy
    noise stream; frame 0 is the initial noise."""
    diffusion, params = jax_model(cond_mode, False)
    diff = port_model(cond_mode, False)
    rng = np.random.default_rng(4)
    shape = (2, 16, 16, 3)
    init = rng.standard_normal(shape).astype(np.float32)
    steps = rng.standard_normal((T,) + shape).astype(np.float32)
    jsched = jax_make_schedule(SCHED)
    ref = np.asarray(jax.jit(
        lambda p, ns: diffusion.p_sample_loop(
            p, jsched, shape, jax.random.PRNGKey(0), continuous=True,
            noise_stream=ns))(params, (init, steps)))
    ns = (nchw(init), torch.from_numpy(steps).permute(0, 1, 4, 2, 3))
    with torch.inference_mode():
        frames = diff.p_sample_loop(diff.denoise_fn, make_schedule(SCHED),
                                    (2, 3, 16, 16), continuous=True,
                                    noise_stream=ns)
    frames = nhwc(frames)
    assert frames.shape == ref.shape == ((1 + T) * 2, 16, 16, 3)
    np.testing.assert_array_equal(frames[:2], init)
    np.testing.assert_allclose(frames, ref, atol=5e-4, rtol=0)


def test_interpolate_matches_jax():
    """ddpm interpolate at T=10 from t = T-1 and from t = 6: noise both
    images to t, blend, step from t-1 to 0; JAX's keys reproduced."""
    diffusion, params = jax_model("ddpm", False)
    diff = port_model("ddpm", False)
    jsched, sched = jax_make_schedule(SCHED), make_schedule(SCHED)
    rng = np.random.default_rng(5)
    x1, x2 = (rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
              for _ in range(2))
    key = jax.random.PRNGKey(9)
    for t in (None, 6):
        ref = np.asarray(jax.jit(lambda p: diffusion.interpolate(
            p, jsched, x1, x2, key, t=t, lam=0.3))(params))
        t0 = T - 1 if t is None else t
        k1, k2, kc = jax.random.split(key, 3)
        draws = []
        for _ in range(t0):
            kc, sub = jax.random.split(kc)
            draws.append(np.asarray(jax.random.normal(sub, x1.shape)))
        ns = (nchw(np.asarray(jax.random.normal(k1, x1.shape))),
              nchw(np.asarray(jax.random.normal(k2, x2.shape))),
              torch.from_numpy(np.stack(draws)).permute(0, 1, 4, 2, 3))
        with torch.inference_mode():
            out = diff.interpolate(diff.denoise_fn, sched, nchw(x1), nchw(x2),
                                   t=t, lam=0.3, noise_stream=ns)
        np.testing.assert_allclose(nhwc(out), ref, atol=5e-4, rtol=0)
    with pytest.raises(ValueError, match="ddpm"):
        port_model("sr3", False).interpolate(None, sched, nchw(x1), nchw(x2))
