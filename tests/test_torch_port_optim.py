"""The port's Adam (sr3_tpu_torch/training/optim.py) against optax.adam,
with the first moment in float32 and in bfloat16 (train.optimizer.mu_dtype).

Five step-locked steps of the tiny sr3 UNet of tests/test_torch_port_train.py
(carried weights, the same batch, injected noise and sqrt-gamma, the same
dropout masks). Each side computes its gradients; the port's must be within
1e-4 of each parameter's max|grad| of the JAX package's (as the float32
step-locked test holds them), and then both optimizers step on the JAX
package's gradients, so what is compared is the optimizer: after every
step each parameter within 1e-5 of the JAX package's, the stored first
moment within one bfloat16 ulp (bf16) or 1e-7 (float32) of optax's. (On
their own gradients the two packages' float32 first moments of the small
noise-MLP weights differ by up to ~2 bfloat16 ulps after two steps.) The
saved and resumed optimizer keeps its bfloat16 first moment.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sr3_tpu.models.unet as jax_unet
from sr3_tpu.models.schedule import make_schedule as jax_make_schedule
from sr3_tpu.utils.torch_compat import flax_params_to_torch_state_dict
from sr3_tpu_torch.ops import dropout as port_dropout
from sr3_tpu_torch.training.trainer import create_model
from sr3_tpu_torch.utils.torch_compat import (load_flax_params,
                                              strip_reference_keys,
                                              unet_key_config)
from test_torch_port_train import (_JAX_MASKS, SCHED, MaskFeed, batch,
                                   jax_dropout, jax_model, tiny_opt)

PARAM_TOL = 1e-5


def _trainer(mu_dtype, tmp_path=None, resume_state=None):
    opt = tiny_opt(tmp_path, resume_state=resume_state)
    opt["train"]["optimizer"]["mu_dtype"] = mu_dtype
    trainer = create_model(opt, device="cpu")
    if resume_state is None:
        load_flax_params(trainer.netG, jax_model()[1])
    trainer.set_new_noise_schedule(SCHED)
    return trainer


def _torch_names(tree, net):
    return strip_reference_keys(flax_params_to_torch_state_dict(
        jax.tree_util.tree_map(np.asarray, tree), **unet_key_config(net)))


def _bf16_ulp(x):
    """One bfloat16 ulp at |x| (the spacing of 8 significant bits)."""
    a = np.maximum(np.abs(x.astype(np.float32)), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_step_locked_adam_matches_optax(monkeypatch, mu_dtype):
    steps, b = 5, 2
    diffusion, params = jax_model()
    trainer = _trainer(mu_dtype)
    feed = MaskFeed(50)
    monkeypatch.setattr(port_dropout, "dropout_mask", feed.port_mask)
    monkeypatch.setattr(jax_unet, "dropout", jax_dropout)
    injected = {}
    monkeypatch.setattr(trainer.diffusion, "p_losses", functools.partial(
        trainer.diffusion.p_losses, injected=injected))
    data = batch(51, b)
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    sched = jax_make_schedule(SCHED)
    tx = optax.adam(1e-4, mu_dtype=jnp.bfloat16 if mu_dtype == "bfloat16"
                    else None)

    @jax.jit
    def jstep(params, opt_state, inj, masks):
        _JAX_MASKS[:] = [iter(masks)]

        def loss_fn(p):
            return diffusion.p_losses(p, sched, jbatch, jax.random.PRNGKey(0),
                                      train=True, injected=inj)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, grads

    prev = np.sqrt(np.append(1.0, np.cumprod(1 - np.linspace(
        1e-6, 1e-2, 10))))
    rng = np.random.default_rng(52)
    opt_state = tx.init(params)
    net = trainer.netG
    port_step = trainer.optimizer.step
    inputs = {}

    def jax_step_then_port_step():
        """Runs between the port's backward and its optimizer step: the JAX
        step on the masks the port's forward drew, then the port's
        optimizer on the JAX gradients."""
        nonlocal params, opt_state
        params, opt_state, grads = jstep(params, opt_state, inputs,
                                         feed.drawn)
        grads = _torch_names(grads, net)
        for name, p in net.named_parameters():
            ref = grads[name]
            np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                       atol=1e-4 * np.abs(ref).max(),
                                       err_msg=name)
            p.grad = torch.from_numpy(np.ascontiguousarray(ref))
        port_step()

    monkeypatch.setattr(trainer.optimizer, "step", jax_step_then_port_step)
    for step in range(steps):
        t = rng.integers(1, 11)
        gamma = rng.uniform(prev[t], prev[t - 1], (b, 1)).astype(np.float32)
        noise = rng.standard_normal((b, 16, 16, 3)).astype(np.float32)
        injected.update(noise=torch.from_numpy(noise).permute(0, 3, 1, 2),
                        sqrt_gamma=torch.from_numpy(gamma))
        inputs.update(noise=noise, sqrt_gamma=gamma)
        feed.drawn = []
        trainer.feed_data(data)
        trainer.optimize_parameters()
        ref_p = _torch_names(params, net)
        ref_mu = _torch_names(opt_state[0].mu, net)
        for name, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref_p[name],
                                       rtol=0, atol=PARAM_TOL,
                                       err_msg=f"step {step} {name}")
            mu = trainer.optimizer.state[p]["exp_avg"]
            assert mu.dtype == getattr(torch, mu_dtype), name
            got = mu.float().numpy()
            want = np.asarray(ref_mu[name], np.float32)
            tol = _bf16_ulp(want) if mu_dtype == "bfloat16" else 1e-7
            assert np.all(np.abs(got - want) <= tol), (step, name)
            assert trainer.optimizer.state[p]["exp_avg_sq"].dtype == \
                torch.float32
    assert int(opt_state[0].count) == steps


def test_bf16_first_moment_survives_save_and_resume(tmp_path):
    """The _opt.pth round trip keeps exp_avg in bfloat16 (Optimizer's
    load_state_dict would cast it to the parameter's float32), and the
    resumed optimizer's next step equals the uninterrupted one's."""
    trainer = _trainer("bfloat16", tmp_path)
    trainer.feed_data(batch(53))
    for _ in range(2):
        trainer.optimize_parameters()
    trainer.save_network(1, 2)
    resumed = _trainer("bfloat16", tmp_path,
                       resume_state=str(tmp_path / "I2_E1"))
    for p, q in zip(trainer.netG.parameters(), resumed.netG.parameters()):
        a, b = trainer.optimizer.state[p], resumed.optimizer.state[q]
        assert b["exp_avg"].dtype == torch.bfloat16
        assert b["exp_avg_sq"].dtype == torch.float32
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a[key], b[key]), key
    # the same draws on both sides: one generator state for both
    resumed.generator.set_state(trainer.generator.get_state())
    resumed.feed_data(batch(54))
    trainer.feed_data(batch(54))
    trainer.optimize_parameters()
    resumed.optimize_parameters()
    for p, q in zip(trainer.netG.parameters(), resumed.netG.parameters()):
        assert torch.equal(p, q)

