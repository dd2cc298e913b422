"""Both packages train the same model on the same data and score it the
same: the end-to-end check of the port's training path against the JAX
package.

configs/sr_sr3_16_128_fixture.json at tiny width (inner_channel 8, 4 norm
groups, its five levels, attention at 16x16, dropout 0.2), T=10 schedules,
on dataset/fixtures_16_128 as the port's dataset reads it (val split: no
random flips). Both packages start from the port's initial weights (its
train-phase init, carried into the JAX package's tree by the JAX package's
converter) and get the same batches, the same injected noise and
sqrt-gamma each step, and the same dropout masks (the port's draws,
recorded in its forward and replayed by the JAX side). Each side computes
its own gradients and steps its own optimizer (the port's trainer;
optax.adam as the JAX trainer builds it).

- 20 train steps, the Adam first moment in float32, then in bfloat16: the
  two loss curves within 1e-4 relative at every step.
- The trained weights of each package through its own grouped evaluator
  (run_sr, T=10) on the fixture val set, each image's noise the JAX
  package's own draws (the port takes them through ``noise_stream``): the
  mean PSNR within 1e-3 dB and the mean SSIM within 1e-4, each package's
  metrics on its own outputs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sr3_tpu.models.unet as jax_unet
import sr3_tpu.utils.metrics as JaxMetrics
from sr3_tpu.parallel.mesh import create_mesh
from sr3_tpu.training.evaluation import GroupedEvaluator as JaxEvaluator
import sr3_tpu.training.trainer as jax_trainer_module
from sr3_tpu.training.trainer import Trainer as JaxTrainer
from sr3_tpu.utils.torch_compat import torch_state_dict_to_flax
from sr3_tpu.utils.config import dict_to_nonedict as jax_nonedict
import sr3_tpu_torch.utils.metrics as Metrics
from sr3_tpu_torch.data.loader import collate, create_dataset
from sr3_tpu_torch.ops import dropout as port_dropout
from sr3_tpu_torch.training.evaluation import GroupedEvaluator
from sr3_tpu_torch.training.trainer import create_model
from sr3_tpu_torch.utils.config import load_config
from sr3_tpu_torch.utils.torch_compat import (load_flax_params,
                                              unet_key_config)

from test_torch_port_cascade import _inject_jax_draws
from test_torch_port_train import _JAX_MASKS, jax_dropout

CONFIG = "configs/sr_sr3_16_128_fixture.json"
STEPS = 20
T = 10


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _opt(mu_dtype):
    opt = load_config(CONFIG)
    opt["seed"] = 0
    opt["path"]["resume_state"] = None
    opt["model"]["dtype"] = "float32"
    opt["model"]["unet"].update(inner_channel=8, norm_groups=4)
    for phase in ("train", "val"):
        opt["model"]["beta_schedule"][phase]["n_timestep"] = T
    opt["datasets"]["val"]["batch_size"] = 3
    opt["train"]["optimizer"]["mu_dtype"] = mu_dtype
    return opt


@functools.lru_cache(maxsize=None)
def _jax_side():
    """The JAX trainer built on the port's initial weights (its grouped
    evaluator; built once, the compiled chain shared by both cases), those
    weights, and the jitted loss and gradients of its p_losses with
    injected noise and replayed masks."""
    opt = _opt(None)
    net = create_model(opt, device="cpu").netG
    params = torch_state_dict_to_flax(
        {k: v.numpy() for k, v in net.state_dict().items()},
        **unet_key_config(net))
    real_init = jax_trainer_module.init_params
    jax_trainer_module.init_params = lambda diffusion, rng: params
    try:
        jt = JaxTrainer(jax_nonedict(dict(opt)),
                        mesh=create_mesh(num_data=1))
    finally:
        jax_trainer_module.init_params = real_init
    jt.set_new_noise_schedule(opt["model"]["beta_schedule"]["train"],
                              "train")
    params = jax.tree_util.tree_map(np.asarray, jt.state.params)
    diffusion, sched = jt.diffusion, jt.sched

    @jax.jit
    def loss_and_grads(params, batch, inj, masks):
        _JAX_MASKS[:] = [iter(masks)]
        return jax.value_and_grad(lambda p: diffusion.p_losses(
            p, sched, batch, jax.random.PRNGKey(0), train=True,
            injected=inj))(params)

    return jt, params, loss_and_grads


@functools.lru_cache(maxsize=None)
def _batches():
    """The fixture set, val split (no flips), as three batches of two."""
    opt = load_config(CONFIG)
    ds = create_dataset(dict(opt["datasets"]["train"], mode="LRHR"), "val")
    items = [ds[i] for i in range(len(ds))]
    return ([collate(items[i:i + 2]) for i in range(0, len(items), 2)],
            items)


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_two_packages_train_and_score_alike(monkeypatch, mu_dtype):
    opt = _opt(mu_dtype)
    jt, params, loss_and_grads = _jax_side()
    port = create_model(opt, device="cpu")
    load_flax_params(port.netG, params)
    port.set_new_noise_schedule(opt["model"]["beta_schedule"]["train"])

    drawn = []
    real_mask = port_dropout.dropout_mask

    def recorded_mask(x, keep, generator=None):
        m = real_mask(x, keep, generator)
        drawn.append(m.permute(0, 2, 3, 1).numpy().copy())
        return m

    monkeypatch.setattr(port_dropout, "dropout_mask", recorded_mask)
    monkeypatch.setattr(jax_unet, "dropout", jax_dropout)
    injected = {}
    monkeypatch.setattr(port.diffusion, "p_losses", functools.partial(
        port.diffusion.p_losses, injected=injected))

    tx = optax.adam(opt["train"]["optimizer"]["lr"],
                    mu_dtype=jnp.bfloat16 if mu_dtype == "bfloat16" else None)

    @jax.jit
    def update(params, opt_state, grads):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    batches, items = _batches()
    prev = np.sqrt(np.append(1.0, np.cumprod(1 - np.linspace(1e-6, 1e-2,
                                                             T))))
    rng = np.random.default_rng(70)
    opt_state = tx.init(params)
    losses_port, losses_jax = [], []
    for step in range(STEPS):
        data = batches[step % len(batches)]
        b = data["HR"].shape[0]
        t = rng.integers(1, T + 1)
        gamma = rng.uniform(prev[t], prev[t - 1], (b, 1)).astype(np.float32)
        noise = rng.standard_normal(data["HR"].shape).astype(np.float32)
        injected.update(noise=torch.from_numpy(noise).permute(0, 3, 1, 2),
                        sqrt_gamma=torch.from_numpy(gamma))
        drawn.clear()
        port.feed_data(data)
        port.optimize_parameters()
        losses_port.append(port.get_current_log()["l_pix"])
        loss, grads = loss_and_grads(
            params, {k: jnp.asarray(data[k]) for k in ("HR", "SR")},
            {"noise": noise, "sqrt_gamma": gamma}, list(drawn))
        params, opt_state = update(params, opt_state, grads)
        losses_jax.append(float(loss))
    np.testing.assert_allclose(losses_port, losses_jax, rtol=1e-4, atol=0)
    assert losses_port[0] != losses_port[-1]
    mu = port.optimizer.state[next(port.netG.parameters())]["exp_avg"]
    assert mu.dtype == getattr(torch, mu_dtype)

    # the trained weights of each package through its grouped evaluator
    base = jax.random.PRNGKey(71)
    jt.state = jt.state.replace(params=params)
    jt.set_new_noise_schedule(opt["model"]["beta_schedule"]["val"], "val")
    jax_sr = [np.asarray(sr) for _, sr in JaxEvaluator(
        jt, 3, base_rng=base).run_sr(iter(items))]
    jt.set_new_noise_schedule(opt["model"]["beta_schedule"]["train"],
                              "train")
    port.set_new_noise_schedule(opt["model"]["beta_schedule"]["val"], "val")
    with monkeypatch.context() as m:
        _inject_jax_draws(m, base, 128, T)
        port_sr = [sr for _, sr in GroupedEvaluator(port, 3).run_sr(
            iter(items))]
    assert len(port_sr) == len(jax_sr) == len(items) == 6

    def score(metrics, outs):
        pairs = [(metrics.tensor2img(sr), metrics.tensor2img(it["HR"]))
                 for sr, it in zip(outs, items)]
        return (np.mean([metrics.calculate_psnr(a, b) for a, b in pairs]),
                np.mean([metrics.calculate_ssim(a, b) for a, b in pairs]))

    psnr_p, ssim_p = score(Metrics, port_sr)
    psnr_j, ssim_j = score(JaxMetrics, jax_sr)
    assert np.isfinite(psnr_p) and abs(psnr_p - psnr_j) <= 1e-3, (psnr_p,
                                                                   psnr_j)
    assert abs(ssim_p - ssim_j) <= 1e-4, (ssim_p, ssim_j)


def test_the_training_logs_have_the_jax_trainers_keys(monkeypatch):
    """After two steps each trainer's get_current_log has the same keys:
    the loss and its step timer's step_time_ms and imgs_per_sec. The JAX
    trainer's compiled step is swapped for one that returns its state and
    a loss (the keys come from the trainer's log and timer, not from the
    step)."""
    jt, _, _ = _jax_side()
    monkeypatch.setattr(jt, "_train_step_fn",
                        lambda state, sched, batch, rng: (state,
                                                          jnp.float32(0.5)))
    monkeypatch.setattr(jt, "_train_base_rng", jax.random.PRNGKey(0),
                        raising=False)
    monkeypatch.setattr(jt, "data", None)
    port = create_model(_opt("float32"), device="cpu")
    port.set_new_noise_schedule(port.opt["model"]["beta_schedule"]["train"])
    batches, _ = _batches()
    for data in batches[:2]:
        jt.feed_data(data)
        jt.optimize_parameters()
        port.feed_data(data)
        port.optimize_parameters()
    want, got = jt.get_current_log(), port.get_current_log()
    assert sorted(got) == sorted(want) == ["imgs_per_sec", "l_pix",
                                           "step_time_ms"]
    assert all(np.isfinite(v) and v > 0 for v in got.values())
    assert got["imgs_per_sec"] == pytest.approx(2e3 / got["step_time_ms"])
