"""The port's training path on the CPU against the JAX package.

A tiny sr3 UNet (inner_channel 8, 4 norm groups, mults [1, 2], attention at
8x8, image 16, dropout 0.2) built and initialised by the JAX package, its
1-D parameters perturbed from a numpy seed, carried into the port with a
strict state_dict load. Both sides get the same numpy batch, the same
injected noise and sqrt-gamma, and the same dropout masks: each side's mask
draw is replaced by numpy masks handed out in call order.

Tolerances: the Block dropout path atol 2e-5 (values O(1), float32); the
step-locked Adam steps as tests/test_torch_parity.py holds the reference:
first-step gradients within 1e-4 of each parameter's max|grad|, losses
rtol 5e-3 / atol 5e-4 over 5 steps (Adam's normalisation amplifies float32
differences of near-zero gradients); the round trip of a saved ``_gen.pth``
into the JAX forward atol 1e-4 (float32 through ~20 layers).
"""

import copy
import functools

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
from sr3_tpu.utils.torch_compat import (flax_params_to_torch_state_dict,
                                        torch_state_dict_to_flax)
from sr3_tpu_torch.data.loader import DataLoader
from sr3_tpu_torch.models.networks import define_G
from sr3_tpu_torch.models.unet import Block
from sr3_tpu_torch.ops import dropout as port_dropout
from sr3_tpu_torch.training.trainer import create_model, finetune_norm
from sr3_tpu_torch.utils.torch_compat import (load_flax_params, load_gen_pth,
                                              strip_reference_keys,
                                              unet_key_config)

SCHED = {"schedule": "linear", "n_timestep": 10, "linear_start": 1e-6,
         "linear_end": 1e-2}
RATE = 0.2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_opt(tmp_path=None, dtype="float32", use_ema=False, lr=1e-4,
             step_start_ema=2, finetune=False, resume_state=None):
    return {
        "name": "tiny", "phase": "train", "seed": 0,
        "path": {"resume_state": resume_state,
                 "checkpoint": str(tmp_path) if tmp_path else None},
        "model": {
            "which_model_G": "sr3", "dtype": dtype, "finetune_norm": finetune,
            "unet": {"in_channel": 6, "out_channel": 3, "inner_channel": 8,
                     "norm_groups": 4, "channel_multiplier": [1, 2],
                     "attn_res": [8], "res_blocks": 1, "dropout": RATE},
            "beta_schedule": {"train": dict(SCHED), "val": dict(SCHED)},
            "diffusion": {"image_size": 16, "channels": 3,
                          "conditional": True},
        },
        "train": {"optimizer": {"type": "adam", "lr": lr},
                  "ema_scheduler": {"use_ema": use_ema, "ema_decay": 0.9,
                                    "step_start_ema": step_start_ema}},
    }


@functools.lru_cache(maxsize=None)
def jax_model():
    """JAX diffusion + perturbed parameters (numpy leaves; not mutated)."""
    diffusion = jax_define_G(tiny_opt())
    params = jax.tree_util.tree_map(
        np.asarray, init_params(diffusion, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(100)
    params = jax.tree_util.tree_map(
        lambda p: (p + 0.1 * rng.standard_normal(p.shape)).astype(np.float32)
        if p.ndim == 1 else p, params)
    return diffusion, params


def port_trainer(tmp_path=None, **kw):
    trainer = create_model(tiny_opt(tmp_path, **kw), device="cpu")
    load_flax_params(trainer.netG, jax_model()[1])
    if trainer.use_ema:  # the EMA starts from the carried weights
        for name, p in trainer.netG.named_parameters():
            trainer.ema[name].copy_(p.detach())
    trainer.set_new_noise_schedule(SCHED)
    return trainer


def batch(seed, b=2):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(-1, 1, (b, 16, 16, 3)).astype(np.float32)
            for k in ("HR", "SR")}


class MaskFeed:
    """Numpy dropout masks (NHWC) drawn in call order by the port's Block,
    replayed in the same order on the JAX side."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.drawn = []

    def port_mask(self, x, keep, generator=None):
        b, c, h, w = x.shape
        m = self.rng.random((b, h, w, c)) < keep
        self.drawn.append(m)
        return torch.from_numpy(m).permute(0, 3, 1, 2)


_JAX_MASKS = []


def jax_dropout(x, key, rate, stored=False):
    """Stand-in for sr3_tpu.ops.dropout.dropout: the next numpy mask."""
    m = next(_JAX_MASKS[0])
    assert tuple(m.shape) == tuple(x.shape)
    keep = 1.0 - rate
    return jnp.where(m, x / jnp.asarray(keep, x.dtype), jnp.zeros((), x.dtype))


def test_block_dropout_path_matches_jax(monkeypatch):
    """Output and every gradient of a training Block with dropout (pre-bias
    FiLM, GroupNorm+SiLU, mask, conv3x3 + bias, residual) against the JAX
    Block on the same mask."""
    rng = np.random.default_rng(20)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, pb, res, g = f(2, 8, 8, 16), f(2, 16), f(2, 8, 8, 24), f(2, 8, 8, 24)
    jb = jax_unet.Block(24, groups=4, dropout=RATE)
    params = jb.init({"params": jax.random.PRNGKey(1)}, jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape)
        .astype(np.float32), params)
    feed = MaskFeed(21)
    monkeypatch.setattr(port_dropout, "dropout_mask", feed.port_mask)
    monkeypatch.setattr(jax_unet, "dropout", jax_dropout)

    pb_ = params["params"]
    block = Block(16, 24, groups=4, dropout=RATE).train()
    with torch.no_grad():
        block.block[0].weight.copy_(torch.from_numpy(pb_["norm"]["scale"]))
        block.block[0].bias.copy_(torch.from_numpy(pb_["norm"]["bias"]))
        block.block[3].weight.copy_(
            torch.from_numpy(pb_["conv"]["kernel"]).permute(3, 2, 0, 1))
        block.block[3].bias.copy_(torch.from_numpy(pb_["conv"]["bias"]))
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2) \
        .requires_grad_()
    tx, tres, tpb = nchw(x), nchw(res), torch.from_numpy(pb).requires_grad_()
    out = block(tx, pre_bias=tpb, residual=tres)
    out.backward(torch.from_numpy(g).permute(0, 3, 1, 2))

    _JAX_MASKS[:] = [iter(feed.drawn)]

    def f_jax(p, xx, pbb, rr):
        return jb.apply(p, xx, train=True, pre_bias=pbb, residual=rr,
                        rngs={"dropout": jax.random.PRNGKey(2)})

    ref, vjp = jax.vjp(f_jax, params, jnp.asarray(x), jnp.asarray(pb),
                       jnp.asarray(res))
    dp, dx, dpb, dres = vjp(jnp.asarray(g))
    nhwc = lambda t: t.detach().permute(0, 2, 3, 1).numpy()
    close = functools.partial(np.testing.assert_allclose, atol=2e-5, rtol=0)
    close(nhwc(out), np.asarray(ref))
    close(nhwc(tx.grad), np.asarray(dx))
    close(nhwc(tres.grad), np.asarray(dres))
    close(tpb.grad.numpy(), np.asarray(dpb))
    dp = dp["params"]
    close(block.block[0].weight.grad.numpy(), np.asarray(dp["norm"]["scale"]))
    close(block.block[0].bias.grad.numpy(), np.asarray(dp["norm"]["bias"]))
    close(block.block[3].weight.grad.permute(2, 3, 1, 0).numpy(),
          np.asarray(dp["conv"]["kernel"]))
    close(block.block[3].bias.grad.numpy(), np.asarray(dp["conv"]["bias"]))


def test_step_locked_training_matches_jax(monkeypatch):
    """5 Adam steps of the port's Trainer against the JAX p_losses + optax
    adam on carried weights, the same batch, noise, sqrt-gamma and masks."""
    steps, b = 5, 2
    diffusion, params = jax_model()
    trainer = port_trainer()
    feed = MaskFeed(30)
    monkeypatch.setattr(port_dropout, "dropout_mask", feed.port_mask)
    monkeypatch.setattr(jax_unet, "dropout", jax_dropout)
    injected = {}
    monkeypatch.setattr(trainer.diffusion, "p_losses", functools.partial(
        trainer.diffusion.p_losses, injected=injected))

    data = batch(31, b)
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
        return optax.apply_updates(params, updates), opt_state, loss, grads

    prev = np.sqrt(np.append(1.0, np.cumprod(1 - np.linspace(
        1e-6, 1e-2, 10))))
    rng = np.random.default_rng(32)
    opt_state = tx.init(params)
    losses_t, losses_j = [], []
    for step in range(steps):
        t = rng.integers(1, 11)
        gamma = rng.uniform(prev[t], prev[t - 1], (b, 1)).astype(np.float32)
        noise = rng.standard_normal((b, 16, 16, 3)).astype(np.float32)
        injected.update(noise=torch.from_numpy(noise).permute(0, 3, 1, 2),
                        sqrt_gamma=torch.from_numpy(gamma))
        feed.drawn = []
        trainer.feed_data(data)
        trainer.optimize_parameters()
        losses_t.append(trainer.get_current_log()["l_pix"])
        params, opt_state, lj, grads = jstep(
            params, opt_state, {"noise": noise, "sqrt_gamma": gamma},
            feed.drawn)
        losses_j.append(float(lj))
        if step == 0:
            assert len(feed.drawn) == 8  # one per ResnetBlock's block2
            ref = strip_reference_keys(flax_params_to_torch_state_dict(
                jax.tree_util.tree_map(np.asarray, grads),
                **unet_key_config(trainer.netG)))
            for name, p in trainer.netG.named_parameters():
                r = ref[name]
                tol = 1e-4 * np.abs(r).max()
                np.testing.assert_allclose(p.grad.numpy(), r, rtol=0,
                                           atol=tol, err_msg=name)
    np.testing.assert_allclose(losses_t, losses_j, rtol=5e-3, atol=5e-4)
    assert losses_t[0] != losses_t[-1]


def test_p_losses_draws_one_bin_per_step():
    """Every sample's sqrt-gamma lies in [prev[t], prev[t-1]] of one t."""
    trainer = create_model(tiny_opt(), device="cpu")
    trainer.set_new_noise_schedule(SCHED)
    prev = trainer.sched.sqrt_alphas_cumprod_prev.numpy()
    seen = []

    def net(x, level, generator=None):
        seen.append(level.numpy().copy())
        return torch.zeros_like(x[:, 3:])

    hr = torch.rand(8, 3, 16, 16) * 2 - 1
    for _ in range(20):
        loss = trainer.diffusion.p_losses(net, trainer.sched,
                                          {"HR": hr, "SR": hr},
                                          trainer.generator)
        assert loss.ndim == 0 and torch.isfinite(loss)
    bins = set()
    for level in seen:
        ts = [t for t in range(1, 11)
              if np.all((level <= prev[t - 1] + 1e-7)
                        & (level >= prev[t] - 1e-7))]
        assert ts, level
        bins.add(ts[0])
    assert len(bins) > 1


def _graph_names(t):
    names, todo, seen = set(), [t.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


def test_unet_every_parameter_gets_a_gradient_through_the_functions():
    net = define_G(tiny_opt(), device="cpu").denoise_fn.train()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 6, 16, 16, generator=g)
    out = net(x, torch.tensor([0.3, 0.8]), generator=g)
    names = _graph_names(out)
    for fn in ("_GnSiluConv3x3Backward", "_GroupNormBackward",
               "_FlashAttentionBackward"):
        assert fn in names, (fn, sorted(names))
    out.square().mean().backward()
    for name, p in net.named_parameters():
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0, name


def test_ema_follows_the_jax_rule():
    trainer = port_trainer(use_ema=True, lr=1e-2, step_start_ema=2)
    trainer.feed_data(batch(40))
    expect = {n: p.detach().clone() for n, p in trainer.netG.named_parameters()}
    for step in range(4):
        trainer.optimize_parameters()
        for n, p in trainer.netG.named_parameters():
            q = p.detach()
            expect[n] = (0.9 * expect[n] + 0.1 * q) if step >= 2 else q.clone()
    for n, e in trainer.ema.items():
        torch.testing.assert_close(e, expect[n], rtol=0, atol=1e-6)
    assert trainer.step == 4


def test_finetune_norm_freezes_and_zero_inits():
    net = torch.nn.ModuleDict({"transformer_proj": torch.nn.Linear(3, 3),
                               "conv": torch.nn.Linear(3, 3)})
    before = net["conv"].weight.detach().clone()
    trainable = finetune_norm(net)
    assert [id(p) for p in trainable] == [
        id(p) for p in net["transformer_proj"].parameters()]
    assert all(not p.any() and p.requires_grad for p in trainable)
    assert not net["conv"].weight.requires_grad
    assert torch.equal(net["conv"].weight, before)
    # the sr3 UNet has no parameter named 'transformer': all of it freezes
    trainer = port_trainer(finetune=True)
    assert trainer.optimizer is None
    assert not any(p.requires_grad for p in trainer.netG.parameters())
    before = copy.deepcopy(trainer.netG.state_dict())
    trainer.feed_data(batch(41))
    trainer.optimize_parameters()
    assert np.isfinite(trainer.get_current_log()["l_pix"])
    for k, v in trainer.netG.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("dtype,use_ema", [("bfloat16", False),
                                           ("float32", True),
                                           ("bfloat16", True)])
def test_eval_params_follow_the_weights(dtype, use_ema):
    """The sampling network holds the weights after the last step (the EMA
    weights with EMA on), not a copy frozen at its first use."""
    trainer = port_trainer(dtype=dtype, use_ema=use_ema, lr=1e-2,
                           step_start_ema=1)
    with torch.inference_mode():  # as a first sampling call makes it
        first = trainer._eval_params()
    before = [p.detach().clone() for p in trainer.netG.parameters()]
    trainer.feed_data(batch(42))
    for _ in range(2):
        trainer.optimize_parameters()
    net = trainer._eval_params()
    assert net is first and not net.training
    src = trainer.ema if use_ema else dict(trainer.netG.named_parameters())
    for name, p in net.named_parameters():
        want = src[name].detach()
        if dtype == "bfloat16" and p.dim() >= 2:
            want = want.to(torch.bfloat16)
        assert p.dtype == want.dtype and torch.equal(p, want), name
    assert any(not torch.equal(p.detach(), b)
               for p, b in zip(trainer.netG.parameters(), before))


def test_saved_gen_pth_loads_and_round_trips_into_jax(tmp_path):
    trainer = port_trainer(tmp_path)
    trainer.feed_data(batch(43))
    trainer.optimize_parameters()
    trainer.save_network(1, 1)
    sd = torch.load(tmp_path / "I1_E1_gen.pth", weights_only=True)
    net = define_G(tiny_opt(), device="cpu").denoise_fn
    load_gen_pth(net, str(tmp_path / "I1_E1_gen.pth"))
    for k, v in trainer.netG.state_dict().items():
        assert torch.equal(net.state_dict()[k], v), k

    diffusion, _ = jax_model()
    params = torch_state_dict_to_flax(sd, **unet_key_config(net))
    rng = np.random.default_rng(44)
    x = rng.standard_normal((2, 16, 16, 6)).astype(np.float32)
    cond = np.asarray([0.2, 0.9], np.float32)
    ref = diffusion.denoise_fn.apply(params, x, cond, train=False)
    with torch.inference_mode():
        out = net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2),
                         torch.from_numpy(cond))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=1e-4, rtol=0)


def test_resume_restores_counters_optimizer_and_ema(tmp_path):
    trainer = port_trainer(tmp_path, use_ema=True, step_start_ema=0)
    trainer.feed_data(batch(45))
    for _ in range(2):
        trainer.optimize_parameters()
    trainer.save_network(3, 2)
    resumed = create_model(tiny_opt(tmp_path, use_ema=True,
                                    resume_state=str(tmp_path / "I2_E3")),
                           device="cpu")
    assert (resumed.begin_step, resumed.begin_epoch, resumed.step) == (2, 3, 2)
    for k, v in trainer.netG.state_dict().items():
        assert torch.equal(resumed.netG.state_dict()[k], v), k
    for k, v in trainer.ema.items():
        assert torch.equal(resumed.ema[k], v), k
    a, b = trainer.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i, st in a["state"].items():
        for key, val in st.items():
            assert torch.equal(val, b["state"][i][key]), (i, key)


def test_mu_dtype_bfloat16_is_not_ported():
    """Since the bf16 first moment was ported (tests/test_torch_port_optim.py
    holds it against optax) the option builds a trainer whose Adam keeps
    exp_avg in bfloat16 and exp_avg_sq in float32; other dtypes raise."""
    opt = tiny_opt()
    opt["train"]["optimizer"]["mu_dtype"] = "bfloat16"
    trainer = create_model(opt, device="cpu")
    trainer.set_new_noise_schedule(SCHED)
    trainer.feed_data(batch(46))
    trainer.optimize_parameters()
    for p in trainer.netG.parameters():
        state = trainer.optimizer.state[p]
        assert state["exp_avg"].dtype == torch.bfloat16
        assert state["exp_avg_sq"].dtype == torch.float32
    opt["train"]["optimizer"]["mu_dtype"] = "float16"
    with pytest.raises(ValueError, match="mu_dtype"):
        create_model(opt, device="cpu")


def test_loader_shuffles_with_its_seed_and_drops_the_last_batch():
    items = [{"HR": np.full((2, 2, 3), i, np.float32), "Index": i}
             for i in range(7)]
    loader = DataLoader(items, batch_size=3, shuffle=True, drop_last=True,
                        seed=5)
    assert len(loader) == 2
    epochs = [list(loader) for _ in range(2)]
    for ep in epochs:
        assert [b["HR"].shape for b in ep] == [(3, 2, 2, 3)] * 2
        idx = np.concatenate([b["Index"] for b in ep])
        assert len(set(idx.tolist())) == 6
        np.testing.assert_array_equal(idx, np.concatenate(
            [b["HR"][:, 0, 0, 0] for b in ep]))
    again = [b["Index"] for b in DataLoader(items, 3, True, True, seed=5)]
    np.testing.assert_array_equal(np.concatenate(again),
                                  np.concatenate([b["Index"] for b in epochs[0]]))
    assert len(DataLoader(items, 3)) == 3
