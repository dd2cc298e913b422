"""The port's data axis: two gloo ranks on the CPU against one process and
against the JAX package's data mesh.

Both ranks and the references start from the same weights (the JAX tiny
sr3 model's, 1-D leaves perturbed from a numpy seed, carried over with the
converter) and take one Adam step on the same global batch of 4 with the
same injected noise, sqrt-gamma and dropout masks (recorded from the
one-process port in call order; each rank replays its batch rows).
Tolerances: the one-process port, loss 1e-6 relative, the all-reduced
gradients 1e-6 of each leaf's max|g| (the same float32 sums, split in two),
parameters and EMA after the step 1e-5 (Adam's first step divides by |g|,
so a near-zero gradient can flip its update; as the port's step-locked
Adam tests); the JAX ``create_mesh(num_data=2)`` step, loss 1e-5, gradients
1e-5 of max|g|; grouped SR frames over 2 ranks against one process 1e-5; a
checkpoint written by the ranks loads in the single-device port bit for
bit.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import sr3_tpu.models.unet as jax_unet
from sr3_tpu.models.networks import define_G as jax_define_G
from sr3_tpu.models.networks import init_params
from sr3_tpu.models.schedule import make_schedule as jax_make_schedule
from sr3_tpu.parallel.mesh import create_mesh, shard_batch
from sr3_tpu.utils.torch_compat import flax_params_to_torch_state_dict
from sr3_tpu_torch.data.loader import DataLoader
from sr3_tpu_torch.ops import dropout as port_dropout
from sr3_tpu_torch.parallel.mesh import Mesh
from sr3_tpu_torch.training.evaluation import GroupedEvaluator
from sr3_tpu_torch.training.trainer import create_model
from sr3_tpu_torch.utils.torch_compat import (load_flax_params,
                                              strip_reference_keys,
                                              unet_key_config)
from tests.torch_port_parallel_common import (SCHED, MaskFeed,
                                              assert_leaves_close, run_ranks,
                                              tiny_opt)

B = 4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


_JAX_MASKS = []


def _jax_dropout(x, key, rate, stored=False):
    m = next(_JAX_MASKS[0])
    return jnp.where(m, x / jnp.asarray(1.0 - rate, x.dtype),
                     jnp.zeros((), x.dtype))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("data2"))
    diffusion = jax_define_G(tiny_opt())
    rng = np.random.default_rng(100)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.1 * rng.standard_normal(p.shape))
        .astype(np.float32) if p.ndim == 1 else np.asarray(p),
        init_params(diffusion, jax.random.PRNGKey(0)))

    # the weights every side starts from, as a resume checkpoint
    t0 = create_model(tiny_opt(), device="cpu")
    load_flax_params(t0.netG, params)
    prefix = os.path.join(tmp, "w")
    torch.save(t0.netG.state_dict(), prefix + "_gen.pth")

    rng = np.random.default_rng(7)
    batch = {k: rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32)
             for k in ("HR", "SR")}
    prev = np.sqrt(np.append(1.0, np.cumprod(1 - np.linspace(1e-6, 1e-2,
                                                              8))))
    gamma = rng.uniform(prev[3], prev[2], (B, 1)).astype(np.float32)
    noise = rng.standard_normal((B, 16, 16, 3)).astype(np.float32)

    # one process
    one = create_model(tiny_opt(resume=prefix, use_ema=True), device="cpu")
    one.set_new_noise_schedule(SCHED)
    feed = MaskFeed(8)
    mp = pytest.MonkeyPatch()
    mp.setattr(port_dropout, "dropout_mask", feed.port_mask)
    one.diffusion.p_losses = functools.partial(
        one.diffusion.p_losses,
        injected={"noise": torch.from_numpy(noise).permute(0, 3, 1, 2),
                  "sqrt_gamma": torch.from_numpy(gamma)})
    one.feed_data(batch)
    one.optimize_parameters()
    mp.undo()
    ref = {"loss": one.get_current_log()["l_pix"],
           "grads": {n: p.grad.numpy().copy()
                     for n, p in one.netG.named_parameters()},
           "params": {n: p.detach().numpy().copy()
                      for n, p in one.netG.named_parameters()},
           "ema": {n: v.numpy().copy() for n, v in one.ema.items()}}

    # the JAX package's data mesh: batch sharded, parameters replicated
    mesh = create_mesh(num_data=2)
    jbatch = shard_batch(batch, mesh)
    jparams = jax.device_put(params, NamedSharding(mesh, P()))
    mp.setattr(jax_unet, "dropout", _jax_dropout)
    _JAX_MASKS[:] = [iter(feed.drawn)]
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: diffusion.p_losses(
            p, jax_make_schedule(SCHED), jbatch, jax.random.PRNGKey(0),
            train=True, injected={"noise": noise, "sqrt_gamma": gamma})))(
        jparams)
    mp.undo()
    ref["jax_loss"] = float(loss_j)
    ref["jax_grads"] = strip_reference_keys(flax_params_to_torch_state_dict(
        jax.tree_util.tree_map(np.asarray, grads_j),
        **unet_key_config(one.netG)))

    # grouped SR in one process
    items = [(0.5 * rng.standard_normal((16, 16, 3))).astype(np.float32)
             for _ in range(4)]
    val_opt = tiny_opt("val", resume=prefix)
    sr = create_model(val_opt, device="cpu")
    sr.set_new_noise_schedule(SCHED, "val")
    ref["frames"] = np.stack([f for _, f in GroupedEvaluator(
        sr, 4, base_seed=123).run_sr([{"SR": x} for x in items], True)])

    ckpt = os.path.join(tmp, "ckpt")
    os.makedirs(ckpt)
    par = {"data": 2}
    spec = {"parallel": par, "cases": ["mesh", "train_step", "run_sr"],
            "train_opt": tiny_opt(resume=prefix, ckpt=ckpt, use_ema=True,
                                  parallel=par),
            "val_opt": tiny_opt("val", resume=prefix, parallel=par),
            "sched": SCHED, "batch": batch, "noise": noise, "gamma": gamma,
            "masks": feed.drawn, "checkpoint": True, "group": 4,
            "items": items}
    ranks = run_ranks(os.path.join(tmp, "ranks"), 2, spec)
    return ref, ranks, ckpt


def test_data2_mesh_coordinates(runs):
    _, ranks, _ = runs
    assert [r["mesh"]["coords"] for r in ranks] == [(0, 0, 0), (1, 0, 0)]
    assert [r["mesh"]["primary"] for r in ranks] == [True, False]


def test_data2_step_matches_one_process(runs):
    ref, ranks, _ = runs
    for r in ranks:
        got = r["train_step"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-6)
        assert_leaves_close(got["grads"], ref["grads"], 1e-6)
    # bit-equal across ranks (the same all-reduced gradients and update)
    a, b = (r["train_step"] for r in ranks)
    for n in a["params"]:
        np.testing.assert_array_equal(a["params"][n], b["params"][n])
        np.testing.assert_array_equal(a["ema"][n], b["ema"][n])


def test_data2_params_and_ema_after_the_step(runs):
    ref, ranks, _ = runs
    got = ranks[0]["train_step"]
    for key in ("params", "ema"):
        for n, r in ref[key].items():
            np.testing.assert_allclose(got[key][n], r, rtol=0, atol=1e-5,
                                       err_msg=f"{key} {n}")
    assert got["reduced_bytes"] == 4 * sum(v.size for v in got["grads"]
                                           .values())


def test_data2_step_matches_the_jax_data_mesh(runs):
    ref, ranks, _ = runs
    got = ranks[0]["train_step"]
    np.testing.assert_allclose(got["loss"], ref["jax_loss"], rtol=1e-5)
    assert_leaves_close(got["grads"], ref["jax_grads"], 1e-5)


def test_data2_grouped_sr_matches_one_process(runs):
    ref, ranks, _ = runs
    for r in ranks:
        np.testing.assert_allclose(r["run_sr"]["frames"], ref["frames"],
                                   rtol=0, atol=1e-5)


def test_data2_checkpoint_is_written_once_and_loads_in_one_process(runs):
    _, ranks, ckpt = runs
    assert sorted(os.listdir(ckpt)) == ["I1_E1_gen.pth", "I1_E1_opt.pth"]
    opt = tiny_opt(resume=os.path.join(ckpt, "I1_E1"), use_ema=True)
    one = create_model(opt, device="cpu")
    got = ranks[0]["train_step"]
    assert one.begin_step == 1
    for n, p in one.netG.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), got["params"][n])
        np.testing.assert_array_equal(one.ema[n].numpy(), got["ema"][n])


def test_data_axis_must_divide_the_global_batch():
    mesh = Mesh({"data": 2}, "cpu", "gloo")  # one process: no collective
    with pytest.raises(ValueError, match="data axis"):
        create_model(tiny_opt(batch=3), device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="data axis"):
        DataLoader(list(range(9)), batch_size=3, shard=(0, 2))
