"""The port's model axis (parameters sharded on their output channels) on
2 gloo ranks on the CPU.

The tiny two-level sr3 model with the JAX package's initialised weights
(1-D leaves perturbed from a numpy seed). Checked: every parameter's
sharded dimension against ``make_param_shardings`` of the JAX tree on a
``create_mesh(num_model=2)`` mesh, after the converter's name map; the
forward, the loss and the gradients of one training step (the trainer's
own draws; the model ranks draw what one process draws) against one
process, 1e-5 (gradients relative to each leaf's max|g|), and the
parameters and EMA after its Adam step 1e-5; a gather whose backward
summed (m times the gradient); a checkpoint written by the ranks loading
in the single-device port bit for bit.
"""

import os

import jax
import numpy as np
import pytest
import torch

from sr3_tpu.models.networks import define_G as jax_define_G
from sr3_tpu.models.networks import init_params
from sr3_tpu.parallel.mesh import create_mesh
from sr3_tpu.parallel.sharding_rules import make_param_shardings
from sr3_tpu.utils.torch_compat import flax_params_to_torch_state_dict
from sr3_tpu_torch.training.trainer import create_model
from sr3_tpu_torch.utils.torch_compat import (load_flax_params,
                                              strip_reference_keys,
                                              unet_key_config)
from tests.torch_port_parallel_common import (SCHED, assert_leaves_close,
                                              run_ranks, tiny_opt,
                                              unet_kwargs)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2) \
        .contiguous(memory_format=torch.channels_last)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("model2"))
    rng = np.random.default_rng(20)
    opt = tiny_opt()
    jdiff = jax_define_G(opt)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.1 * rng.standard_normal(p.shape))
        .astype(np.float32) if p.ndim == 1 else np.asarray(p),
        init_params(jdiff, jax.random.PRNGKey(0)))
    one = create_model(opt, device="cpu")
    load_flax_params(one.netG, params)
    prefix = os.path.join(tmp, "w")
    torch.save(one.netG.state_dict(), prefix + "_gen.pth")
    ref = {}
    # the JAX rule: a leaf is sharded when its spec names 'model'
    shard = make_param_shardings(params, create_mesh(num_data=1, num_model=2))
    marks = jax.tree_util.tree_map(
        lambda p, sh: np.full(p.shape, float("model" in tuple(sh.spec)),
                              np.float32), params, shard)
    marks = strip_reference_keys(flax_params_to_torch_state_dict(
        marks, **unet_key_config(one.netG)))
    ref["sharded"] = sorted(n for n, m in marks.items() if m.all())
    assert all(m.all() or not m.any() for m in marks.values())

    fwd_x, fwd_t = (rng.standard_normal((2, 16, 16, 6)).astype(np.float32),
                    np.array([0.3, 0.8], np.float32))
    with torch.no_grad():
        ref["out"] = one.netG.eval()(nchw(fwd_x),
                                     torch.from_numpy(fwd_t)).numpy()
    batch = {k: rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
             for k in ("HR", "SR")}
    tr = create_model(tiny_opt(resume=prefix, batch=2, use_ema=True),
                      device="cpu")
    tr.set_new_noise_schedule(SCHED)
    tr.feed_data(batch)
    tr.optimize_parameters()
    ref["loss"] = tr.get_current_log()["l_pix"]
    for key, vals in (("grads", ((n, p.grad) for n, p
                                 in tr.netG.named_parameters())),
                      ("params", tr.netG.named_parameters()),
                      ("ema", tr.ema.items())):
        ref[key] = {n: v.detach().numpy().copy() for n, v in vals}
    ref["numel"] = sum(p.numel() for p in tr.netG.parameters())

    ref["gw"] = rng.standard_normal((3, 8)).astype(np.float32)
    ref["gp"] = rng.standard_normal(4).astype(np.float32)
    ckpt = os.path.join(tmp, "ckpt")
    os.makedirs(ckpt)
    par = {"model": 2}
    spec = {"parallel": par,
            "cases": ["mesh", "forward", "loss_grads", "gather_sum"],
            "unet": unet_kwargs(opt), "state": one.netG.state_dict(),
            "fwd_x": fwd_x, "fwd_t": fwd_t, "sched": SCHED, "batch": batch,
            "train_opt": tiny_opt(resume=prefix, ckpt=ckpt, batch=2,
                                  use_ema=True, parallel=par),
            "checkpoint": True, "gw": ref["gw"], "gp": ref["gp"]}
    return ref, run_ranks(os.path.join(tmp, "ranks"), 2, spec), ckpt


def test_model2_mesh_coordinates(runs):
    _, ranks, _ = runs
    assert [r["mesh"]["coords"] for r in ranks] == [(0, 0, 0), (0, 1, 0)]


def test_model2_sharded_parameters_follow_the_jax_rule(runs):
    ref, ranks, _ = runs
    for r in ranks:
        assert r["loss_grads"]["sharded"] == ref["sharded"]
    # every leaf but final_conv's conv (C_out 3) is sharded
    assert len(ref["sharded"]) > 0.9 * len(ref["params"])
    # each rank keeps about half of the parameters
    local = ranks[0]["loss_grads"]["local_numel"]
    assert local < 0.52 * ref["numel"]


def test_model2_forward_matches_unsharded(runs):
    ref, ranks, _ = runs
    for r in ranks:
        np.testing.assert_allclose(r["forward"]["out"], ref["out"], rtol=0,
                                   atol=1e-5)


def test_model2_train_step_matches_unsharded(runs):
    ref, ranks, _ = runs
    for r in ranks:
        got = r["loss_grads"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        assert_leaves_close(got["grads"], ref["grads"], 1e-5)
        for key in ("params", "ema"):
            for n, v in ref[key].items():
                np.testing.assert_allclose(got[key][n], v, rtol=0, atol=1e-5,
                                           err_msg=f"{key} {n}")


def test_model2_gather_backward_keeps_the_slice_and_does_not_sum(runs):
    """d/dx sum(w * gather(x)), every rank holding the same w, is w's
    slice on each rank: a backward that summed would give 2 w."""
    ref, ranks, _ = runs
    dx = np.concatenate([r["gather_sum"]["dx"] for r in ranks], axis=1)
    dp = np.concatenate([r["gather_sum"]["dp"] for r in ranks])
    np.testing.assert_array_equal(dx, ref["gw"])
    np.testing.assert_array_equal(dp, ref["gp"])


def test_model2_checkpoint_loads_in_one_process(runs):
    _, ranks, ckpt = runs
    assert sorted(os.listdir(ckpt)) == ["I1_E1_gen.pth", "I1_E1_opt.pth"]
    one = create_model(tiny_opt(resume=os.path.join(ckpt, "I1_E1"), batch=2,
                                use_ema=True), device="cpu")
    got = ranks[0]["loss_grads"]
    for n, p in one.netG.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), got["params"][n])
        np.testing.assert_array_equal(one.ema[n].numpy(), got["ema"][n])
    # the Adam moments are whole too
    st = one.optimizer.state_dict()["state"]
    assert all(st[i]["exp_avg"].shape == p.shape
               for i, p in enumerate(one.netG.parameters()))
