"""The port's space axis (activations sharded on H) on 2 and 4 gloo ranks
on the CPU: the counterpart of tests/test_spatial.py; and space with the
model axis, on a 2 x 2 (model, space) mesh of 4 ranks.

Two tiny sr3 models carry the JAX package's initialised weights (1-D
leaves perturbed from a numpy seed): the two-level one (16^2 and 8^2,
attention at 8^2) on 2 ranks, with remat in its training step, and a
three-level one on 4 ranks, whose 4^2 level (one row a rank) runs
replicated: gathered on the way in, re-sliced on the way up. The
two-level one also runs on the (model 2, space 2) mesh: K1's halo entry
with the weight's channel slice, held to the same references.

Tolerances: ``halo_exchange`` exact against slicing; the plain halo K1 on
the shards against the plain unsharded K1 1e-6 of max|y| (float32 sums of
the statistics in another order), its gradients summed over the ranks
1e-5 of each max|g|; the sharded UNet forward and the T=8 chain against
the unsharded port atol 2e-5 (as test_spatial.py holds JAX); the chain
against the JAX chain under ``spatial_constraint`` atol 5e-4 (the port's
chain tolerance); one training step (the trainer's own draws: noise and
dropout at full size, which must equal one process's) loss rtol 1e-6,
gradients atol 1e-5.
"""

import os

import jax
import numpy as np
import pytest
import torch

from sr3_tpu.models.networks import define_G as jax_define_G
from sr3_tpu.models.networks import init_params
from sr3_tpu.models.schedule import make_schedule as jax_make_schedule
from sr3_tpu.parallel.mesh import create_mesh
from sr3_tpu.parallel.spatial import spatial_constraint
from sr3_tpu_torch.models.diffusion import GaussianDiffusion
from sr3_tpu_torch.models.schedule import make_schedule
from sr3_tpu_torch.ops.conv_fused import gn_silu_conv3x3_plain
from sr3_tpu_torch.parallel.spatial import sharded
from sr3_tpu_torch.training.trainer import create_model
from sr3_tpu_torch.utils.torch_compat import load_flax_params
from tests.torch_port_parallel_common import (SCHED, T, run_ranks, tiny_opt,
                                              unet_kwargs)

CASES = ["mesh", "halo", "halo_k1", "forward", "chain", "loss_grads"]
# the (model 2, space 2) mesh runs the two-level model's UNet cases
MODEL_SPACE = {"model": 2, "space": 2}
MODEL_SPACE_CASES = ["mesh", "forward", "chain", "loss_grads"]
COORDS = {2: [(0, 0, 0), (0, 0, 1)],
          4: [(0, 0, r) for r in range(4)],
          "m2s2": [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1)]}
LAYOUTS = {2: {"channel_multiplier": [1, 2], "remat": True},
           4: {"channel_multiplier": [1, 2, 2]}}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2) \
        .contiguous(memory_format=torch.channels_last)


def _one(s, tmp):
    """The references of one layout and its ranks' results."""
    rng = np.random.default_rng(10 + s)
    opt = tiny_opt(**LAYOUTS[s])
    jdiff = jax_define_G(opt)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.1 * rng.standard_normal(p.shape))
        .astype(np.float32) if p.ndim == 1 else np.asarray(p),
        init_params(jdiff, jax.random.PRNGKey(0)))
    one = create_model(opt, device="cpu")
    load_flax_params(one.netG, params)
    prefix = os.path.join(tmp, "w")
    torch.save(one.netG.state_dict(), prefix + "_gen.pth")
    net = one.netG.eval()
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    ref = {}

    # halo rows of a plain map; the plain K1 on the whole map
    x = f(2, 8, 16, 5)
    k1 = {"x": f(2, 16, 16, 16), "gw": 1 + 0.1 * f(16), "gb": 0.1 * f(16),
          "w": 0.1 * f(8, 16, 3, 3), "b": 0.1 * f(8), "pb": f(2, 16),
          "res": f(2, 8, 16, 16)}
    k1_g = f(2, 8, 16, 16)
    leaves = {n: torch.from_numpy(v).requires_grad_() for n, v in k1.items()}
    cl = lambda t: t.contiguous(memory_format=torch.channels_last)
    y = gn_silu_conv3x3_plain(cl(leaves["x"]), leaves["gw"], leaves["gb"],
                              cl(leaves["w"]), leaves["b"], 4,
                              pre_bias=leaves["pb"],
                              residual=cl(leaves["res"]))
    (y * torch.from_numpy(k1_g)).sum().backward()
    ref["k1_y"] = y.detach().numpy()
    ref["k1_grads"] = {n: t.grad.numpy() for n, t in leaves.items()}

    # UNet forward and chain, unsharded
    fwd_x, fwd_t = f(2, 16, 16, 6), np.array([0.3, 0.8], np.float32)
    with torch.no_grad():
        ref["out"] = net(nchw(fwd_x), torch.from_numpy(fwd_t)).numpy()
    cond = 0.5 * f(2, 16, 16, 3)
    init, steps = f(2, 16, 16, 3), f(T, 2, 16, 16, 3)
    stream = (nchw(init), torch.from_numpy(steps).permute(0, 1, 4, 2, 3))
    diff = GaussianDiffusion(net, 16)
    with torch.no_grad():
        ref["frames"] = diff.p_sample_loop(
            net, make_schedule(SCHED), nchw(cond), continuous=True,
            noise_stream=stream).numpy()
    # the JAX chain under spatial_constraint on a 'space' mesh
    jdiff.shard_activations = spatial_constraint(
        create_mesh(num_data=1, num_space=s))
    ref["jax_frames"] = np.asarray(jax.jit(
        lambda p, c, ns: jdiff.p_sample_loop(
            p, jax_make_schedule(SCHED), c, jax.random.PRNGKey(0),
            continuous=True, noise_stream=ns))(params, cond, (init, steps)))

    # one training step with the trainer's own draws
    batch = {k: rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
             for k in ("HR", "SR")}
    tr = create_model(tiny_opt(resume=prefix, batch=2, **LAYOUTS[s]),
                      device="cpu")
    tr.set_new_noise_schedule(SCHED)
    tr.feed_data(batch)
    tr.optimize_parameters()
    ref["loss"] = tr.get_current_log()["l_pix"]
    ref["grads"] = {n: p.grad.numpy().copy()
                    for n, p in tr.netG.named_parameters()}

    par = {"space": s}
    spec = {"parallel": par, "cases": CASES, "x": x, "k1": k1,
            "k1_g": k1_g, "groups": 4, "unet": unet_kwargs(opt),
            "state": one.netG.state_dict(), "fwd_x": fwd_x, "fwd_t": fwd_t,
            "sched": SCHED, "cond": cond, "stream": (init, steps),
            "batch": batch,
            "train_opt": tiny_opt(resume=prefix, batch=2, parallel=par,
                                  **LAYOUTS[s])}
    ranks = run_ranks(os.path.join(tmp, "ranks"), s, spec)
    out = {s: {"x": x, "ref": ref, "ranks": ranks}}
    if s == 2:
        spec.update(parallel=MODEL_SPACE, cases=MODEL_SPACE_CASES,
                    train_opt=tiny_opt(resume=prefix, batch=2,
                                       parallel=MODEL_SPACE, **LAYOUTS[s]))
        out["m2s2"] = {"ref": ref, "ranks": run_ranks(
            os.path.join(tmp, "ranks_m2s2"), 4, spec)}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for s in (2, 4):
        out.update(_one(s, str(tmp_path_factory.mktemp(f"space{s}"))))
    return out


@pytest.mark.parametrize("s", [2, 4, "m2s2"])
def test_space_mesh_coordinates(runs, s):
    assert [r["mesh"]["coords"] for r in runs[s]["ranks"]] == COORDS[s]


@pytest.mark.parametrize("s", [2, 4])
def test_halo_exchange_against_slicing(runs, s):
    x = runs[s]["x"]
    h = x.shape[2] // s
    zero = np.zeros_like(x[:, :, :1])
    dx = np.zeros_like(x)
    for r, got in enumerate(runs[s]["ranks"]):
        got = got["halo"]
        top = x[:, :, r * h - 1:r * h] if r > 0 else zero
        bottom = x[:, :, (r + 1) * h:(r + 1) * h + 1] if r < s - 1 else zero
        np.testing.assert_array_equal(got["top"], top)
        np.testing.assert_array_equal(got["bottom"], bottom)
        # the gradient each rank's halo rows send back to their owners
        g = np.random.default_rng(100 + r)
        gt = g.standard_normal(zero.shape).astype(np.float32)
        gb = g.standard_normal(zero.shape).astype(np.float32)
        if r > 0:
            dx[:, :, r * h - 1] += gt[:, :, 0]
        if r < s - 1:
            dx[:, :, (r + 1) * h] += gb[:, :, 0]
    np.testing.assert_allclose(sum(g["halo"]["dx"] for g in runs[s]["ranks"]),
                               dx, rtol=0, atol=1e-7)


@pytest.mark.parametrize("s", [2, 4])
def test_halo_k1_on_shards_matches_the_unsharded_plain_k1(runs, s):
    ref = runs[s]["ref"]
    y = np.concatenate([r["halo_k1"]["y"] for r in runs[s]["ranks"]], axis=2)
    tol = 1e-6 * np.abs(ref["k1_y"]).max()
    np.testing.assert_allclose(y, ref["k1_y"], rtol=0, atol=tol)
    for name, g in ref["k1_grads"].items():
        got = sum(r["halo_k1"]["grads"][name] for r in runs[s]["ranks"])
        np.testing.assert_allclose(got, g, rtol=0,
                                   atol=1e-5 * np.abs(g).max(), err_msg=name)


@pytest.mark.parametrize("s", [2, 4, "m2s2"])
def test_sharded_unet_forward_matches_unsharded(runs, s):
    for r in runs[s]["ranks"]:
        np.testing.assert_allclose(r["forward"]["out"], runs[s]["ref"]["out"],
                                   rtol=0, atol=2e-5)


@pytest.mark.parametrize("s", [2, 4, "m2s2"])
def test_sharded_chain_matches_unsharded_and_jax(runs, s):
    ref = runs[s]["ref"]
    jax_frames = ref["jax_frames"].transpose(0, 3, 1, 2)
    for r in runs[s]["ranks"]:
        frames = r["chain"]["frames"]
        np.testing.assert_allclose(frames, ref["frames"], rtol=0, atol=2e-5)
        np.testing.assert_allclose(frames, jax_frames, rtol=0, atol=5e-4)


@pytest.mark.parametrize("s", [2, 4, "m2s2"])
def test_sharded_train_step_matches_unsharded(runs, s):
    ref = runs[s]["ref"]
    for r in runs[s]["ranks"]:
        got = r["loss_grads"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-6)
        if s == "m2s2":  # the model axis holds half of each sharded leaf
            assert got["sharded"] and got["local_numel"] < sum(
                g.size for g in ref["grads"].values())
        for name, g in ref["grads"].items():
            np.testing.assert_allclose(got["grads"][name], g, rtol=0,
                                       atol=1e-5, err_msg=name)


def test_the_four_rank_layout_has_a_replicated_level():
    axis = type("A", (), {"size": 4})()
    assert [sharded(h, axis) for h in (16, 8, 4)] == [True, True, False]
