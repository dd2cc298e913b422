"""The port's reverse chain against the JAX package's, and the grouping
invariance of its grouped evaluator.

The same numpy noise stream (initial noise and one draw per step) feeds the
JAX ``p_sample_loop(noise_stream=...)`` and the port's, on the same carried
weights of a small sr3 UNet with attention, T=10, float32 on the CPU. Every
process frame must agree within atol 5e-4: ten chained float32 UNet steps,
each amplifying the previous step's float32 rounding.
"""

import jax
import numpy as np
import pytest
import torch

from sr3_tpu.models.networks import define_G as jax_define_G
from sr3_tpu.models.networks import init_params
from sr3_tpu.models.schedule import make_schedule as jax_make_schedule
from sr3_tpu_torch.models.networks import define_G
from sr3_tpu_torch.models.schedule import make_schedule
from sr3_tpu_torch.training.evaluation import GroupedEvaluator, _group_size
from sr3_tpu_torch.training.trainer import create_model
from sr3_tpu_torch.utils.torch_compat import load_flax_params

T = 10
SCHED = {"schedule": "linear", "n_timestep": T, "linear_start": 1e-6,
         "linear_end": 1e-2}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_opt():
    return {
        "name": "tiny", "phase": "val", "path": {"resume_state": None},
        "model": {
            "which_model_G": "sr3", "dtype": "float32",
            "unet": {"in_channel": 6, "out_channel": 3, "inner_channel": 16,
                     "norm_groups": 8, "channel_multiplier": [1, 2],
                     "attn_res": [8], "res_blocks": 1, "dropout": 0.0},
            "beta_schedule": {"val": dict(SCHED)},
            "diffusion": {"image_size": 16, "channels": 3,
                          "conditional": True},
        },
    }


def test_p_sample_loop_frames_match_jax():
    opt = tiny_opt()
    jdiff = jax_define_G(opt)
    params = jax.tree_util.tree_map(
        np.asarray, init_params(jdiff, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda p: (p + 0.1 * rng.standard_normal(p.shape)).astype(np.float32)
        if p.ndim == 1 else p, params)
    diff = define_G(opt, device="cpu")
    load_flax_params(diff.denoise_fn, params)

    cond = (0.5 * rng.standard_normal((2, 16, 16, 3))).astype(np.float32)
    init = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    steps = rng.standard_normal((T, 2, 16, 16, 3)).astype(np.float32)
    jsched = jax_make_schedule(SCHED)
    ref = np.asarray(jax.jit(
        lambda p, x, ns: jdiff.p_sample_loop(
            p, jsched, x, jax.random.PRNGKey(0), continuous=True,
            noise_stream=ns))(params, cond, (init, steps)))

    t = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    ns = (t(init), torch.from_numpy(steps).permute(0, 1, 4, 2, 3))
    sched = make_schedule(SCHED)
    with torch.inference_mode():
        frames = diff.p_sample_loop(diff.denoise_fn, sched, t(cond),
                                    continuous=True, noise_stream=ns)
        final = diff.p_sample_loop(diff.denoise_fn, sched, t(cond),
                                   noise_stream=ns)
    frames = frames.permute(0, 2, 3, 1).numpy()
    assert frames.shape == ref.shape == ((1 + T) * 2, 16, 16, 3)
    np.testing.assert_allclose(frames, ref, atol=5e-4, rtol=0)
    np.testing.assert_allclose(final.permute(0, 2, 3, 1).numpy(), ref[-2:],
                               atol=5e-4, rtol=0)


def _run(trainer, items, group, base_seed, continous=False):
    ev = GroupedEvaluator(trainer, group, base_seed=base_seed)
    return [out for _, out in ev.run_sr(iter(items), continous=continous)]


def test_run_sr_does_not_depend_on_the_group_size():
    trainer = create_model(tiny_opt(), device="cpu")
    trainer.set_new_noise_schedule(SCHED, schedule_phase="val")
    rng = np.random.default_rng(8)
    items = [{"SR": rng.uniform(-1, 1, (16, 16, 3)).astype(np.float32),
              "Index": i} for i in range(3)]
    one = _run(trainer, items, 1, base_seed=11)
    three = _run(trainer, items, 3, base_seed=11)
    two = _run(trainer, items, 2, base_seed=11)  # pads the last group
    for a, b, c in zip(one, three, two):
        assert a.shape == (16, 16, 3)
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
        np.testing.assert_allclose(a, c, atol=1e-5, rtol=0)
    other = _run(trainer, items[:1], 1, base_seed=12)
    assert np.abs(other[0] - one[0]).max() > 1e-3  # the seed matters

    frames = _run(trainer, items[:2], 2, base_seed=11, continous=True)
    assert frames[0].shape == (1 + T, 16, 16, 3)
    np.testing.assert_allclose(frames[0][0], items[0]["SR"])  # frame 0: cond
    np.testing.assert_allclose(frames[0][-1], one[0], atol=1e-5, rtol=0)


@pytest.mark.parametrize("val,n,expect", [
    ({"batch_size": 4}, 50, 4), ({}, 3, 3), ({}, 50, 8),
    ({"r_resolution": 512}, 50, 1),
])
def test_group_size(val, n, expect):
    assert _group_size({"datasets": {"val": val}}, n) == expect
