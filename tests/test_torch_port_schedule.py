"""The port's noise schedules against the JAX package's make_schedule and
against the reference buffers that flax_params_to_torch_state_dict emits,
for all seven beta schedules.

Both sides compute in float64 numpy and cast to float32, so the buffers are
compared at rtol 1e-7 (float32 rounding of the same float64 value)."""

import numpy as np
import pytest
import torch

from sr3_tpu.models.schedule import make_schedule as jax_make_schedule
from sr3_tpu.utils.torch_compat import build_key_map, \
    flax_params_to_torch_state_dict
from sr3_tpu_torch.models.diffusion import _snapshot_count
from sr3_tpu_torch.models.schedule import BUFFER_NAMES, make_schedule

SCHEDULES = ["quad", "linear", "warmup10", "warmup50", "const", "jsd",
             "cosine"]


def _opt(name, T=20):
    return {"schedule": name, "n_timestep": T, "linear_start": 1e-6,
            "linear_end": 1e-2}


@pytest.mark.parametrize("name", SCHEDULES)
def test_every_buffer_matches_jax_make_schedule(name):
    ours = make_schedule(_opt(name))
    ref = jax_make_schedule(_opt(name))
    assert ours.num_timesteps == ref.num_timesteps == 20
    for key in BUFFER_NAMES:
        t = getattr(ours, key)
        assert t.dtype == torch.float32
        assert t.shape[0] == (21 if key == "sqrt_alphas_cumprod_prev" else 20)
        np.testing.assert_allclose(t.numpy(), np.asarray(getattr(ref, key)),
                                   rtol=1e-7, atol=0, err_msg=key)


def _zero_params(**cfg):
    """A parameter tree with the right paths (values do not matter here)."""
    tree = {}
    for path, _, kind in build_key_map(**cfg):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.zeros(
            {"conv_w": (1, 1, 1, 1), "linear_w": (1, 1)}.get(kind, (1,)),
            np.float32)
    return {"params": tree}


@pytest.mark.parametrize("name", SCHEDULES)
def test_buffers_match_the_reference_state_dict(name):
    cfg = dict(inner_channel=8, channel_mults=(1,), attn_res=(),
               res_blocks=1, image_size=8)
    sd = flax_params_to_torch_state_dict(
        _zero_params(**cfg), schedule_opt=_opt(name), **cfg)
    sched = make_schedule(_opt(name))
    ours = {k: getattr(sched, k) for k in BUFFER_NAMES}
    assert set(ours) - set(sd) == {"sqrt_alphas_cumprod_prev"}
    for key in set(ours) & set(sd):
        np.testing.assert_allclose(ours[key].numpy(), sd[key], rtol=1e-7,
                                   atol=0, err_msg=key)


def test_posterior_log_variance_is_floored():
    s = make_schedule(_opt("linear", T=10))
    # posterior_variance[0] == 0: the log is clipped at log(1e-20)
    assert float(s.posterior_variance[0]) == 0.0
    np.testing.assert_allclose(float(s.posterior_log_variance_clipped[0]),
                               np.log(1e-20), rtol=1e-6)


@pytest.mark.parametrize("T,expect", [(10, (10, 1)), (2000, (10, 201)),
                                      (3, (3, 1)), (25, (9, 3))])
def test_snapshot_rule(T, expect):
    assert _snapshot_count(T) == expect
