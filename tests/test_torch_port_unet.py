"""The port's UNet against the JAX package's on carried-over weights.

A small sr3 UNet (inner_channel 16, mults [1, 2], 8 norm groups, image 16,
attention at 8x8 or off) is built and initialised by the JAX package, its
parameters perturbed from a numpy seed (so no bias or norm parameter sits at
its zero/one init), loaded into the port with a strict state_dict load, and
both forwards run in float32 on the CPU on the same numpy input.
Tolerance: atol 1e-4 -- float32 on both sides through ~20 layers.
"""

import copy
import functools

import jax
import numpy as np
import pytest
import torch

from sr3_tpu.models.networks import define_G as jax_define_G
from sr3_tpu.models.networks import init_params
from sr3_tpu.utils.torch_compat import flax_params_to_torch_state_dict
from sr3_tpu_torch.models.networks import count_params, define_G
from sr3_tpu_torch.training.trainer import create_model
from sr3_tpu_torch.utils.torch_compat import load_flax_params, \
    unet_key_config

ATOL = 1e-4
SCHED = {"schedule": "linear", "n_timestep": 10, "linear_start": 1e-6,
         "linear_end": 1e-2}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_opt(attn_res=(8,), resume_state=None):
    return {
        "name": "tiny", "phase": "val",
        "path": {"resume_state": resume_state},
        "model": {
            "which_model_G": "sr3", "dtype": "float32",
            "unet": {"in_channel": 6, "out_channel": 3, "inner_channel": 16,
                     "norm_groups": 8, "channel_multiplier": [1, 2],
                     "attn_res": list(attn_res), "res_blocks": 1,
                     "dropout": 0.0},
            "beta_schedule": {"val": dict(SCHED)},
            "diffusion": {"image_size": 16, "channels": 3,
                          "conditional": True},
        },
    }


@functools.lru_cache(maxsize=None)
def jax_model(attn_res):
    """JAX diffusion + perturbed parameters (numpy leaves; not mutated)."""
    diffusion = jax_define_G(tiny_opt(attn_res))
    params = jax.tree_util.tree_map(
        np.asarray, init_params(diffusion, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(100)
    params = jax.tree_util.tree_map(
        lambda p: (p + 0.1 * rng.standard_normal(p.shape)).astype(np.float32)
        if p.ndim == 1 else p, params)
    return diffusion, params


@pytest.mark.parametrize("attn_res", [(8,), ()])
def test_forward_matches_jax_unet(attn_res):
    opt = tiny_opt(attn_res)
    diffusion, params = jax_model(attn_res)
    net = define_G(opt, device="cpu").denoise_fn
    load_flax_params(net, params)
    assert count_params(net) == sum(
        p.size for p in jax.tree_util.tree_leaves(params))

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 16, 6)).astype(np.float32)
    cond = np.asarray([0.3, 0.8], np.float32)
    ref = np.asarray(diffusion.denoise_fn.apply(params, x, cond, train=False))
    with torch.inference_mode():
        out = net(torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(cond))
    assert out.dtype == torch.float32
    assert out.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref,
                               atol=ATOL, rtol=0)


def test_strict_load_rejects_a_mismatched_tree():
    _, params = jax_model(())
    other = define_G(tiny_opt(), device="cpu").denoise_fn
    with pytest.raises(KeyError):  # no attention weights in the tree
        load_flax_params(other, params)


def test_gen_pth_round_trip(tmp_path):
    """JAX params -> reference-format _gen.pth (with schedule buffers and
    the denoise_fn. prefix) -> Trainer.load_network == load_flax_params."""
    opt = tiny_opt()
    _, params = jax_model((8,))
    direct = define_G(opt, device="cpu").denoise_fn
    load_flax_params(direct, params)

    sd = flax_params_to_torch_state_dict(
        params, schedule_opt=SCHED, **unet_key_config(direct))
    prefix = tmp_path / "I10_E1"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               f"{prefix}_gen.pth")
    trainer = create_model(tiny_opt(resume_state=str(prefix)), device="cpu")
    for key, value in direct.state_dict().items():
        torch.testing.assert_close(trainer.netG.state_dict()[key], value,
                                   rtol=0, atol=0)


def test_bf16_eval_copy_casts_only_matrices():
    opt = copy.deepcopy(tiny_opt())
    opt["model"]["dtype"] = "bfloat16"
    trainer = create_model(opt, device="cpu")
    net = trainer._eval_params()
    assert net is not trainer.netG and net is trainer._eval_params()
    for (name, p), (_, master) in zip(net.named_parameters(),
                                      trainer.netG.named_parameters()):
        assert master.dtype == torch.float32
        assert p.dtype == (torch.bfloat16 if p.dim() >= 2 else torch.float32), name


def test_device_and_dtype_resolution(monkeypatch):
    from sr3_tpu_torch.utils import runtime

    monkeypatch.setenv("SR3_PLATFORM", "cpu")
    assert runtime.resolve_device() == torch.device("cpu")
    assert runtime.resolve_dtype(None, "cpu") == torch.float32
    assert runtime.resolve_dtype("bfloat16", "cpu") == torch.bfloat16
    assert runtime.resolve_dtype(None, "cuda") == torch.bfloat16
    monkeypatch.setenv("SR3_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="SR3_PLATFORM"):
        runtime.resolve_device()
    # no card and no explicit CPU: raise, never fall back silently
    monkeypatch.delenv("SR3_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="SR3_PLATFORM=cpu"):
        runtime.resolve_device()
